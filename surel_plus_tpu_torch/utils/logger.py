"""Run logging, result tracking, early stopping (port of
surel_plus_tpu/utils/logger.py; the same line formats, so that
scripts/summarize_fixture_results.py reads either package's logs).

Timestamped per-dataset log files (DEBUG to file, WARN to console),
per-run result lists keyed by metric, early stop when the validation
metric has not improved for `early_stop` evaluations or has saturated
> 0.9999, and mean±std aggregation across runs.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from typing import Dict, Optional, Union

import numpy as np


class _StreamToLogger:
    """Redirects a text stream into a logger (the `--debug` capture)."""

    def __init__(self, logger: logging.Logger, level: int = logging.DEBUG):
        self._logger = logger
        self._level = level
        self._buf = ""

    def write(self, msg: str):
        self._buf += msg
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            if line.strip():
                self._logger.log(self._level, line)

    def flush(self):
        if self._buf.strip():
            self._logger.log(self._level, self._buf)
        self._buf = ""


def capture_stdout(logger: logging.Logger) -> None:
    """Route print()s into the log file (`--debug` mode)."""
    sys.stdout = _StreamToLogger(logger)


def set_up_log(log_dir: str, dataset: str, args_repr: str = "",
               stamp: Optional[str] = None) -> logging.Logger:
    """File (DEBUG) + console (WARN) handlers."""
    path = os.path.join(log_dir, dataset)
    os.makedirs(path, exist_ok=True)
    stamp = stamp or time.strftime("%m%d%y_%H%M%S")
    file_path = os.path.join(path, f"{stamp}.log")
    logger = logging.getLogger(f"surel_plus_tpu_torch.{dataset}.{stamp}")
    logger.setLevel(logging.DEBUG)
    for h in logger.handlers:
        h.close()
    logger.handlers.clear()
    fh = logging.FileHandler(file_path)
    fh.setLevel(logging.DEBUG)
    ch = logging.StreamHandler()
    ch.setLevel(logging.WARN)
    fmt = logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    fh.setFormatter(fmt)
    ch.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(ch)
    logger.info("Create log file at %s", file_path)
    if args_repr:
        logger.info("Full args parsed: %s", args_repr)
    return logger


class ResultLogger:
    """Tracks (train, valid, test) tuples per run; early-stops on validation
    plateau. `add_result` returns True when training should stop."""

    def __init__(self, runs: int = 1, metric: str = "MRR",
                 early_stop: int = -1):
        self.metric = metric
        self.early_stop = early_stop
        if "Hits" in metric:
            self.results: Union[Dict, list] = {
                f"Hits@{k}": [[] for _ in range(runs)]
                for k in (10, 20, 50, 100)}
            if metric not in self.results:
                # the eval computes K in {10,20,50,100} only
                # (train/device.py:evaluate_device); fail loudly instead
                # of KeyError-ing mid-run on e.g. Hits@30
                raise ValueError(
                    f"unsupported metric {metric!r}: Hits@K is computed "
                    f"for K in (10, 20, 50, 100)")
        else:
            self.results = [[] for _ in range(runs)]

    def _run_results(self, run: int):
        if isinstance(self.results, dict):
            return self.results[self.metric][run]
        return self.results[run]

    def evaluated(self, run: int) -> bool:
        """Whether the run has a result (a resumed run may end before its
        next evaluation)."""
        return len(self._run_results(run)) > 0

    def add_result(self, run: int, result) -> bool:
        if isinstance(result, dict):
            for key, val in result.items():
                self.results[key][run].append(tuple(val))
            r = self.results[self.metric][run]
        elif isinstance(result, tuple):
            self.results[run].append(tuple(result))
            r = self.results[run]
        else:
            raise NotImplementedError(type(result))
        assert len(r[-1]) == 3
        valid = np.array(r)[:, 1]
        if len(valid) > self.early_stop > 0:
            if len(valid) - valid.argmax() > self.early_stop:
                return True
            if np.sort(valid)[-self.early_stop] > 0.9999:
                return True
        return False

    def best(self, run: int):
        """(best_valid, test_at_best_valid) for one run."""
        r = np.array(self._run_results(run))
        i = int(r[:, 1].argmax())
        return float(r[:, 1].max()), float(r[i, 2])

    def print_statistics(self, run: Optional[int] = None,
                         logger: Optional[logging.Logger] = None,
                         key: Optional[str] = None):
        lg = logger or logging.getLogger(__name__)
        if isinstance(self.results, dict) and key is None:
            for k in self.results:
                self.print_statistics(run, logger, k)
            return
        results = (self.results[key] if key is not None else self.results)
        label = key or self.metric
        if run is not None:
            r = 100 * np.array(results[run])
            argmax = int(r[:, 1].argmax())
            lg.info("Run %02d %s:\nHighest Valid: %.2f\n   Final Test: %.2f",
                    run + 1, label, r[:, 1].max(), r[argmax, 2])
        else:
            best = []
            for rr in results:
                r = 100 * np.array(rr)
                argmax = int(r[:, 1].argmax())
                best.append((r[:, 1].max(), r[argmax, 2]))
            best = np.array(best)
            vstd = best[:, 0].std() if len(best) > 1 else 0.0
            tstd = best[:, 1].std() if len(best) > 1 else 0.0
            lg.info("All runs %s:\nHighest Valid: %.2f±%.2f\n"
                    "   Final Test: %.2f±%.2f", label,
                    best[:, 0].mean(), vstd, best[:, 1].mean(), tstd)
