"""Per-phase wall-clock timing, the program's profiler spans and the
profiler trace (port of surel_plus_tpu/utils/profiling.py: the `Metrics`
registry, and `torch_trace` in place of `jax_trace`).

A span (`span`) is a `torch.profiler.record_function` range while the
profiler records, and a shared null context otherwise, so a run that is
not traced pays one branch a span. A phase (`Metrics.phase`) is timed on
the host's clock, waiting for the device at its start and end, and opens
its span while the profiler records. `NAMES` lists every span and phase
the program opens."""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from collections import defaultdict
from typing import ContextManager, Dict, Iterator, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

log = logging.getLogger(__name__)

# every span and phase the program opens, with what it covers
NAMES: Dict[str, str] = {
    # spans of a training step and a scoring batch (train/device.py)
    "surel.join": "the join of a batch's query edges over the stored sets "
                  "(`DeviceTrainer._batch`)",
    "surel.forward": "the model and `batch_loss` in a training step; the "
                     "model and its sigmoid in a scoring batch",
    "surel.backward": "`zero_grad` and `loss.backward()` (`adam_step`)",
    "surel.optimizer": "the global-norm clip and the optimizer's step "
                       "(`adam_step`)",
    "surel.accumulate": "a step's score histograms, weighted loss and "
                        "weight added to the epoch's accumulators",
    # spans of a sampling pass (ops/walk.py, ops/sampler.py)
    "surel.sample.walk": "a block's walk draws and walks "
                         "(`walk_bits`, `walk_block_tables`)",
    "surel.sample.sets": "a block's dedup sort, prefix sums, compaction and "
                         "key packing (`build_sets_packed_block`)",
    "surel.sample.store": "the concatenation of the blocks' sets "
                          "(`sample_gsets_device_keys`)",
    # phases of the host ingest, on a cache miss only (items: edges)
    "ingest.csr": "the CSR build from an edge list (`csr_from_edges`)",
    "ingest.shuffle": "the native per-row shuffle of the CSR indices "
                      "(`shuffled_indices_for`)",
    "ingest.upload": "a graph's CSR or its shuffled indices copied to the "
                     "device (`device_graph`, `shuffled_indices_for`)",
    "ingest.tables": "the walk's edge tables built on the device "
                     "(`walk_tables_for`)",
    # phases of the CLIs (cli/main.py, cli/main_horder.py)
    "load": "the dataset loaded, split and made into graphs",
    "prep": "node features, model and both stores of sets built",
    "train_epoch": "a block of training epochs up to the next evaluation "
                   "(items: query edges)",
    "eval": "an evaluation of the valid and test splits",
}

_NULL = contextlib.nullcontext()


def span(name: str) -> ContextManager:
    """A `record_function` range named `name` while torch.profiler
    records (so the device work issued inside it is attributed to it),
    else a shared null context."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NULL


def _sync() -> None:
    """Wait for the current CUDA device, where CUDA is initialised."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@dataclasses.dataclass
class PhaseStat:
    total_s: float = 0.0
    count: int = 0
    items: int = 0

    @property
    def mean_s(self) -> float:
        return self.total_s / max(self.count, 1)

    @property
    def items_per_s(self) -> float:
        return self.items / self.total_s if self.total_s > 0 else 0.0


class Metrics:
    """Process-wide phase timing registry.

    with metrics.phase("ingest.csr", items=len(edges)):
        ...
    metrics.report()  # -> {"ingest.csr": PhaseStat(...), ...}
    """

    def __init__(self):
        self._stats: Dict[str, PhaseStat] = defaultdict(PhaseStat)

    @contextlib.contextmanager
    def phase(self, name: str, items: int = 0) -> Iterator[None]:
        """Time the body on the host's clock from a drained device to a
        drained device, so the phase counts its own device work and none
        queued before it; inside `span(name)`."""
        with span(name):
            _sync()
            t0 = time.perf_counter()
            try:
                yield
            finally:
                _sync()
                self.add(name, time.perf_counter() - t0, items)

    def add(self, name: str, seconds: float, items: int = 0) -> None:
        """Record an externally-timed phase under `name`."""
        s = self._stats[name]
        s.total_s += seconds
        s.count += 1
        s.items += items

    def report(self) -> Dict[str, PhaseStat]:
        return dict(self._stats)

    def log_report(self, logger=None) -> None:
        """One line a phase, by name: its total, its count and, where it
        counted items, its rate."""
        lg = logger or log
        for name, s in sorted(self._stats.items()):
            msg = (f"phase {name}: {s.total_s:.3f}s over {s.count} calls"
                   + (f", {s.items_per_s:,.0f} items/s" if s.items else ""))
            lg.info(msg)

    def reset(self):
        self._stats.clear()


metrics = Metrics()


@contextlib.contextmanager
def torch_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Capture a `torch.profiler` trace of the host and, where there is
    one, the CUDA device into `log_dir` (a Chrome trace, for Perfetto or
    TensorBoard). Does nothing when log_dir is None or empty."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)):
        yield
