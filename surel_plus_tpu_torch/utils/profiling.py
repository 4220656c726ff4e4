"""Per-phase wall-clock timing and the profiler trace (port of
surel_plus_tpu/utils/profiling.py: the `Metrics` registry, and
`torch_trace` in place of `jax_trace`). A phase that ends on the host's
clock must wait for the device inside it to count the device's work."""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

log = logging.getLogger(__name__)


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

    with metrics.phase("sampling", items=num_seeds):
        ...
    metrics.report()  # -> {"sampling": PhaseStat(...), ...}
    """

    def __init__(self):
        self._stats: Dict[str, PhaseStat] = defaultdict(PhaseStat)

    @contextlib.contextmanager
    def phase(self, name: str, items: int = 0) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0, items)

    def add(self, name: str, seconds: float, items: int = 0) -> None:
        """Record an externally-timed span under `name`."""
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
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)):
        yield
