"""Per-phase wall-clock timing (port of the `Metrics` registry of
surel_plus_tpu/utils/profiling.py). A phase that ends on the host's
clock must wait for the device inside it to count the device's work."""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict
from typing import Dict, Iterator


@dataclasses.dataclass
class PhaseStat:
    total_s: float = 0.0
    count: int = 0
    items: int = 0

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

    def reset(self):
        self._stats.clear()


metrics = Metrics()
