"""The traced window: torch.profiler over a short run of the cell's own
calls, reduced to device intervals, kernel times by name, the kernels
issued under the benchmark's own spans, and the idle gaps by what the
host issued next.

Spans come from the benchmark's files only: `span(name)` is a
`record_function` range around a call into the program. A device
operation belongs to a span when the host operation that issued it
started inside the span's range.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

JOIN_SPAN = "perfbench.join"


@dataclasses.dataclass
class Trace:
    """One traced window: its wall seconds, the device operations (start,
    end in ns, name), the device seconds of the operations issued under
    each span, and the idle gaps labelled by the host operation that
    issued the next device operation."""
    window_s: float
    ops: List[Tuple[int, int, str]]
    span_s: Dict[str, float]
    gaps: List[Tuple[float, str]]

    @property
    def busy_s(self) -> float:
        """Seconds in which an operation ran on the device: the union of
        the operations' intervals."""
        total, end = 0, None
        for s, e, _ in sorted(self.ops):
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total / 1e9

    def kernels(self) -> List[Tuple[int, int, str]]:
        """The device operations that are kernels (not copies or sets)."""
        return [op for op in self.ops
                if not op[2].startswith(("Memcpy", "Memset"))]

    def seconds_of(self, *names: str) -> Optional[float]:
        """Device seconds of the kernels whose name holds any of `names`,
        or None where none ran."""
        hit = [e - s for s, e, n in self.ops if any(x in n for x in names)]
        return sum(hit) / 1e9 if hit else None

    def breakdown(self) -> dict:
        by_name: Dict[str, float] = collections.defaultdict(float)
        for s, e, n in self.ops:
            by_name[n] += (e - s) / 1e9
        by_gap: Dict[str, float] = collections.defaultdict(float)
        for sec, what in self.gaps:
            by_gap[what] += sec
        top = lambda d: [[k[:120], v] for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(by_name), "idle_gaps": top(by_gap)}


@contextlib.contextmanager
def span(name: str, on: bool):
    """A `record_function` range named `name` where `on`, else nothing."""
    if not on:
        yield
        return
    with torch.profiler.record_function(name):
        yield


def traced(fn: Callable[[], None], device: torch.device) -> Trace:
    """Run `fn` under torch.profiler (host and device activities), from a
    synchronized device to a synchronized device, and reduce the trace."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" \
        else (lambda: None)
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        window_s = time.perf_counter() - t0
    return reduce(prof.profiler.kineto_results.events(), window_s)


def reduce(events, window_s: float) -> Trace:
    """Device operations, span seconds and idle gaps of kineto events."""
    host: Dict[int, Tuple[int, str]] = {}
    spans: Dict[str, List[Tuple[int, int]]] = collections.defaultdict(list)
    device = []
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.is_user_annotation():
                continue
            s = e.start_ns()
            device.append((s, s + e.duration_ns(), e.name(),
                           e.linked_correlation_id()))
        else:
            host[e.correlation_id()] = (e.start_ns(), e.name())
            if e.is_user_annotation():
                s = e.start_ns()
                spans[e.name()].append((s, s + e.duration_ns()))
    span_s: Dict[str, float] = {}
    for name, ranges in spans.items():
        ranges.sort()
        starts = [a for a, _ in ranges]
        total = 0
        for s, e, _, corr in device:
            issued = host.get(corr)
            if issued is None:
                continue
            i = bisect.bisect_right(starts, issued[0]) - 1
            if i >= 0 and issued[0] <= ranges[i][1]:
                total += e - s
        span_s[name] = total / 1e9
    device.sort()
    gaps, end = [], None
    for s, e, _, corr in device:
        if end is not None and s > end:
            gaps.append(((s - end) / 1e9, "before " + host.get(
                corr, (0, "an operation issued outside any host op"))[1]))
        end = e if end is None else max(end, e)
    return Trace(window_s=window_s,
                 ops=[(s, e, n) for s, e, n, _ in device],
                 span_s=span_s, gaps=gaps)
