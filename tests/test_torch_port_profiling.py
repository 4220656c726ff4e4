"""PyTorch port, the phase timer and the profiler trace
(`utils/profiling.py`) against the JAX package's utils/profiling.py:
`PhaseStat.mean_s` and `Metrics.log_report` give the same values and
lines, `torch_trace(None)` does nothing, and `torch_trace(dir)` on the
CPU writes a trace file there."""

import glob
import json
import logging

import pytest
import torch

from surel_plus_tpu.utils import profiling as jprof
from surel_plus_tpu_torch.utils import profiling as tprof
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _filled(pkg):
    m = pkg.Metrics()
    m.add("sample", 0.25, items=1000)
    m.add("sample", 0.5, items=500)
    m.add("join", 0.125)
    m.add("eval", 0.0, items=3)
    return m


def test_mean_s_and_log_report_match_jax():
    got, want = _filled(tprof), _filled(jprof)
    for name, st in want.report().items():
        g = got.report()[name]
        assert (g.total_s, g.count, g.items) == (st.total_s, st.count,
                                                 st.items)
        assert g.mean_s == st.mean_s and g.items_per_s == st.items_per_s
    assert got.report()["sample"].mean_s == 0.375
    assert tprof.PhaseStat().mean_s == 0.0
    lines = []
    for m in (got, want):
        h = _Lines()
        lg = logging.getLogger(f"test_torch_port_profiling.{id(m)}")
        lg.setLevel(logging.INFO)
        lg.addHandler(h)
        m.log_report(lg)
        lines.append(h.lines)
    assert lines[0] == lines[1]
    assert lines[0][0] == "phase eval: 0.000s over 1 calls, 0 items/s"
    assert lines[0][-1] == "phase sample: 0.750s over 2 calls, 2,000 items/s"


def test_log_report_defaults_to_the_module_logger(caplog):
    with caplog.at_level(logging.INFO, logger=tprof.log.name):
        _filled(tprof).log_report()
    assert len(caplog.records) == 3


@pytest.mark.parametrize("log_dir", [None, ""])
def test_torch_trace_off_does_nothing(tmp_path, monkeypatch, log_dir):
    def refuse(*a, **kw):
        raise AssertionError("the profiler was started")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    monkeypatch.chdir(tmp_path)
    with tprof.torch_trace(log_dir):
        torch.ones(3).sum()
    assert list(tmp_path.iterdir()) == []


def test_torch_trace_writes_a_trace(tmp_path):
    with tprof.torch_trace(str(tmp_path / "trace")):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    (path,) = glob.glob(str(tmp_path / "trace" / "*.json"))
    with open(path) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("mm" in n for n in names)
