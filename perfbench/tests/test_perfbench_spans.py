"""The readers of the program's own spans and ingest phases: each reads
its span's device milliseconds a unit for its kind of traffic and nothing
for the others or where the program opened no such span; `ingest_s`
sums the four ingest phases of a filled registry; every name a reader
holds is one the program lists in `utils/profiling.py:NAMES`."""

import pytest

from perfbench import run
from perfbench.drive import Readings
from perfbench.trace import Trace
from surel_plus_tpu_torch.utils import profiling

SPAN_READERS = {
    "forward_ms_per_step.train": ("train", "surel.forward"),
    "backward_ms_per_step.train": ("train", "surel.backward"),
    "optimizer_ms_per_step.train": ("train", "surel.optimizer"),
    "accumulate_ms_per_step.train": ("train", "surel.accumulate"),
    "forward_ms_per_batch.eval": ("rank", "surel.forward"),
    "walk_ms_per_pass.sample": ("sample", "surel.sample.walk"),
    "sets_ms_per_pass.sample": ("sample", "surel.sample.sets"),
    "store_ms_per_pass.sample": ("sample", "surel.sample.store"),
}
KINDS = ("train", "rank", "sample")


def readings(kind: str, span_s: dict, units: int = 24) -> Readings:
    trace = Trace(window_s=1.0, ops=[(0, 10, "k")], span_s=span_s, gaps=[])
    return Readings(kind, {}, 10.0, None, trace, units, [])


def reader_module(name: str):
    return run.reader(name).__globals__


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_span_reader_reads_its_kind_only(name):
    kind, span = SPAN_READERS[name]
    assert reader_module(name)["SPAN"] == span
    read = run.reader(name)
    spans = {span: 0.048, "perfbench.join": 1.0, "surel.other": 2.0}
    assert read(readings(kind, spans)) == pytest.approx(2.0)
    for other in KINDS:
        if other != kind:
            assert read(readings(other, spans)) is None
    # a program that opens no such span, or a window of no units
    assert read(readings(kind, {"perfbench.join": 1.0})) is None
    assert read(readings(kind, spans, units=0)) is None


def test_ingest_reads_a_filled_registry(monkeypatch):
    read = run.reader("ingest_s")
    m = profiling.Metrics()
    monkeypatch.setitem(read.__globals__, "metrics", m)
    assert read(readings("train", {})) is None
    m.add("ingest.csr", 1.5, items=10)
    m.add("ingest.shuffle", 0.25)
    m.add("ingest.upload", 0.125)
    assert read(readings("train", {})) is None      # not every phase yet
    m.add("ingest.upload", 0.125)
    m.add("ingest.tables", 0.5)
    m.add("load", 7.0)
    for kind in KINDS:
        assert read(readings(kind, {})) == pytest.approx(2.5)


def test_reader_names_are_the_programs():
    names = [reader_module(n)["SPAN"] for n in SPAN_READERS]
    names += list(reader_module("ingest_s")["PHASES"])
    assert set(names) <= set(profiling.NAMES)
