"""PyTorch port, the program's profiler spans and host phases
(`utils/profiling.py`: `span`, `Metrics.phase`, `NAMES`).

Without a profiler no `record_function` is entered on the training,
scoring or sampling path. Under `torch.profiler.profile` every training
step opens join, forward, backward, optimizer and accumulate in that
order, every scoring batch join and forward, every sampler block walk and
sets and every sampler call one store; the results are bitwise those of
the run without spans. The ingest phases record once on a cache miss and
never on a hit, a phase waits for an initialised CUDA device at its end,
and every span and phase the package opens is in `NAMES`."""

import contextlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import surel_plus_tpu_torch
from surel_plus_tpu_torch.graph.csr import csr_from_edges
from surel_plus_tpu_torch.graph.synthetic import rmat_graph
from surel_plus_tpu_torch.models import Net
from surel_plus_tpu_torch.ops import prng
from surel_plus_tpu_torch.ops.sampler import sample_gsets_device_keys
from surel_plus_tpu_torch.train import TrainConfig
from surel_plus_tpu_torch.train.device import trainer_from_keys
from surel_plus_tpu_torch.utils import profiling
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

N, M, S, BS, BLOCK = 90, 20, 3, 8, 32
TRAIN_STEPS = 3
TRAINING = ["surel.join", "surel.forward", "surel.backward",
            "surel.optimizer", "surel.accumulate"]
INGEST = ("ingest.csr", "ingest.shuffle", "ingest.upload", "ingest.tables")


@pytest.fixture(scope="module")
def graph():
    return rmat_graph(N, 400, seed=27)


def _sample(graph, seed=5):
    """The sets of walk key `seed` over one row shuffle (seed 5), as the
    sampling cell's passes draw them."""
    return sample_gsets_device_keys(graph, np.arange(N), M, S, seed=seed,
                                    block_size=BLOCK, shuffle_seed=5,
                                    device="cpu")


def _trainer(graph):
    net = Net(S + 1, 16, dropout=0.1, key=prng.prng_key(0), device="cpu")
    return trainer_from_keys(net, _sample(graph), TrainConfig(batch_size=BS))


def _queries():
    rng = np.random.default_rng(3)
    edges = torch.as_tensor(rng.integers(0, N, size=(2, TRAIN_STEPS * BS)))
    labels = torch.as_tensor((rng.random(TRAIN_STEPS * BS) < 0.5).astype(
        np.float32))
    return edges, labels


def _train_and_score(graph):
    """One epoch of TRAIN_STEPS steps, then a scoring of 2.5 batches:
    (loss, auc, parameters, scores)."""
    tr = _trainer(graph)
    edges, labels = _queries()
    loss, auc = tr.train_epoch(edges, labels, prng.prng_key(9))
    params = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
    scores = tr.predict(edges[:, :BS * 5 // 2])
    return loss, auc, params, scores


def _spans(prof, prefix="surel."):
    """The names of the profiled ranges that start with `prefix`, in the
    order they were opened."""
    evs = [e for e in prof.events() if e.name.startswith(prefix)]
    return [e.name for e in sorted(evs, key=lambda e: e.time_range.start)]


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def test_span_is_a_shared_null_without_a_profiler():
    a, b = profiling.span("surel.join"), profiling.span("surel.forward")
    assert a is b and isinstance(a, contextlib.nullcontext)


def test_gate_flips_under_the_profiler():
    """Guards a torch upgrade that would leave the spans off silently."""
    assert not torch.autograd.profiler._is_profiler_enabled
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled
        assert isinstance(profiling.span("surel.join"),
                          torch.profiler.record_function)
    assert not torch.autograd.profiler._is_profiler_enabled
    assert isinstance(profiling.span("surel.join"), contextlib.nullcontext)


@pytest.mark.parametrize("path", ["train_epoch", "predict", "sample"])
def test_no_record_function_without_a_profiler(graph, monkeypatch, path):
    tr = _trainer(graph)
    edges, labels = _queries()

    def refuse(*a, **k):
        raise AssertionError("a record_function was entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    if path == "train_epoch":
        tr.train_epoch(edges, labels, prng.prng_key(9))
    elif path == "predict":
        tr.predict(edges)
    else:
        _sample(csr_from_edges(np.stack([np.arange(N - 1),
                                         np.arange(1, N)], 1)))


def test_training_spans_once_a_step_in_order(graph):
    tr = _trainer(graph)
    edges, labels = _queries()
    _, prof = _traced(lambda: tr.train_epoch(edges, labels,
                                             prng.prng_key(9)))
    assert _spans(prof) == TRAINING * TRAIN_STEPS


def test_scoring_spans_join_and_forward_a_batch(graph):
    tr = _trainer(graph)
    edges, _ = _queries()
    _, prof = _traced(lambda: tr.predict(edges[:, :BS * 5 // 2]))
    assert _spans(prof) == ["surel.join", "surel.forward"] * 3


@pytest.mark.parametrize("cached", [True, False], ids=["warm", "cold"])
def test_sampler_spans_a_block_and_a_store_a_call(graph, cached):
    g = graph if cached else rmat_graph(N, 400, seed=27)
    if cached:
        _sample(g)
    _, prof = _traced(lambda: _sample(g, seed=6))
    blocks = -(-N // BLOCK)
    assert _spans(prof, "surel.sample.") == (
        ["surel.sample.walk", "surel.sample.sets"] * blocks
        + ["surel.sample.store"])
    ingest = _spans(prof, "ingest.")
    assert ingest == ([] if cached else
                      ["ingest.upload", "ingest.shuffle", "ingest.upload",
                       "ingest.tables"])


def test_spans_leave_training_and_scoring_bitwise_alike(graph):
    off = _train_and_score(graph)
    on, prof = _traced(lambda: _train_and_score(graph))
    assert _spans(prof)      # the spans were on
    assert torch.equal(on[0], off[0]) and torch.equal(on[1], off[1])
    assert on[2].keys() == off[2].keys()
    assert all(torch.equal(on[2][k], off[2][k]) for k in off[2])
    assert torch.equal(on[3], off[3])


def test_spans_leave_the_sets_bitwise_alike(graph):
    off = _sample(graph, seed=8)
    on, _ = _traced(lambda: _sample(graph, seed=8))
    for name in ("nodes", "sizes", "khi", "klo"):
        assert torch.equal(getattr(on, name), getattr(off, name)), name


def _counts():
    got = profiling.metrics.report()
    return {p: got[p].count if p in got else 0 for p in INGEST}


def test_ingest_phases_once_on_a_miss_never_on_a_hit():
    edges = np.random.default_rng(4).integers(0, N, size=(300, 2))
    before = _counts()
    g = csr_from_edges(edges, num_nodes=N)
    after_csr = _counts()
    assert after_csr == dict(before, **{"ingest.csr":
                                        before["ingest.csr"] + 1})
    _sample(g)
    miss = _counts()
    assert {p: miss[p] - after_csr[p] for p in INGEST} == {
        "ingest.csr": 0, "ingest.shuffle": 1, "ingest.upload": 2,
        "ingest.tables": 1}
    _sample(g, seed=7)          # another walk key, the same row shuffle
    assert _counts() == miss
    stats = profiling.metrics.report()
    assert stats["ingest.tables"].items >= g.num_edges


@pytest.mark.parametrize("cuda", [True, False], ids=["cuda", "no_cuda"])
def test_phase_waits_for_the_device_at_its_end(monkeypatch, cuda):
    calls = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: cuda)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append("sync"))
    m = profiling.Metrics()
    with m.phase("ingest.csr", items=5):
        calls.append("body")
    assert calls == (["sync", "body", "sync"] if cuda else ["body"])
    st = m.report()["ingest.csr"]
    assert (st.count, st.items) == (1, 5) and st.total_s >= 0


def test_phase_opens_its_span_under_the_profiler():
    m = profiling.Metrics()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with m.phase("load"):
            torch.ones(4).sum()
    assert _spans(prof, "load") == ["load"]
    assert m.report()["load"].count == 1


def test_every_span_and_phase_the_package_opens_is_named():
    root = Path(surel_plus_tpu_torch.__file__).parent
    opened = set()
    for path in root.rglob("*.py"):
        text = path.read_text()
        opened |= set(re.findall(r'\bspan\(\s*"([^"]+)"', text))
        opened |= set(re.findall(r'\b(?:phase|add)\(\s*"([^"]+)"', text))
    assert set(TRAINING) | set(INGEST) <= opened
    assert opened <= set(profiling.NAMES), opened - set(profiling.NAMES)
    assert all(profiling.NAMES[n] for n in profiling.NAMES)
