"""The reference against the program at a tiny size on the CPU: its
frozen draws against the program's key API and row shuffle, whole runs
of each cell (the look for a chip skipped) coming out correct, the same
runs with the timed path broken underneath coming out not correct, and
the lower-precision control failing a limit."""

import time

import numpy as np
import pytest
import torch

from perfbench import control, faults, run
from perfbench.reference import draws
from surel_plus_tpu_torch.graph.csr import csr_from_edges
from surel_plus_tpu_torch.graph.native import shuffle_rows_native
from surel_plus_tpu_torch.ops import prng

CELLS = ["citation2-mean.train", "ppa-attn.train", "citation2-mean.mrr",
         "citation2-mean.sample"]
SEED = 2**31 + 12345


def tiny(cell: str) -> dict:
    """The cell's spec cut to a size a test run holds."""
    spec = run.load_cell(cell)
    spec["config"] = dict(spec["config"], num_nodes=2000, num_edges=12000,
                          num_walks=10 if "citation2" in cell else 20)
    spec["traffic"] = dict(spec["traffic"], batch_size=256, set_block=512,
                           piece_steps=2, traced_steps=2, sources=24,
                           candidates=40, chunk_batches=2, traced_batches=2,
                           checked_sets=24,
                           traced_passes=1)
    return spec


def measure(cell: str, seed: int = SEED, trace: bool = False) -> dict:
    return run.measure(tiny(cell), seed, 0.5, trace, "cpu",
                       time.perf_counter())


def test_threefry_key_api_matches_the_program():
    key = draws.key_of(2**33 + 5)
    assert key == prng.prng_key(2**33 + 5)
    assert draws.fold_in(key, 7) == prng.fold_in(key, 7)
    assert draws.split(key, 3) == prng.split(key, 3)
    path = ("affinity_score", "Dropout_0", 1)
    assert draws.fold_names(key, path) == prng.fold_in_static(key, path)
    assert torch.equal(draws.bits(key, (5, 7), "cpu", offset=3),
                       prng.bits(key, (5, 7), "cpu", offset=3))
    assert torch.equal(draws.bernoulli(key, 0.9, (64, 96), "cpu"),
                       prng.bernoulli(key, 0.9, (64, 96), "cpu"))


def test_row_shuffle_matches_the_native_ingest():
    rng = np.random.default_rng(3)
    edges = rng.integers(0, 300, size=(5000, 2))
    edges = np.concatenate([edges, np.stack([np.zeros(400, int),
                                             np.arange(1, 401)], 1)])
    g = csr_from_edges(edges, num_nodes=401)
    seed = 2**32 + 99
    native = shuffle_rows_native(g, seed)
    for node in range(0, 401, 7):
        lo, hi = g.indptr[node], g.indptr[node + 1]
        assert draws.shuffled_row(g.indices[lo:hi].tolist(), seed, node) \
            == native[lo:hi].tolist()


@pytest.mark.parametrize("cell", CELLS)
def test_run_correct(cell):
    res = measure(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0
    assert list(res)[-1] == "checks"


def test_traced_run_correct():
    res = measure("citation2-mean.train", seed=5, trace=True)
    assert res["correct"], res["checks"]
    assert "train_mfu" in res["metrics"] and "breakdown" in res


@pytest.mark.parametrize("cell,what", [
    ("citation2-mean.train", "state unchanged"),
    ("citation2-mean.train", "half the batch"),
    ("ppa-attn.train", "state unchanged"),
    ("ppa-attn.train", "half the batch"),
    ("citation2-mean.train", "answer altered"),
    ("citation2-mean.mrr", "answer altered"),
    ("citation2-mean.mrr", "set altered"),
    ("citation2-mean.sample", "set altered"),
])
def test_fault_not_correct(cell, what):
    with faults.planted(what):
        res = measure(cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(cell):
    spec = tiny(cell)
    failed = []
    for _, values in control.readings(cell, [SEED], True, "cpu", spec):
        failed += [k for k, v in values.items()
                   if not v <= spec["limits"].get(k, 0.0)]
    assert failed


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(card, cell):
    """At the cell's own size on the card: the control fails a limit and
    the program as configured keeps every one."""
    spec = run.load_cell(cell)
    for control_on in (True, False):
        for _, values in control.readings(cell, [SEED], control_on,
                                          str(card), spec):
            bad = [k for k, v in values.items()
                   if not v <= spec["limits"].get(k, 0.0)]
            assert bool(bad) == control_on, values
