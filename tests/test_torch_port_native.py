"""PyTorch port, the native graph ingest and the first-hop shuffle
(`surel_plus_tpu_torch/graph/native.py` over `csrc/graphkit.cpp`) and the
small graph functions, held to the JAX package exactly.

The JAX sampler's first hop reads the native per-row Fisher-Yates shuffle
(its `shuffled_indices_for`); the port's does too, so a walk of one step,
which draws no bits, gives the same sets in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surel_plus_tpu.graph import native as jnative
from surel_plus_tpu.graph.csr import csr_from_edges as jax_csr_from_edges
from surel_plus_tpu.graph.negative import random_targets as jax_targets
from surel_plus_tpu.graph.synthetic import erdos_renyi as jax_erdos_renyi
from surel_plus_tpu.graph.synthetic import rmat_graph as jax_rmat
from surel_plus_tpu.ops import walk as jwalk
from surel_plus_tpu.ops.sampler import (
    sample_gsets_device_keys as jax_sample_keys,
)
from surel_plus_tpu.ops.sampler import shuffled_indices_for as jax_shuffled
from surel_plus_tpu_torch.graph import csr as tcsr
from surel_plus_tpu_torch.graph import erdos_renyi, native, rmat_graph
from surel_plus_tpu_torch.graph.negative import random_targets
from surel_plus_tpu_torch.ops import walk as twalk
from surel_plus_tpu_torch.ops.sampler import (
    sample_gsets_device_keys,
    shuffled_indices_for,
)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

GRAPHS = {"rmat": (200, 1000, 0), "rmat_skewed": (1000, 9000, 3)}
SEEDS = (5, 111413)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_shuffles_match_jax(graph, seed):
    """shuffle_rows_native and shuffled_indices_for equal JAX's, row for
    row, and each row is a permutation of the graph's."""
    g, jg = rmat_graph(*GRAPHS[graph]), jax_rmat(*GRAPHS[graph])
    want = np.asarray(jax_shuffled(jg, seed))
    np.testing.assert_array_equal(native.shuffle_rows_native(g, seed),
                                  jnative.shuffle_rows_native(jg, seed))
    got = shuffled_indices_for(g, seed, "cpu")
    assert got.dtype == torch.int32 and want.dtype == np.int32  # JAX's word
    np.testing.assert_array_equal(got.numpy(), want)
    for u in (0, 7, g.num_nodes - 1):
        lo, hi = g.indptr[u], g.indptr[u + 1]
        np.testing.assert_array_equal(np.sort(want[lo:hi]), g.indices[lo:hi])


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_one_step_walks_match_jax(graph):
    """The repair's proof: sample_gsets_device_keys with num_steps=1 draws
    no bits, so its sets are the first hop's alone, and equal JAX's."""
    g, jg = rmat_graph(*GRAPHS[graph]), jax_rmat(*GRAPHS[graph])
    seeds = np.arange(g.num_nodes, dtype=np.int32)
    got = sample_gsets_device_keys(g, seeds, num_walks=20, num_steps=1,
                                   seed=9, block_size=256, device="cpu")
    want = jax_sample_keys(jg, seeds, num_walks=20, num_steps=1, seed=9,
                           block_size=256)
    for k in ("nodes", "sizes", "khi", "klo"):
        np.testing.assert_array_equal(
            getattr(got, k).numpy(),
            np.asarray(getattr(want, k)).view(np.int32), err_msg=k)


def _edges(seed, n=500, e=5000):
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, n, size=(e, 2)).astype(np.int32)
    edges[100:200] = edges[:100]                  # duplicates
    edges[300:310, 1] = edges[300:310, 0]         # self loops
    return edges, rng.uniform(0.5, 2.0, size=e).astype(np.float32)


@pytest.mark.parametrize("symmetrize", [True, False])
def test_build_csr_native_matches_jax_and_numpy(symmetrize):
    edges, _ = _edges(0)
    got = native.build_csr_native(edges, num_nodes=500,
                                  symmetrize=symmetrize)
    want = jnative.build_csr_native(edges, num_nodes=500,
                                    symmetrize=symmetrize)
    ref = tcsr.csr_from_edges(edges, num_nodes=500, symmetrize=symmetrize,
                              coalesce=False, prefer_native=False)
    for other in (want, ref):
        np.testing.assert_array_equal(got.indptr, other.indptr)
        np.testing.assert_array_equal(got.indices, other.indices)
    assert got.data is None


@pytest.mark.parametrize("coalesce", [True, False])
@pytest.mark.parametrize("weighted", [True, False])
def test_build_csr_weighted_native_matches_jax_and_numpy(coalesce,
                                                         weighted):
    """Weights of duplicate entries summed in another order than numpy's:
    exact for unit weights, within float32 rounding otherwise."""
    edges, w = _edges(7)
    w = w if weighted else None
    got = native.build_csr_weighted_native(edges, w, num_nodes=500,
                                           coalesce=coalesce)
    want = jnative.build_csr_weighted_native(edges, w, num_nodes=500,
                                             coalesce=coalesce)
    ref = tcsr.csr_from_edges(edges, num_nodes=500, weights=w,
                              coalesce=coalesce, prefer_native=False)
    for other in (want, ref):
        np.testing.assert_array_equal(got.indptr, other.indptr)
        np.testing.assert_array_equal(got.indices, other.indices)
        if weighted and coalesce:
            np.testing.assert_allclose(got.data, other.data, rtol=1e-6)
        elif not weighted:
            np.testing.assert_array_equal(got.data, other.data)
        else:
            # uncoalesced duplicates keep their own weights, in an order
            # that follows the threads: compare each row's multiset
            for u in range(0, 500, 7):
                lo, hi = got.indptr[u], got.indptr[u + 1]
                np.testing.assert_array_equal(np.sort(got.data[lo:hi]),
                                              np.sort(other.data[lo:hi]))


def test_csr_from_edges_takes_the_native_build_at_the_threshold(
        monkeypatch):
    """prefer_native=None follows JAX's rule: the native build from
    NATIVE_BUILD_THRESHOLD edges on; both give JAX's graph."""
    edges, _ = _edges(3)
    calls = []
    real = native.build_csr_weighted_native

    def spy(*a, **kw):
        calls.append(len(a[0]))
        return real(*a, **kw)

    monkeypatch.setattr(native, "build_csr_weighted_native", spy)
    monkeypatch.setattr(tcsr, "NATIVE_BUILD_THRESHOLD", len(edges))
    big = tcsr.csr_from_edges(edges, num_nodes=500)
    monkeypatch.setattr(tcsr, "NATIVE_BUILD_THRESHOLD", len(edges) + 1)
    small = tcsr.csr_from_edges(edges, num_nodes=500)
    assert calls == [len(edges)]
    want = jax_csr_from_edges(edges, num_nodes=500, prefer_native=True)
    for got in (big, small):
        np.testing.assert_array_equal(got.indptr, want.indptr)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_array_equal(got.data, want.data)


def test_a_failed_graphkit_build_raises(monkeypatch, tmp_path):
    """A source that does not compile raises with the compiler's message;
    nothing falls back to numpy."""
    bad = tmp_path / "graphkit.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_LIB", None)
    g = rmat_graph(*GRAPHS["rmat"])
    with pytest.raises(RuntimeError, match="failed") as err:
        native.shuffle_rows_native(g, 5)
    assert "error" in str(err.value)
    assert not list((tmp_path / "_build").glob("*.so"))


@pytest.mark.parametrize("seed", [0, 4])
def test_erdos_renyi_matches_jax(seed):
    got, want = erdos_renyi(300, 2000, seed=seed), jax_erdos_renyi(
        300, 2000, seed=seed)
    for k in ("indptr", "indices", "data"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", [(7,), (3, 50)])
def test_random_targets_match_jax(shape):
    """The same draws from the same numpy stream, and the stream left in
    the same state."""
    a, b = np.random.default_rng(2), np.random.default_rng(2)
    got, want = random_targets(100, shape, a), jax_targets(100, shape, b)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert a.integers(1 << 30) == b.integers(1 << 30)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_shuffle_csr_rows_with_jax_keys_matches_jax(graph):
    """Fed JAX's random keys (jax.random.bits of the key), the port's
    row shuffle equals JAX's sort, ties included (keys of 8 bits)."""
    jg = jax_rmat(*GRAPHS[graph])
    row_ids = np.repeat(np.arange(jg.num_nodes, dtype=np.int32),
                        np.diff(jg.indptr))
    key = jax.random.PRNGKey(3)
    want = np.asarray(jwalk.shuffle_csr_rows(
        jnp.asarray(row_ids), jnp.asarray(jg.indices), key))
    rand = np.asarray(jax.random.bits(key, jg.indices.shape,
                                      dtype=jnp.uint32)).astype(np.int64)
    got = twalk.shuffle_csr_rows(torch.as_tensor(row_ids),
                                 torch.as_tensor(jg.indices),
                                 torch.as_tensor(rand))
    np.testing.assert_array_equal(got.numpy(), want)
    # ties: equal keys keep the entries' order, as JAX's stable sort does
    small = rand & 0xFF
    tied = np.lexsort((np.arange(len(rand)), small, row_ids))
    got = twalk.shuffle_csr_rows(torch.as_tensor(row_ids),
                                 torch.as_tensor(jg.indices),
                                 torch.as_tensor(small))
    np.testing.assert_array_equal(got.numpy(), jg.indices[tied])
