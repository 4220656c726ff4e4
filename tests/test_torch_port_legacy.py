"""PyTorch port, the SUREL-v1 legacy API (`ops/legacy.py`) and the walk
under it (`ops/walk.py`: `rows_searchsorted`, `walk_block`,
`build_sets_block`, `walk_block_with_rpe`), against the JAX package:

- the invariants of tests/test_legacy.py: every walk starts at its root
  and steps along edges, each column's landing mass is M, the
  without-replacement first hop is distinct (or covers the row),
  `rw_matrix`'s values are 1-based with a zero row and a real dedup,
  each pointing at its node's count row,
  `np_sampling` concatenates the sets, `batch_sampler`'s union is sorted,
  holds the walks and keeps to its budget, `walk_join` is the host
  loop's join;
- `rows_searchsorted` and `walk_join` exactly JAX's on the same rows,
  walks and queries;
- the walk from JAX's key (with and without replacement) exactly JAX's
  walk, and the sets built from the same walks exactly JAX's
  `_build_sets_block` (bucket whole and cut);
- `walk_sampler` (with and without replacement, over several blocks and
  a partial last one), `np_sampling` and `batch_sampler` on an RMAT
  graph exactly JAX's from the same seed (the same key tree);
- whole calls on the RNG-free directed chain of
  tests/test_reference_golden.py (every walk is the path i, i+1, ...):
  `walk_sampler`, `rw_matrix`'s matrix and `batch_sampler` exactly
  JAX's. `rw_matrix`'s table of count rows differs from JAX's on
  purpose: JAX's repeats the first row for every key.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surel_plus_tpu.graph.csr import CSRGraph as JaxCSRGraph
from surel_plus_tpu.ops import legacy as jlegacy
from surel_plus_tpu.ops import walk as jwalk
from surel_plus_tpu_torch.graph import rmat_graph, ring_of_cliques
from surel_plus_tpu_torch.graph.csr import CSRGraph
from surel_plus_tpu_torch.ops import prng
from surel_plus_tpu_torch.ops import walk as twalk
from surel_plus_tpu_torch.ops.legacy import (
    batch_sampler,
    gen_batch,
    np_sampling,
    rw_matrix,
    walk_join,
    walk_sampler,
)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

M, S = 10, 2  # walks, walk steps


@pytest.fixture(scope="module")
def g():
    return rmat_graph(200, 900, seed=0)


def _on_edges(g, w):
    """Every step of every walk [n, M, S+1] follows an edge or stays on a
    node without one."""
    for a, b in zip(w[..., :-1].ravel(), w[..., 1:].ravel()):
        if len(g.neighbors(a)):
            assert g.has_edge(a, b), (a, b)
        else:
            assert a == b


def test_walk_sampler_shapes_and_mass(g):
    seeds = np.arange(50, dtype=np.int32)
    walks, (nodes, counts, sizes) = walk_sampler(
        g, seeds, num_walks=M, num_steps=S, block_size=16, device="cpu")
    assert walks.shape == (50, M * (S + 1)) and walks.dtype == np.int32
    w = walks.reshape(50, M, S + 1)
    assert np.all(w[:, :, 0] == seeds[:, None])
    _on_edges(g, w)
    valid = np.arange(nodes.shape[1])[None, :] < sizes[:, None]
    per_seed = (counts * valid[:, :, None]).sum(axis=1)
    assert np.all(per_seed == M)
    # the sets hold exactly the walks' nodes, ascending
    for i in range(50):
        assert list(nodes[i, :sizes[i]]) == sorted(set(w[i].ravel()))


def test_walk_sampler_wo_replacement_first_hop(g):
    seeds = np.arange(30, dtype=np.int32)
    walks, _ = walk_sampler(g, seeds, num_walks=M, num_steps=S,
                            replacement=False, block_size=30, device="cpu")
    w = walks.reshape(30, M, S + 1)
    for i in range(30):
        deg = len(g.neighbors(seeds[i]))
        first = w[i, :, 1]
        if deg >= M:
            assert len(np.unique(first)) == M
        elif deg > 0:
            assert set(first) == set(g.neighbors(seeds[i]))


def test_rw_matrix(g):
    seeds = np.arange(g.num_nodes, dtype=np.int32)
    z, freqs = rw_matrix(g, seeds, num_walks=M, num_steps=S + 1,
                         device="cpu")
    assert z.shape == (200, 200)
    assert z.data.min() >= 1 and z.data.max() <= len(freqs) - 1
    assert freqs.shape[1] == S + 1
    assert freqs[0].sum() == 0
    assert len(freqs) - 1 <= z.nnz
    # the rows are distinct, and each stored value points at its node's
    # count row
    assert len({tuple(r) for r in freqs[1:]}) == len(freqs) - 1
    _assert_points_at_rows(g, seeds, z, freqs, M, S + 1)
    zf, full = rw_matrix(g, seeds, num_walks=M, num_steps=S + 1,
                         reduced=False, device="cpu")
    assert len(full) - 1 == z.nnz
    _assert_points_at_rows(g, seeds, zf, full, M, S + 1)


def _assert_points_at_rows(g, seeds, z, freqs, num_walks, num_steps):
    keys, rows, sizes = np_sampling(g, seeds, bsize=65536,
                                    num_walks=num_walks,
                                    num_steps=num_steps - 1, seed=111413,
                                    device="cpu")
    owner = np.repeat(seeds, sizes)
    np.testing.assert_array_equal(
        freqs[np.asarray(z[owner, keys]).ravel()], rows)


def test_np_sampling(g):
    seeds = np.arange(40, dtype=np.int32)
    keys, freqs, sizes = np_sampling(g, seeds, bsize=40, num_walks=M,
                                     num_steps=S, device="cpu")
    assert len(keys) == sizes.sum()
    assert freqs.shape == (sizes.sum(), S + 1)
    assert np.all(freqs[:, 1:].sum(axis=0) == M * len(seeds))


def test_batch_sampler(g):
    q = np.array([0, 5, 9], np.int32)
    union, walks = batch_sampler(g, q, num_walks=M, num_steps=S,
                                 device="cpu")
    assert np.all(np.diff(union) > 0)
    assert set(walks.ravel().tolist()) | set(q.tolist()) == set(
        union.tolist())
    assert walks.shape == (3, M, S)
    cut, _ = batch_sampler(g, q, num_walks=M, num_steps=S, thld=4,
                           device="cpu")
    np.testing.assert_array_equal(cut, union[:4])


def _host_join(walks, u, v):
    vv = np.unique(walks[v])
    pos = np.minimum(np.searchsorted(vv, walks[u]), len(vv) - 1)
    return np.where(vv[pos] == walks[u], pos + 1, 0)


def test_walk_join_matches_the_host_loop_and_jax():
    rng = np.random.default_rng(5)
    n, W, B = 20, 12, 16
    walks = rng.integers(0, 30, size=(n, W)).astype(np.int32)
    queries = rng.integers(0, n, size=(2, B)).astype(np.int32)
    seeds = np.arange(n, dtype=np.int32)
    left, right = walk_join(walks, seeds, queries, device="cpu")
    assert left.dtype == right.dtype == np.int32
    for b, (u, v) in enumerate(queries.T):
        np.testing.assert_array_equal(left[b], _host_join(walks, u, v))
        np.testing.assert_array_equal(right[b], _host_join(walks, v, u))
    jl, jr = jlegacy.walk_join(walks, seeds, queries)
    np.testing.assert_array_equal(left, jl)
    np.testing.assert_array_equal(right, jr)


def test_walk_join_on_sampled_walks():
    g = ring_of_cliques(3, 4)
    seeds = np.arange(g.num_nodes, dtype=np.int32)
    walks, _ = walk_sampler(g, seeds, num_walks=4, num_steps=2,
                            block_size=16, device="cpu")
    queries = np.array([[0, 1], [1, 2]], np.int32)
    left, right = walk_join(walks, seeds, queries, device="cpu")
    assert left.shape == right.shape == (2, walks.shape[1])
    vv = np.unique(walks[1])
    for slot, idx in enumerate(left[0]):
        node = walks[0, slot]
        if idx > 0:
            assert vv[idx - 1] == node
        else:
            assert node not in vv
    jl, jr = jlegacy.walk_join(walks, seeds, queries)
    np.testing.assert_array_equal(left, jl)
    np.testing.assert_array_equal(right, jr)


@pytest.mark.parametrize("n,t", [(1, 5), (7, 3), (64, 40), (301, 301)])
def test_rows_searchsorted_matches_jax(n, t):
    rng = np.random.default_rng(n)
    a = np.sort(rng.integers(0, 50, size=(6, n)), axis=1).astype(np.int32)
    q = rng.integers(-2, 53, size=(6, t)).astype(np.int32)
    want = np.asarray(jwalk.rows_searchsorted(jnp.asarray(a),
                                              jnp.asarray(q)))
    got = twalk.rows_searchsorted(torch.as_tensor(a), torch.as_tensor(q))
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_graph(g):
    return JaxCSRGraph(indptr=g.indptr, indices=g.indices)


@pytest.mark.parametrize("replacement", [True, False])
@pytest.mark.parametrize("num_steps", [1, 3])
def test_walk_with_jax_bits_matches_jax(g, replacement, num_steps):
    seeds = np.concatenate([np.arange(60), [199, 198]]).astype(np.int32)
    rng = np.random.default_rng(1)
    order = np.lexsort((rng.random(g.num_edges),
                        np.repeat(np.arange(g.num_nodes), g.degrees())))
    shuffled = g.indices[order]
    key = jax.random.PRNGKey(4)
    want = np.asarray(jwalk._walk_block(
        jnp.asarray(g.indptr), jnp.asarray(g.indices), jnp.asarray(shuffled),
        jnp.asarray(seeds), M, num_steps, key, replacement=replacement))
    t = lambda x: torch.as_tensor(x, dtype=torch.int64)
    got = twalk.walk_block(t(g.indptr), t(g.indices), t(shuffled), t(seeds),
                           M, num_steps, prng.as_key(key), replacement)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("replacement", [True, False])
@pytest.mark.parametrize("seed", [0, 111413])
def test_walk_sampler_matches_jax(g, replacement, seed):
    """The whole legacy sampler from one seed, in blocks of 48 seeds (a
    partial last block), and np_sampling and batch_sampler, exactly
    JAX's."""
    jg = _jax_graph(g)
    seeds = np.concatenate([np.arange(100), [199, 0, 7]]).astype(np.int32)
    got = walk_sampler(g, seeds, num_walks=M, num_steps=3,
                       replacement=replacement, seed=seed, block_size=48,
                       device="cpu")
    want = jlegacy.walk_sampler(jg, seeds, num_walks=M, num_steps=3,
                                replacement=replacement, seed=seed,
                                block_size=48)
    np.testing.assert_array_equal(got[0], want[0])
    for x, y in zip(got[1], want[1]):
        np.testing.assert_array_equal(x, y)
    if replacement:
        for x, y in zip(np_sampling(g, seeds, 48, M, 3, seed, device="cpu"),
                        jlegacy.np_sampling(jg, seeds, 48, M, 3, seed)):
            np.testing.assert_array_equal(x, y)
    else:
        q = seeds[:9]
        for x, y in zip(batch_sampler(g, q, M, 3, seed, device="cpu"),
                        jlegacy.batch_sampler(jg, q, M, 3, seed)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("bucket", [None, 7])
def test_build_sets_block_matches_jax(g, bucket):
    """The sets of JAX's own walks, whole and cut to 7 slots."""
    seeds = np.arange(40, dtype=np.int32)
    walks = np.array(jwalk._walk_block(
        jnp.asarray(g.indptr), jnp.asarray(g.indices),
        jnp.asarray(g.indices), jnp.asarray(seeds), M, S,
        jax.random.PRNGKey(2), replacement=True))
    bucket = bucket or M * S + 1
    want = jwalk._build_sets_block(jnp.asarray(seeds), jnp.asarray(walks),
                                   M, S, bucket)
    got = twalk.build_sets_block(torch.as_tensor(seeds),
                                 torch.as_tensor(walks), M, S, bucket)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def _chain(n):
    """Directed chain 0 -> 1 -> ... -> n-1 (the last node is a sink)."""
    indptr = np.concatenate([np.arange(n), [n - 1]]).astype(np.int32)
    return CSRGraph(indptr=indptr,
                    indices=np.arange(1, n, dtype=np.int32))


@pytest.mark.parametrize("replacement", [True, False])
def test_walk_sampler_on_a_chain_matches_jax(replacement):
    g = _chain(24)
    seeds = np.arange(24, dtype=np.int32)
    got = walk_sampler(g, seeds, num_walks=6, num_steps=3,
                       replacement=replacement, block_size=10,
                       device="cpu")
    want = jlegacy.walk_sampler(_jax_graph(g), seeds, num_walks=6,
                                num_steps=3, replacement=replacement,
                                block_size=10)
    np.testing.assert_array_equal(got[0], want[0])
    for x, y in zip(got[1], want[1]):
        np.testing.assert_array_equal(x, y)
    w = got[0].reshape(24, 6, 4)
    assert np.all(w == np.minimum(seeds[:, None, None]
                                  + np.arange(4)[None, None, :], 23))


def test_rw_matrix_and_batch_sampler_on_a_chain_match_jax():
    g = _chain(30)
    seeds = np.arange(30, dtype=np.int32)
    z, freqs = rw_matrix(g, seeds, num_walks=5, num_steps=4, device="cpu")
    jz, jfreqs = jlegacy.rw_matrix(_jax_graph(g), seeds, num_walks=5,
                                   num_steps=4)
    assert (z != jz).nnz == 0
    assert freqs.shape == jfreqs.shape
    np.testing.assert_array_equal(freqs[0], jfreqs[0])
    _assert_points_at_rows(g, seeds, z, freqs, 5, 4)
    # JAX's table repeats the first count row for every key (its
    # np.minimum.at starts from zeros); the port keeps each key's row
    assert np.all(jfreqs[1:] == jfreqs[1]) and len(freqs) > 2
    q = np.array([3, 11, 28], np.int32)
    got = batch_sampler(g, q, num_walks=5, num_steps=3, device="cpu")
    want = jlegacy.batch_sampler(_jax_graph(g), q, num_walks=5,
                                 num_steps=3)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)


def test_gen_batch():
    assert list(gen_batch(list(range(7)), 3)) == [[0, 1, 2], [3, 4, 5]]
    assert list(gen_batch(list(range(7)), 3, keep=True)) == [
        [0, 1, 2], [3, 4, 5], [6]]
    assert list(gen_batch(list(range(7)), 3, keep=True)) == list(
        jlegacy.gen_batch(list(range(7)), 3, keep=True))
