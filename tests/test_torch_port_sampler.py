"""PyTorch port, sampling: graph construction, the edge-table walk and the
packed set builder held to the JAX package exactly; the samplers' sets
from one seed held to JAX's bit for bit (the same threefry key tree:
`sample_gsets_device_keys`, `sample_gsets_device`, `sample_gsets`,
`subg_matrix_device_keys`, over several blocks with a partial last one,
on an RMAT graph and on one with degree-0 seeds, in the lo-only and the
lead-in-hi layout); `SpG.to_scipy` held to JAX's on those sets; and the
sampler invariants of tests/test_sampler.py. The device sampler's
normalized encoding table is held to 1 ulp: JAX's jitted division turns
into a multiply by the reciprocal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surel_plus_tpu.graph.csr import csr_from_edges as jax_csr_from_edges
from surel_plus_tpu.graph.synthetic import ring_of_cliques
from surel_plus_tpu.graph.synthetic import rmat_graph as jax_rmat_graph
from surel_plus_tpu.ops import sampler as jsampler
from surel_plus_tpu.ops import walk as jwalk
from surel_plus_tpu.ops.sampler import device_graph as jax_device_graph
from surel_plus_tpu_torch.graph import csr_from_edges, rmat_graph
from surel_plus_tpu_torch.graph.csr import CSRGraph
from surel_plus_tpu_torch.ops import sampler as tsampler
from surel_plus_tpu_torch.ops import walk as twalk
from surel_plus_tpu_torch.ops.sampler import (
    sample_gsets_device_keys,
    shuffled_indices_for,
)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

INT32_MAX = np.iinfo(np.int32).max


def _t(x):
    return torch.as_tensor(np.array(x))


def _bits_np(x):
    """uint32 (JAX) or int32-bits (port) array -> int32 bits for equality."""
    return np.asarray(x).view(np.int32)


def test_rmat_and_csr_match_jax():
    a, b = rmat_graph(300, 1500, seed=4), jax_rmat_graph(300, 1500, seed=4)
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    rng = np.random.default_rng(0)
    edges = rng.integers(0, 50, size=(400, 2))
    w = rng.random(400).astype(np.float32)
    a = csr_from_edges(edges, num_nodes=60, weights=w)
    b = jax_csr_from_edges(edges, num_nodes=60, weights=w,
                           prefer_native=False)
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_allclose(a.data, b.data, rtol=1e-6)


def test_shuffled_rows_are_permutations():
    g = rmat_graph(200, 900, seed=1)
    sh = shuffled_indices_for(g, 3, "cpu").numpy()
    for u in range(g.num_nodes):
        lo, hi = g.indptr[u], g.indptr[u + 1]
        np.testing.assert_array_equal(np.sort(sh[lo:hi]), g.indices[lo:hi])


def test_walk_block_tables_matches_jax_given_bits():
    """Same shuffled rows, same per-step bits (jax.random.bits of each
    step key, as _walk_block_tables draws them): identical walks."""
    num_walks, num_steps = 20, 3
    g = rmat_graph(400, 2000, seed=11)
    # one isolated last node: its start slot is one past the edge table
    g = dataclasses.replace(g, indptr=np.concatenate(
        [g.indptr, g.indptr[-1:]]).astype(np.int32))
    n = g.num_nodes
    sh = np.random.default_rng(5).permutation(g.num_edges)
    row_ids = np.repeat(np.arange(n), np.diff(g.indptr))
    shuffled = g.indices[np.lexsort((sh, row_ids))]
    key = jax.random.PRNGKey(42)
    seeds = np.arange(n, dtype=np.int32)

    jindptr, jindices = jnp.asarray(g.indptr), jnp.asarray(g.indices)
    etab, stab = jwalk.build_walk_tables(jindptr, jindices,
                                         jnp.asarray(shuffled))
    want = jwalk._walk_block_tables(jindptr, etab, stab, jnp.asarray(seeds),
                                    num_walks, num_steps, key)
    bits = np.stack([np.asarray(jax.random.bits(
        k, (n, num_walks), dtype=jnp.uint32)) for k in jax.random.split(
            key, num_steps - 1)]).astype(np.int64)

    tindptr, tindices = g.to("cpu")
    tetab, tstab = twalk.build_walk_tables(tindptr, tindices,
                                           _t(shuffled).long())
    got = twalk.walk_block_tables(tindptr, tetab, tstab, _t(seeds),
                                  num_walks, num_steps, _t(bits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[-1] == n - 1).all()      # the isolated walker stays


@pytest.mark.parametrize("num_walks,num_steps,bucket", [
    (16, 3, None),      # lo-only layout
    (16, 3, 5),         # bucket < visits: truncated rows
    (100, 3, None),     # the bench layout: shift 7, lead bit 21
    (200, 4, None),     # lead-in-hi layout: the root bit in hi
    (4, 1, 9),          # bucket > visits: padded rows
])
def test_build_sets_packed_block_matches_jax(num_walks, num_steps, bucket):
    g = jax_rmat_graph(300, 1500, seed=2)
    indptr, indices = jax_device_graph(g)
    shuffled = jnp.asarray(g.indices[::-1].copy())
    seeds = jnp.arange(96, dtype=jnp.int32)
    walks = jwalk._walk_block(indptr, indices, shuffled, seeds, num_walks,
                              num_steps, jax.random.PRNGKey(3))
    if bucket is None:
        bucket = num_walks * num_steps + 1
    want = jwalk._build_sets_packed_block(seeds, walks, num_walks,
                                          num_steps, bucket,
                                          num_nodes=g.num_nodes)
    got = twalk.build_sets_packed_block(_t(seeds), _t(walks).long(),
                                        num_walks, num_steps, bucket)
    for name, w, t in zip(("nodes", "sizes", "hi", "lo"), want, got):
        np.testing.assert_array_equal(_bits_np(t.numpy()), _bits_np(w),
                                      err_msg=name)


def _fields(spgk):
    """[n, L, ncol] landing counts (col 0 = root weight) from the keys."""
    nw, ns = spgk.num_walks, spgk.num_steps
    shift, starts, lead_bit = jwalk.enc_field_layout(nw, ns)
    hi = spgk.khi.numpy().view(np.uint32).astype(np.uint64)
    lo = spgk.klo.numpy().view(np.uint32).astype(np.uint64)
    packed = (hi << np.uint64(32)) | lo
    out = jwalk.unpack_encodings(packed.reshape(-1), nw, ns)
    return out.reshape(*packed.shape, ns + 1)


@pytest.mark.parametrize("num_walks,num_steps", [(20, 3), (200, 4)])
def test_sample_gsets_device_keys_invariants(num_walks, num_steps):
    g = rmat_graph(500, 2000, seed=3)
    seeds = np.arange(g.num_nodes)
    s = sample_gsets_device_keys(g, seeds, num_walks, num_steps, seed=7,
                                 block_size=128, device="cpu")
    nodes, sizes = s.nodes.numpy(), s.sizes.numpy()
    L = num_walks * num_steps + 1
    assert nodes.shape == (g.num_nodes, L)
    valid = np.arange(L)[None, :] < sizes[:, None]
    # sorted, padded rows with zero keys past the size
    assert np.all(np.diff(np.where(valid, nodes, INT32_MAX), axis=1)[
        valid[:, 1:]] > 0)
    assert np.all(nodes[~valid] == INT32_MAX)
    assert np.all(s.klo.numpy()[~valid] == 0)
    assert np.all(s.khi.numpy()[~valid] == 0)
    enc = _fields(s)
    # the root is in its own set with landing weight num_walks at col 0
    is_root = nodes == seeds[:, None]
    assert np.all(is_root.sum(axis=1) == 1)
    assert np.all(enc[is_root][:, 0] == num_walks)
    assert np.all(enc[valid & ~is_root][:, 0] == 0)
    # mass conservation: every step column sums to num_walks per seed
    per_seed = (enc * valid[:, :, None]).sum(axis=1)
    assert np.all(per_seed == num_walks)


def test_isolated_node_convention():
    """Degree-0 seed: set = {root}, counts num_walks at every step."""
    g = ring_of_cliques(3, 3)
    g2 = CSRGraph(indptr=np.concatenate([g.indptr, g.indptr[-1:]]).astype(
        np.int32), indices=g.indices)
    iso = g2.num_nodes - 1
    s = sample_gsets_device_keys(g2, np.array([iso, 0]), 8, 3, seed=0,
                                 block_size=2, device="cpu")
    assert int(s.sizes[0]) == 1
    assert int(s.nodes[0, 0]) == iso
    assert np.all(_fields(s)[0, 0] == 8)


# the exact-sets cases: (graph, (M, S')), each at two seeds, in blocks of
# 64 seeds (a partial last block)
SET_GRAPHS = ("rmat", "degree0")
SET_LAYOUTS = {"lo_only": (4, 3), "lead_in_hi": (200, 4)}
SET_BLOCK = 64


def _set_graph(kind):
    """(port graph, JAX graph, seeds): rmat_graph(200, 1000, seed=0), or a
    graph whose last 20 of 220 nodes have no edge, seeds among them."""
    if kind == "rmat":
        return (rmat_graph(200, 1000, seed=0),
                jax_rmat_graph(200, 1000, seed=0),
                np.arange(200, dtype=np.int32))
    edges = np.random.default_rng(5).integers(0, 200, size=(800, 2))
    seeds = np.concatenate([np.arange(150), np.arange(200, 220)])
    return (csr_from_edges(edges, num_nodes=220),
            jax_csr_from_edges(edges, num_nodes=220, prefer_native=False),
            seeds.astype(np.int32))


@pytest.mark.parametrize("seed", [0, 111413])
@pytest.mark.parametrize("layout", sorted(SET_LAYOUTS))
@pytest.mark.parametrize("kind", SET_GRAPHS)
def test_samplers_match_jax_exactly(kind, layout, seed):
    nw, ns = SET_LAYOUTS[layout]
    g, jg, seeds = _set_graph(kind)
    if kind == "degree0":
        assert np.all(g.degrees()[seeds[-20:]] == 0)
    kw = dict(seed=seed, block_size=SET_BLOCK)
    want = jsampler.sample_gsets_device_keys(jg, seeds, nw, ns, **kw)
    got = tsampler.sample_gsets_device_keys(g, seeds, nw, ns, device="cpu",
                                            **kw)
    for k in ("nodes", "khi", "klo", "sizes"):
        np.testing.assert_array_equal(_bits_np(getattr(got, k)),
                                      _bits_np(getattr(want, k)), err_msg=k)
    want = jsampler.subg_matrix_device_keys(jg, seeds, nw, ns + 1, **kw)
    got = tsampler.subg_matrix_device_keys(g, seeds, nw, ns + 1,
                                           device="cpu", **kw)
    for k in ("nodes", "khi", "klo", "sizes"):
        np.testing.assert_array_equal(_bits_np(getattr(got, k)),
                                      _bits_np(getattr(want, k)), err_msg=k)
    want = jsampler.sample_gsets(jg, seeds, nw, ns, **kw)
    got = tsampler.sample_gsets(g, seeds, nw, ns, device="cpu", **kw)
    for k in ("nodes", "eidx", "sizes", "enc", "seeds"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
    assert (got.to_scipy() != want.to_scipy()).nnz == 0
    assert (got.to_scipy(250) != want.to_scipy(250)).nnz == 0
    (want, wu), (got, gu) = (
        jsampler.sample_gsets_device(jg, seeds, nw, ns, **kw),
        tsampler.sample_gsets_device(g, seeds, nw, ns, device="cpu", **kw))
    assert gu == wu
    for k in ("nodes", "eidx", "sizes"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)),
                                      err_msg=k)
    np.testing.assert_array_almost_equal_nulp(got.enc.numpy(),
                                              np.asarray(want.enc), nulp=1)
