"""PyTorch port, the keys join: on JAX-sampled SpGKeys carried across,
every JoinedBatch field equals the JAX package's, in the lo-only layout
(M=100, S'=3: field 1 at bit 14, the root bit at 21) and in the
lead-in-hi layout (M=200, S'=4: the root bit in the hi word)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surel_plus_tpu.graph.synthetic import rmat_graph
from surel_plus_tpu.ops.join import make_keys_join as jax_make_keys_join
from surel_plus_tpu.ops.sampler import sample_gsets_device_keys
from surel_plus_tpu.ops.walk import enc_field_layout
from surel_plus_tpu_torch.ops.join import (
    join_gathered_keys,
    make_keys_join,
    unpack_key_features,
)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _carry(spgk):
    """JAX SpGKeys -> torch (nodes, khi, klo, sizes), keys as int32 bits."""
    c = lambda x: torch.as_tensor(np.array(x).view(np.int32))
    return c(spgk.nodes), c(spgk.khi), c(spgk.klo), c(spgk.sizes)


def _np(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.uint32 else x


@pytest.fixture(scope="module", params=[(100, 3), (200, 4)],
                ids=["lo_only", "lead_in_hi"])
def sampled(request):
    nw, ns = request.param
    g = rmat_graph(150, 700, seed=13)
    spgk = sample_gsets_device_keys(g, np.arange(150, dtype=np.int32),
                                    num_walks=nw, num_steps=ns, seed=2,
                                    block_size=64)
    edges = np.random.default_rng(14).integers(0, 150, size=(2, 16))
    return nw, ns, spgk, edges


def test_layouts_are_the_intended_ones():
    assert enc_field_layout(100, 3) == (7, {3: 0, 2: 7, 1: 14}, 21)
    assert enc_field_layout(200, 4)[2] == 32


def test_join_matches_jax(sampled):
    nw, ns, spgk, edges = sampled
    # eager: under jit XLA turns the feature scaling (counts / num_walks)
    # into a multiply by the reciprocal, which can differ by 1 ulp
    want = jax_make_keys_join(nw, ns)(
        spgk.nodes, spgk.khi, spgk.klo, spgk.sizes,
        jnp.asarray(edges, jnp.int32))
    got = make_keys_join(nw, ns)(*_carry(spgk), torch.as_tensor(edges))
    lead_hi = nw == 200
    for name in got._fields:
        w, t = getattr(want, name), getattr(got, name)
        if name.endswith("_root") and not lead_hi:
            assert w is None and t is None, name
            continue
        assert t is not None, name
        np.testing.assert_array_equal(t.numpy(), _np(w), err_msg=name)


def test_unaligned_join_keeps_the_merged_planes(sampled):
    """aligned=False drops the slot-aligned outputs (the un-sort, the
    feature pairs) and leaves every other field as it was."""
    nw, ns, spgk, edges = sampled
    rows = [x[torch.as_tensor(edges)] for x in _carry(spgk)]
    full = join_gathered_keys(*rows, nw, ns)
    lean = join_gathered_keys(*rows, nw, ns, aligned=False)
    for name in full._fields:
        a, b = getattr(full, name), getattr(lean, name)
        if name in ("eidx", "kcross_al", "kcross_al_root"):
            assert b is None, name
        elif a is None:
            assert b is None, name
        else:
            assert torch.equal(a, b), name


def test_unpack_key_features_matches_jax():
    from surel_plus_tpu.ops.join import unpack_key_features as jax_unpack

    rng = np.random.default_rng(0)
    for nw, ns in ((100, 3), (200, 4)):
        hi = rng.integers(0, 1 << 32, size=(3, 7), dtype=np.int64).astype(
            np.uint32)
        lo = rng.integers(0, 1 << 32, size=(3, 7), dtype=np.int64).astype(
            np.uint32)
        want = jax_unpack(jnp.asarray(hi), jnp.asarray(lo), nw, ns)
        got = unpack_key_features(torch.as_tensor(hi.view(np.int32)),
                                  torch.as_tensor(lo.view(np.int32)), nw, ns)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_unported_layouts_raise():
    """The general hi/lo layout (M=1000, S'=4: field 1 starts in the hi
    word) on the merge and impl="pallas" in the lo-only layout join
    (once they raised; the name dates from then) hand-built rows with
    shared nodes, padding and full 32-bit key words exactly as the JAX
    package's merge join does: the same feature pairs, mask and sizes,
    and no key planes."""
    rng = np.random.default_rng(3)
    b, ell = 3, 6
    nodes = np.full((2, b, ell), np.iinfo(np.int32).max, np.int32)
    for q in range(2):
        for r in range(b):
            n = rng.integers(2, ell + 1)
            nodes[q, r, :n] = np.sort(rng.choice(9, size=n, replace=False))
    valid = nodes != np.iinfo(np.int32).max
    words = lambda: np.where(valid, rng.integers(
        0, 1 << 32, size=nodes.shape, dtype=np.uint64), 0).astype(np.uint32)
    hi, lo = words(), words()
    sizes = valid.sum(axis=-1).astype(np.int32)
    from surel_plus_tpu.ops.join import join_gathered_keys as jax_join

    t = lambda x: torch.as_tensor(x.view(np.int32))
    for (nw, ns), impl in (((1000, 4), "merge"), ((100, 3), "pallas")):
        want = jax_join(*map(jnp.asarray, (nodes, hi, lo, sizes)), nw, ns)
        got = join_gathered_keys(t(nodes), t(hi), t(lo), t(sizes), nw, ns,
                                 impl=impl)
        for name in ("eidx", "mask", "sizes"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          _np(getattr(want, name)),
                                          err_msg=f"{impl} {name}")
        assert got.kown is None and got.kcross_al is None
        assert bool((got.eidx[..., 1, :] != 0).any())  # partners found
