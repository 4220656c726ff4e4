"""PyTorch port, the keys join without key planes: the cross lookup beside
K6 (`cross_lookup_plain`) against the JAX package's
`pallas_cross_lookup_pair` (its `_join_kernel`, in Pallas interpret mode);
`join_gathered_keys(impl="pallas")` in the lo-only (M=100, S'=3),
lead-in-hi (M=200, S'=4) and general hi/lo (M=1000, S'=4) layouts, and the
general layout's merge join, against JAX's joins on JAX-sampled SpGKeys;
and a fused Net over a pallas join (mean, attn, lstm), and
`trainer_from_keys(..., join_factory=...)`'s predict, against JAX's.

JAX's pallas join calls `pallas_cross_lookup_pair` for the TPU; here it
runs that kernel in interpret mode, as tests/test_pallas_hidden_sum.py
runs the JAX package's kernels on the CPU.

Tolerances, with their reasons:
- the cross lookup, the joins' feature pairs, masks and sizes: exact
  (integer lookups; the features are the same counts over num_walks,
  computed eagerly on both sides as tests/test_torch_port_join.py does);
- Net logits: rtol = atol = 1e-4 in fp32 (as tests/test_torch_port_table.py
  holds the same fused routes over hsum); predict scores: rtol = atol =
  1e-5 (sigmoids of those logits, as the table trainer's are held).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import surel_plus_tpu.ops.pallas.join_kernel as jax_join_kernel
from surel_plus_tpu.graph.synthetic import rmat_graph
from surel_plus_tpu.models import Net as JaxNet
from surel_plus_tpu.ops.join import join_gathered_keys as jax_join_rows
from surel_plus_tpu.ops.join import make_keys_join as jax_make_keys_join
from surel_plus_tpu.ops.sampler import sample_gsets_device_keys
from surel_plus_tpu.ops.walk import enc_field_layout
from surel_plus_tpu.train import TrainConfig as JaxTrainConfig
from surel_plus_tpu.train.device import trainer_from_keys as jax_trainer
from surel_plus_tpu_torch.convert import params_from_flax
from surel_plus_tpu_torch.models import Net
from surel_plus_tpu_torch.ops.join import join_gathered_keys, make_keys_join
from surel_plus_tpu_torch.ops.kernels.cross_lookup import (
    cross_lookup,
    cross_lookup_cuda,
    cross_lookup_plain,
)
from surel_plus_tpu_torch.spg import SpGKeys
from surel_plus_tpu_torch.train import TrainConfig
from surel_plus_tpu_torch.train.device import trainer_from_keys
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

INT32_MAX = np.iinfo(np.int32).max
LAYOUTS = {"lo_only": (100, 3), "lead_in_hi": (200, 4),
           "general": (1000, 4)}
N, Q_EDGES, H = 60, 16, 16          # JAX's pallas join takes B % 8 == 0
AGGRS = ("attn", "lstm", "mean")
BS, E = 8, 21                        # E % BS != 0


def _t(x):
    """numpy or JAX -> torch with the same bits (uint32 as int32)."""
    x = np.array(x)
    return torch.as_tensor(x.view(np.int32) if x.dtype == np.uint32 else x)


def _np(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.uint32 else x


@pytest.fixture
def jax_pallas_interpret(monkeypatch):
    """JAX's pallas join with its kernel in interpret mode (the CPU)."""
    monkeypatch.setattr(
        jax_join_kernel, "pallas_cross_lookup_pair",
        functools.partial(jax_join_kernel.pallas_cross_lookup_pair,
                          interpret=True))


def _rows(rng, b, ell, universe):
    """[b, ell] int32 sets: sorted distinct node ids of random sizes >= 1
    from range(universe), INT32_MAX padded."""
    out = np.full((b, ell), INT32_MAX, np.int32)
    for r in range(b):
        n = rng.integers(1, ell + 1)
        out[r, :n] = np.sort(rng.choice(universe, size=n, replace=False))
    return out


# ------------------------------------------------------- the cross lookup
def test_cross_lookup_plain_matches_pallas():
    """B=16, L=37: rows that share many nodes (ids below 60), padded slots,
    payload words over the full 32 bits (the top bit too)."""
    rng = np.random.default_rng(17)
    a, b = _rows(rng, 16, 37, 60), _rows(rng, 16, 37, 60)
    words = lambda: np.where(b != INT32_MAX, rng.integers(
        0, 1 << 32, size=b.shape, dtype=np.uint64), 0).astype(np.uint32)
    hi, lo = words(), words()
    hi[:, 0] = 0xFFFFFFFF
    want = jax_join_kernel.pallas_cross_lookup_pair(
        *map(jnp.asarray, (a, b, hi, lo)), interpret=True)
    got = cross_lookup_plain(*map(_t, (a, b, hi, lo)))
    for name, x, y in zip(("hi", "lo"), got, want):
        assert x.dtype == torch.int32
        np.testing.assert_array_equal(x.numpy(), _np(y), err_msg=name)
    assert bool((got[1] != 0).any())                # matches were found
    pad = torch.as_tensor(a == INT32_MAX)
    assert bool((got[0][pad] == 0).all()) and bool((got[1][pad] == 0).all())
    routed = cross_lookup(*map(_t, (a, b, hi, lo)))
    assert all(torch.equal(x, y) for x, y in zip(routed, got))


def test_cross_lookup_plain_blocks_rows():
    """Odd B and L, and a block of rows smaller than B: the same output."""
    from surel_plus_tpu_torch.ops.kernels import cross_lookup as module

    rng = np.random.default_rng(18)
    a, b = _rows(rng, 13, 29, 40), _rows(rng, 13, 29, 40)
    lo = rng.integers(-(1 << 31), 1 << 31, size=b.shape).astype(np.int32)
    args = tuple(map(torch.as_tensor, (a, b, lo, lo)))
    whole = cross_lookup_plain(*args)
    old = module.PLAIN_CHUNK
    module.PLAIN_CHUNK = 3 * 29 * 29
    try:
        blocked = cross_lookup_plain(*args)
    finally:
        module.PLAIN_CHUNK = old
    assert all(torch.equal(x, y) for x, y in zip(whole, blocked))


def test_cross_lookup_cuda_wrapper_rejects_cpu_tensors():
    z = torch.zeros(8, 5, dtype=torch.int32)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        cross_lookup_cuda(z, z, z, z)


def test_cross_lookup_other_devices_raise():
    """No fallback: a device with no kernel and no plain route raises."""
    z = torch.zeros(8, 5, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        cross_lookup(z, z, z, z)


# ------------------------------------------------------------ the joins
@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def sampled(request):
    nw, ns = LAYOUTS[request.param]
    g = rmat_graph(N, 300, seed=41)
    # a set holds at most the graph's N nodes: a bucket of N drops none
    # and keeps L small (the default, M S' + 1, is 4001 in the general
    # layout)
    spgk = sample_gsets_device_keys(g, np.arange(N, dtype=np.int32),
                                    num_walks=nw, num_steps=ns, seed=3,
                                    bucket=N, block_size=64)
    edges = np.random.default_rng(42).integers(
        0, N, size=(2, Q_EDGES)).astype(np.int32)
    return request.param, nw, ns, spgk, edges


def _tspgk(spgk, nw, ns):
    return SpGKeys(nodes=_t(spgk.nodes), khi=_t(spgk.khi), klo=_t(spgk.klo),
                   sizes=_t(spgk.sizes), num_walks=nw, num_steps=ns)


def test_layouts_are_the_intended_ones():
    lead = {k: enc_field_layout(*v)[2] for k, v in LAYOUTS.items()}
    assert lead["lo_only"] < 32 and lead["lead_in_hi"] == 32
    assert lead["general"] > 32                    # fields in the hi word


@pytest.mark.parametrize("impl", ["pallas", "merge"])
def test_planeless_join_matches_jax(sampled, impl, jax_pallas_interpret):
    """The pallas join in every layout, and the merge join, against JAX's
    on the same rows: feature pairs, mask and sizes exactly. The pallas
    join, and the merge join in the general layout, carry no key planes
    and build the feature pairs even when not asked for them."""
    name, nw, ns, spgk, edges = sampled
    planeless = impl == "pallas" or name == "general"
    rows = lambda x: x[jnp.asarray(edges)]
    want = jax_join_rows(rows(spgk.nodes), rows(spgk.khi), rows(spgk.klo),
                         rows(spgk.sizes), nw, ns, impl=impl)
    t = _tspgk(spgk, nw, ns)
    kw = dict(aligned=False, features=False) if planeless else {}
    got = make_keys_join(nw, ns, impl=impl, **kw)(
        t.nodes, t.khi, t.klo, t.sizes, torch.as_tensor(edges))
    for field in ("eidx", "mask", "sizes"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      _np(getattr(want, field)),
                                      err_msg=field)
    assert (got.kown is None) == planeless
    if planeless:
        for field in got._fields[3:]:
            assert getattr(got, field) is None, field
    assert bool((got.eidx[..., 1, :] != 0).any())   # partners were found


def test_pallas_join_equals_merge_join(sampled):
    """On sets the two impls give the same feature pairs, in every
    layout."""
    _, nw, ns, spgk, edges = sampled
    t = _tspgk(spgk, nw, ns)
    args = (t.nodes, t.khi, t.klo, t.sizes, torch.as_tensor(edges))
    merge = make_keys_join(nw, ns)(*args)
    pallas = make_keys_join(nw, ns, impl="pallas")(*args)
    assert torch.equal(merge.eidx, pallas.eidx)
    assert torch.equal(merge.mask, pallas.mask)


def test_join_rejects_unknown_impls():
    z = torch.zeros(2, 1, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown join impl"):
        join_gathered_keys(z, z, z, z[..., 0], 100, 3, impl="sort")


# ------------------------------------------------- the Net and the trainer
def _jax_params(jnet, jj, aggrs):
    p = jax.tree.map(np.asarray, jnet.init(
        jax.random.PRNGKey(6), jnp.zeros((1, 1), jnp.float32), jj))
    if aggrs == "lstm":
        p["params"]["aggr"]["bh"] = np.random.default_rng(9).normal(
            scale=0.2, size=p["params"]["aggr"]["bh"].shape).astype(
            np.float32)
    return p


@pytest.mark.parametrize("aggrs", AGGRS)
def test_fused_net_over_pallas_join_matches_jax(sampled, aggrs,
                                                jax_pallas_interpret):
    """The fused Net over a join without key planes takes the hsum route
    (masked_mean, the folded attention pool, K5's plain version), as
    JAX's fused Net falls through to `pe.hidden` there."""
    _, nw, ns, spgk, edges = sampled
    jj = jax_make_keys_join(nw, ns, impl="pallas")(
        spgk.nodes, spgk.khi, spgk.klo, spgk.sizes, jnp.asarray(edges))
    jnet = JaxNet(input_dim=ns + 1, hidden_dim=H, aggrs=aggrs, dropout=0.0,
                  key_layout=(nw, ns), fused_hidden=True)
    params = _jax_params(jnet, jj, aggrs)
    want = np.asarray(jnet.apply(params, jnp.zeros((1, 1), jnp.float32),
                                 jj))
    net = Net(ns + 1, H, aggrs=aggrs, dropout=0.0, key_layout=(nw, ns),
              fused_hidden=True, device="cpu")
    net.load_state_dict(params_from_flax(params))
    t = _tspgk(spgk, nw, ns)
    joined = make_keys_join(nw, ns, impl="pallas")(
        t.nodes, t.khi, t.klo, t.sizes, torch.as_tensor(edges))
    with torch.no_grad():
        got = net.eval()(joined).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("aggrs", AGGRS)
def test_trainer_with_pallas_join_factory_matches_jax(sampled, aggrs,
                                                      jax_pallas_interpret):
    """`trainer_from_keys(net, spgk, cfg, join_factory=...)` with the
    pallas join: predict against JAX's trainer built the same way (the
    fused route on both sides), and the fused Net trains over it."""
    _, nw, ns, spgk, _ = sampled
    rng = np.random.default_rng(43)
    edges = rng.integers(0, N, size=(2, E)).astype(np.int32)
    factory = lambda m, s: jax_make_keys_join(m, s, impl="pallas")
    jnet = JaxNet(input_dim=ns + 1, hidden_dim=H, aggrs=aggrs,
                  fused_hidden=True)
    jtr = jax_trainer(jnet, spgk, JaxTrainConfig(batch_size=BS),
                      join_factory=factory)
    params, _ = jtr.init(jax.random.PRNGKey(7), edges[:, :BS])
    want = np.asarray(jtr.predict(params, edges))
    net = Net(ns + 1, H, aggrs=aggrs, fused_hidden=True, device="cpu")
    net.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    tr = trainer_from_keys(net, _tspgk(spgk, nw, ns),
                           TrainConfig(batch_size=BS),
                           join_factory=lambda m, s: make_keys_join(
                               m, s, impl="pallas"))
    got = tr.predict(edges)
    assert got.shape == (E,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    losses, _ = tr.fit(edges, (rng.random(E) < 0.5).astype(np.float32), 1,
                       torch.Generator())
    assert bool(torch.isfinite(losses).all())
