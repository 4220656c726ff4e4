"""PyTorch port, the keys join without key planes: the cross lookup beside
K6 (`cross_lookup_pair_plain`, both directions) against the JAX package's
`pallas_cross_lookup_pair` (its `_join_kernel`, in Pallas interpret mode,
once a direction), and K6's search (`_kernel_search`, the kernel's
algorithm lane by lane) against the literal mask;
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
from surel_plus_tpu_torch.ops import prng
from surel_plus_tpu_torch.ops.join import join_gathered_keys, make_keys_join
from surel_plus_tpu_torch.ops.kernels.cross_lookup import (
    cross_lookup_pair,
    cross_lookup_pair_cuda,
    cross_lookup_pair_plain,
)
from surel_plus_tpu_torch.ops.walk import to_bits, u32
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


def _repeat_rows(rng, b, ell, universe, max_run):
    """[b, ell] int32 ascending rows in which nodes repeat: distinct ids
    from range(universe), each 1 to max_run times, cut to a random length
    >= 1, INT32_MAX padded."""
    out = np.full((b, ell), INT32_MAX, np.int32)
    for r in range(b):
        ids = np.sort(rng.choice(universe, size=min(ell, universe),
                                 replace=False))
        row = np.repeat(ids, rng.integers(1, max_run + 1, size=ids.size))
        n = rng.integers(1, min(ell, row.size) + 1)
        out[r, :n] = row[:n]
    return out


def _words(rng, nodes, low_bits=16):
    """uint32 payload words, 0 at padding: the high half over all 16 bits,
    the low half below 2^low_bits."""
    hi = rng.integers(0, 1 << 16, size=nodes.shape, dtype=np.uint64)
    lo = rng.integers(0, 1 << low_bits, size=nodes.shape, dtype=np.uint64)
    return np.where(nodes != INT32_MAX, (hi << 16) | lo, 0).astype(np.uint32)


def _jax_pair(u, v, hi_u, lo_u, hi_v, lo_v):
    """JAX's kernel in interpret mode, once a direction (u -> v, v -> u)."""
    run = lambda a, b, hi, lo: jax_join_kernel.pallas_cross_lookup_pair(
        *map(jnp.asarray, (a, b, hi, lo)), interpret=True)
    return (*run(u, v, hi_v, lo_v), *run(v, u, hi_u, lo_u))


def _assert_planes_equal(got, want):
    for name, x, y in zip(("hi_u", "lo_u", "hi_v", "lo_v"), got, want):
        assert x.dtype == torch.int32
        np.testing.assert_array_equal(x.numpy(), _np(y), err_msg=name)


# ------------------------------------------------------- the cross lookup
def test_cross_lookup_plain_matches_pallas():
    """B=16, L=37: rows that share many nodes (ids below 60), padded slots,
    payload words over the full 32 bits (the top bit too); both directions
    of the pair against JAX's kernel once a direction."""
    rng = np.random.default_rng(17)
    u, v = _rows(rng, 16, 37, 60), _rows(rng, 16, 37, 60)
    words = [_words(rng, x) for x in (u, u, v, v)]
    words[2][:, 0] = 0xFFFFFFFF
    want = _jax_pair(u, v, *words)
    got = cross_lookup_pair_plain(*map(_t, (u, v, *words)))
    _assert_planes_equal(got, want)
    assert bool((got[1] != 0).any()) and bool((got[3] != 0).any())
    for plane, nodes in zip(got, (u, u, v, v)):
        assert bool((plane[torch.as_tensor(nodes == INT32_MAX)] == 0).all())
    routed = cross_lookup_pair(*map(_t, (u, v, *words)))
    assert all(torch.equal(x, y) for x, y in zip(routed, got))


def test_cross_lookup_pair_plain_matches_pallas_on_repeats():
    """Sorted rows in which nodes repeat (runs of up to 4): the sum over a
    run. JAX's kernel ORs its low halves' sum into the shifted high sum,
    which is the sum mod 2^32 while the low halves' sum stays below 2^16:
    here the low halves lie below 2^12, the high halves span all 16 bits."""
    rng = np.random.default_rng(19)
    u, v = (_repeat_rows(rng, 16, 37, 30, 4) for _ in range(2))
    words = [_words(rng, x, low_bits=12) for x in (u, u, v, v)]
    want = _jax_pair(u, v, *words)
    got = cross_lookup_pair_plain(*map(_t, (u, v, *words)))
    _assert_planes_equal(got, want)
    run = max(int((v[r] == x).sum()) for r in range(len(u)) for x in u[r]
              if x != INT32_MAX)
    assert run >= 2                     # a slot of u matched a run of v


def test_cross_lookup_plain_blocks_rows():
    """Odd B and L, and a block of rows smaller than B: the same output."""
    from surel_plus_tpu_torch.ops.kernels import cross_lookup as module

    rng = np.random.default_rng(18)
    a, b = _rows(rng, 13, 29, 40), _rows(rng, 13, 29, 40)
    lo = rng.integers(-(1 << 31), 1 << 31, size=b.shape).astype(np.int32)
    args = tuple(map(torch.as_tensor, (a, b, lo, lo[::-1].copy(), lo,
                                       lo)))
    whole = cross_lookup_pair_plain(*args)
    old = module.PLAIN_CHUNK
    module.PLAIN_CHUNK = 3 * 29 * 29
    try:
        blocked = cross_lookup_pair_plain(*args)
    finally:
        module.PLAIN_CHUNK = old
    assert all(torch.equal(x, y) for x, y in zip(whole, blocked))


def _lower_bound(row, n, x):
    """The kernel's search, for each [B, K] query: the least j in [0, n)
    with row[..., j] >= x, else n, by the same halving steps (row
    [B, K, L] int64)."""
    lo = torch.zeros_like(x)
    while bool((n > 0).any()):
        half = n >> 1
        probe = row.gather(-1, (lo + half).clamp(max=row.shape[-1] - 1)
                           [..., None])[..., 0]
        up = (n > 0) & (probe < x)
        lo = torch.where(up, lo + half + 1, lo)
        n = torch.where(up, n - half - 1, torch.where(n > 0, half, n))
    return lo


def _kernel_search(nodes_u, nodes_v, hi_u, lo_u, hi_v, lo_v,
                   threads: int = 128):
    """The kernel's algorithm on the CPU, lane by lane: each row's valid
    lengths nu, nv by a search for INT32_MAX; lane t of `threads` (the
    kernel's block: 128 threads below L = 512, 256 from there) takes the
    items t, t + threads, ... of the row's nu + nv valid slots (u's
    first), searches the other row's valid prefix (`_lower_bound`) and
    walks the run of equal nodes from there, summing both words; padding
    slots are zeroed. Raises unless every slot is written exactly once.
    Rows must be ascending; then this equals `cross_lookup_pair_plain`."""
    rows, ell = nodes_u.shape
    nodes = torch.stack([nodes_u, nodes_v], 1).to(torch.int64)  # [B, 2, L]
    pays = torch.stack([torch.stack([hi_v, lo_v], 1),             # u's in v
                        torch.stack([hi_u, lo_u], 1)], 1)         # v's in u
    pays = u32(pays)                                          # [B, 2, 2, L]
    full = torch.full((rows, 2), ell, dtype=torch.int64)
    valid = _lower_bound(nodes, full, torch.full_like(full, INT32_MAX))
    nu, nv = valid[:, :1], valid[:, 1:]                       # [B, 1]
    sums = torch.zeros(rows, 2, 2, ell, dtype=torch.int64)
    writes = torch.zeros(rows, 2, ell, dtype=torch.int64)
    lanes = torch.arange(threads)[None, :]
    rb = torch.arange(rows)[:, None].expand(rows, threads)
    for first in range(0, int((nu + nv).max()) if rows else 0, threads):
        k = first + lanes                                     # [B, T]
        live = k < nu + nv
        side = (k >= nu).to(torch.int64)                      # 0: u, 1: v
        i = torch.where(side == 0, k, k - nu).clamp(0, ell - 1)
        node = nodes[rb, side, i]
        other = nodes[rb, 1 - side]                           # [B, T, L]
        n = torch.where(side == 0, nv, nu)
        pay = pays[rb, side]                                  # [B, T, 2, L]
        j = _lower_bound(other, n, node)
        acc = torch.zeros(rows, threads, 2, dtype=torch.int64)
        on = live & (j < n)
        while bool(on.any()):
            jc = j.clamp(max=ell - 1)
            on = on & (other.gather(-1, jc[..., None])[..., 0] == node)
            acc += torch.where(on[..., None], pay.gather(
                -1, jc[..., None, None].expand(rows, threads, 2, 1))[..., 0],
                0)
            j = j + on.to(torch.int64)
            on = on & (j < n)
        sums[rb[live], side[live], :, i[live]] = acc[live]
        writes.index_put_((rb[live], side[live], i[live]),
                          torch.ones_like(i[live]), accumulate=True)
    slot = torch.arange(ell)[None, :]
    writes[:, 0] += (slot >= nu).to(torch.int64)
    writes[:, 1] += (slot >= nv).to(torch.int64)
    if not bool((writes == 1).all()):
        raise RuntimeError("the lanes' items do not cover every slot once")
    out = to_bits(sums & 0xFFFFFFFF)
    return out[:, 0, 0], out[:, 0, 1], out[:, 1, 0], out[:, 1, 1]


def _search_case(rng, case):
    """(u, v) int32 ascending rows for one case of K6's search."""
    if case == "sets":
        return _rows(rng, 13, 29, 40), _rows(rng, 13, 29, 40)
    if case == "repeats":
        return (_repeat_rows(rng, 13, 29, 20, 5),
                _repeat_rows(rng, 13, 29, 20, 5))
    if case == "padding_only":
        u, v = _rows(rng, 13, 29, 40), _rows(rng, 13, 29, 40)
        u[[0, 3, 12]] = INT32_MAX
        v[[1, 3, 7]] = INT32_MAX
        return u, v
    if case == "no_common_node":
        u, v = _rows(rng, 13, 29, 40), _rows(rng, 13, 29, 40)
        return (np.where(u == INT32_MAX, u, 2 * u),
                np.where(v == INT32_MAX, v, 2 * v + 1))
    if case == "L1":
        return _repeat_rows(rng, 9, 1, 3, 1), _repeat_rows(rng, 9, 1, 3, 1)
    assert case == "odd_B_wide_L"      # several rounds of 128 lanes
    return _rows(rng, 5, 301, 600), _repeat_rows(rng, 5, 301, 400, 3)


@pytest.mark.parametrize("case", ["sets", "repeats", "padding_only",
                                  "no_common_node", "L1", "odd_B_wide_L"])
def test_kernel_search_matches_mask(case):
    """K6's algorithm (lower-bound search and run walk, lane by lane, every
    slot written once) equals the literal mask exactly, with the kernel's
    two block sizes and with few lanes (many rounds a row), on ascending
    rows and payload words over all 32 bits."""
    rng = np.random.default_rng(["sets", "repeats", "padding_only",
                                 "no_common_node", "L1",
                                 "odd_B_wide_L"].index(case))
    u, v = _search_case(rng, case)
    assert (np.diff(u.astype(np.int64), axis=1) >= 0).all()
    assert (np.diff(v.astype(np.int64), axis=1) >= 0).all()
    words = [_words(rng, x) for x in (u, u, v, v)]
    args = tuple(map(_t, (u, v, *words)))
    want = cross_lookup_pair_plain(*args)
    for threads in (128, 256, 5):
        got = _kernel_search(*args, threads=threads)
        assert all(torch.equal(x, y) for x, y in zip(got, want)), threads
    hits = sum(int((w != 0).sum()) for w in want)
    assert (hits == 0) == (case == "no_common_node")


def test_kernel_search_needs_sorted_rows():
    """The search relies on ascending rows, the literal mask does not: with
    each row of v shuffled (padding still last) the search misses nodes
    that the mask finds."""
    rng = np.random.default_rng(20)
    u, v = _rows(rng, 13, 29, 40), _rows(rng, 13, 29, 40)
    for row in v:
        n = int((row != INT32_MAX).sum())
        row[:n] = rng.permutation(row[:n])
    args = tuple(map(_t, (u, v, *[_words(rng, x) for x in (u, u, v, v)])))
    got = _kernel_search(*args)
    want = cross_lookup_pair_plain(*args)
    assert not all(torch.equal(x, y) for x, y in zip(got, want))


def test_cross_lookup_cuda_wrapper_rejects_cpu_tensors():
    z = torch.zeros(8, 5, dtype=torch.int32)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        cross_lookup_pair_cuda(z, z, z, z, z, z)


def test_cross_lookup_other_devices_raise():
    """No fallback: a device with no kernel and no plain route raises."""
    z = torch.zeros(8, 5, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        cross_lookup_pair(z, z, z, z, z, z)


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
              fused_hidden=True, key=prng.prng_key(0), device="cpu")
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
    net = Net(ns + 1, H, aggrs=aggrs, fused_hidden=True,
              key=prng.prng_key(0), device="cpu")
    net.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    tr = trainer_from_keys(net, _tspgk(spgk, nw, ns),
                           TrainConfig(batch_size=BS),
                           join_factory=lambda m, s: make_keys_join(
                               m, s, impl="pallas"))
    got = tr.predict(edges)
    assert got.shape == (E,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    losses, _ = tr.fit(edges, (rng.random(E) < 0.5).astype(np.float32), 1,
                       prng.prng_key(0))
    assert bool(torch.isfinite(losses).all())
