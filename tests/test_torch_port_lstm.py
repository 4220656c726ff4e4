"""PyTorch port, the keys-LSTM and the LSTM Net, forward and gradient.

The plain versions of the keys-LSTM kernels are held to the JAX package's
`lstm_from_keys` in Pallas interpret mode (as tests/test_pallas_hidden_sum.py
runs it), the backward to `jax.grad` of it in u_ext, wi, wh and bh: impl
"t2" (the default, which assumes prefix masks) on prefix masks, impl "t1"
on masks with holes and an empty row, in the lo-only and the lead-in-hi
(root planes) layouts and at Q=4. `FusedKeysLSTM` is held to torch's
autograd of the plain forward. `LSTMAggregation` is held to JAX's scan
with and without the projection fold, and the LSTM Net's logits, on both
of the port's routes, to JAX's Net on both of its routes, with the same
weights; both routes train, with gradients that agree.

Tolerances, with their reasons:
- keys-LSTM and LSTMAggregation: rtol = atol = 1e-5 in fp32 (as JAX's own
  test holds its kernel to its scan, tests/test_pallas_hidden_sum.py:
  534-537: the same recurrence with sums in other orders);
- keys-LSTM gradients against JAX: rtol 1e-4, atol 1e-5 (JAX's own test
  of its kernels' VJPs, tests/test_pallas_hidden_sum.py:320-351: sums over
  every row and slot, and back through the recurrence, in other orders);
  against torch's autograd of the same plain forward: rtol = atol = 1e-5;
- Net logits: rtol = atol = 1e-4 in fp32; 3e-2 in bf16, where the
  frameworks round to bf16 at different points (the fold's wi_eff and the
  LSTM's output are bf16-rounded in both); the two routes' parameter
  gradients in fp32: rtol 1e-4, atol 1e-6, as tests/test_torch_port_train.py
  holds them to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surel_plus_tpu.graph.synthetic import rmat_graph
from surel_plus_tpu.models import Net as JaxNet
from surel_plus_tpu.models.layers import LSTMAggregation as JaxLSTM
from surel_plus_tpu.ops.join import make_keys_join as jax_make_keys_join
from surel_plus_tpu.ops.pallas.lstm_kernel import (
    lstm_from_keys as jax_lstm_from_keys,
)
from surel_plus_tpu.ops.sampler import sample_gsets_device_keys
from surel_plus_tpu_torch.convert import params_from_flax
from surel_plus_tpu_torch.models import Net
from surel_plus_tpu_torch.models.layers import LSTMAggregation
from surel_plus_tpu_torch.ops import prng
from surel_plus_tpu_torch.ops.join import join_gathered_keys
from surel_plus_tpu_torch.ops.kernels.hidden_sum import NEG, u_core_rows
from surel_plus_tpu_torch.ops.kernels.lstm_keys import (
    block_layout,
    lstm_from_keys,
    lstm_from_keys_bwd_cuda,
    lstm_from_keys_bwd_plain,
    lstm_from_keys_cuda,
    lstm_from_keys_plain,
    row_order,
)
from surel_plus_tpu_torch.ops.walk import enc_field_layout
from surel_plus_tpu_torch.spg import SpGKeys
from surel_plus_tpu_torch.train import TrainConfig
from surel_plus_tpu_torch.train.device import trainer_from_keys
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

LAYOUTS = {"lo_only": (10, 3), "lead_in_hi": (200, 4)}
WEIGHTS = ("u", "wi", "wh", "bh")
CASES = {"lo_only-q2": ("lo_only", 2), "lead_in_hi-q2": ("lead_in_hi", 2),
         "lo_only-q4": ("lo_only", 4)}
B, L, H = 5, 11, 8


def _case(name, seed=0, holes=False):
    """Random operands at Q, B=5, L=11, H=8: keys with every field used,
    prefix masks of random sizes >= 1 or, with `holes`, random masks with
    row (0, 0) empty and row (0, 1) valid only at its last slot; the root
    planes of the lead-in-hi layout; weights at the scale of a trained
    LSTM's."""
    layout, q = CASES[name]
    nw, ns = LAYOUTS[layout]
    shift, starts, lead_bit = enc_field_layout(nw, ns)
    rng = np.random.default_rng(seed)

    def keys():
        k = np.zeros((q, B, L), np.uint32)
        for j in range(1, ns + 1):
            k |= rng.integers(0, nw + 1, size=k.shape).astype(
                np.uint32) << np.uint32(starts[j])
        if lead_bit < 32:
            k |= rng.integers(0, 2, size=k.shape).astype(
                np.uint32) << np.uint32(lead_bit)
        return k

    kown, kcross = keys(), keys()
    if holes:
        mask = rng.random((q, B, L)) < 0.6
        mask[0, 0] = False
        mask[0, 1] = False
        mask[0, 1, L - 1] = True
    else:
        sizes = rng.integers(1, L + 1, size=(q, B))
        mask = np.arange(L)[None, None, :] < sizes[..., None]
    w1 = rng.normal(size=(ns + 1, H)).astype(np.float32)
    b1 = (0.1 * rng.normal(size=H)).astype(np.float32)
    u = torch.cat([u_core_rows(torch.as_tensor(w1), nw, ns),
                   torch.full((1, H), NEG), torch.as_tensor(b1)[None]])
    w = lambda *s: (0.3 * rng.normal(size=s)).astype(np.float32)
    roots = None
    if lead_bit == 32:
        roots = tuple(rng.integers(0, 2, size=(q, B, L)).astype(np.int32)
                      for _ in range(2))
    return dict(kown=kown, kcross=kcross, mask=mask, u=u.numpy(),
                wi=w(H, 4 * H), wh=w(H, 4 * H), bh=w(4 * H), roots=roots,
                shift=int(nw).bit_length())


def _jax_operands(c):
    """JAX's operands of a case: the keys and mask, the root planes as
    keywords."""
    jr = {} if c["roots"] is None else dict(
        root_own=jnp.asarray(c["roots"][0]),
        root_cross=jnp.asarray(c["roots"][1]))
    return tuple(jnp.asarray(c[k]) for k in ("kown", "kcross", "mask")), jr


def _jax(c, impl):
    keys, jr = _jax_operands(c)
    return np.asarray(jax_lstm_from_keys(
        *keys, *(jnp.asarray(c[k]) for k in WEIGHTS), c["shift"],
        interpret=True, impl=impl, **jr))


def _operands(c):
    """The port's operands of a case: (kown, kcross, mask), [u, wi, wh,
    bh] and the root planes as keywords."""
    t = lambda x: torch.as_tensor(np.array(x))
    keys = (t(c["kown"].view(np.int32)), t(c["kcross"].view(np.int32)),
            t(c["mask"]))
    roots = {} if c["roots"] is None else dict(root_own=t(c["roots"][0]),
                                               root_cross=t(c["roots"][1]))
    return keys, [t(c[k]) for k in WEIGHTS], roots


def _port(c, fn=lstm_from_keys_plain):
    keys, ws, roots = _operands(c)
    return fn(*keys, *ws, c["shift"], **roots)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_t2_on_prefix_masks(case):
    c = _case(case)
    got = _port(c)
    assert got.shape == (CASES[case][1], B, H) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _jax(c, "t2"), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_t1_on_any_mask(case):
    """t1 takes any mask; t2's sort-and-skip would be wrong here. A row
    with no valid slot gives exactly 0, and a row valid only at its last
    slot gives one cell step from a zero carry."""
    c = _case(case, seed=1, holes=True)
    got = _port(c, lstm_from_keys)
    np.testing.assert_allclose(got.numpy(), _jax(c, "t1"), rtol=1e-5,
                               atol=1e-5)
    assert bool((got[0, 0] == 0).all())
    assert bool((got[0, 1] != 0).any())


def _cotangent(c, seed=2):
    q = c["kown"].shape[0]
    return np.random.default_rng(seed).normal(size=(q, B, H)).astype(
        np.float32)


def _jax_grads(c, impl, g):
    """jax.grad of sum(lstm_from_keys(...) * g) in u_ext, wi, wh, bh."""
    keys, jr = _jax_operands(c)

    def loss(*weights):
        return (jax_lstm_from_keys(*keys, *weights, c["shift"],
                                   interpret=True, impl=impl, **jr)
                * g).sum()

    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(c[k]) for k in WEIGHTS))
    return [np.asarray(x) for x in grads]


def _port_bwd(c, g):
    keys, ws, roots = _operands(c)
    return lstm_from_keys_bwd_plain(*keys, *ws, torch.as_tensor(g),
                                    c["shift"], **roots)


def _assert_grads(got, want, rtol, atol):
    for name, x, y in zip(WEIGHTS, got, want):
        assert tuple(x.shape) == y.shape and x.dtype == torch.float32, name
        np.testing.assert_allclose(x.numpy(), y, rtol=rtol, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_bwd_matches_jax_t2_on_prefix_masks(case):
    c = _case(case)
    g = _cotangent(c)
    got = _port_bwd(c, g)
    _assert_grads(got, _jax_grads(c, "t2", g), rtol=1e-4, atol=1e-5)
    ncol = c["u"].shape[0] - 2
    assert bool((got[0][ncol] == 0).all())       # the masking row


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_bwd_matches_jax_t1_on_any_mask(case):
    """Masks with holes, an empty row and a row valid only at its last
    slot: dh and dc pass through the masked slots."""
    c = _case(case, seed=1, holes=True)
    g = _cotangent(c, seed=3)
    _assert_grads(_port_bwd(c, g), _jax_grads(c, "t1", g), rtol=1e-4,
                  atol=1e-5)


@pytest.mark.parametrize("holes", [False, True], ids=["prefix", "holes"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_keys_lstm_grad_matches_autograd_of_plain(case, holes):
    """FusedKeysLSTM on the CPU (the plain BPTT) against torch's autograd
    through the plain forward's loop."""
    c = _case(case, seed=4, holes=holes)
    g = torch.as_tensor(_cotangent(c, seed=5))
    grads = []
    for fn in (lstm_from_keys, lstm_from_keys_plain):
        keys, ws, roots = _operands(c)
        for w in ws:
            w.requires_grad_()
        (fn(*keys, *ws, c["shift"], **roots) * g).sum().backward()
        grads.append([w.grad for w in ws])
    _assert_grads(grads[0], [x.numpy() for x in grads[1]], rtol=1e-5,
                  atol=1e-5)


def test_block_layout_mirrors_the_kernels():
    """csrc/lstm_keys.cuh fwd_layout_for: row groups of 16 rows (two warps
    each), 4 a block on the resident path at H = 96 (wh, 147,456 bytes,
    beside a ring of two of wi's k-steps, U, the bias and each group's h
    and x words), else as many groups as the state words (h twice, c, x)
    allow in 227 KB less 1 KB."""
    def lay(h, hh, ncol=None):
        got = block_layout(h, hh, ncol)
        return (got["nu"], got["nkx"], got["resident"], got["groups"],
                got["rows"], got["smem"])

    fixed = 147_456 + 2 * 12 * 1024 + 12 * 32 * 4
    per_group = 4 * 128 * (12 + 12)
    assert lay(96, 96, 4) == (12, 12, True, 4, 64,
                              fixed + 6 * 96 * 4 + 4 * per_group)
    assert lay(96, 96) == (12, 12, True, 4, 64, fixed + 4 * per_group)
    assert lay(96, 96, 8)[5] <= 232_448 - 1024
    assert lay(256, 256, 4) == (32, 32, False, 3, 48,
                                4 * (6 * 256 + 32 * 32
                                     + 3 * 128 * (3 * 32 + 32)))
    assert lay(256, 96, 4)[2:4] == (False, 4)     # x words crowd wh out
    assert lay(8, 8, 2)[:5] == (1, 1, False, 4, 64)
    assert lay(30, 40)[:4] == (5, 4, False, 4)


def test_row_order_is_by_last_valid_slot_longest_first():
    mask = torch.zeros(5, 6, dtype=torch.bool)
    mask[0, :2] = True
    mask[1, 4] = True           # a hole before its one valid slot
    mask[3, :5] = True
    mask[4, 1] = True
    assert row_order(mask).tolist() == [1, 3, 0, 4, 2]
    assert row_order(mask).dtype == torch.int32


def _jax_lstm_pair(fold, seed=3):
    """JAX's LSTMAggregation (its scan) and the port's, with the JAX
    weights carried across, on x [2, 3, L, H] with random masks."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 3, L, H)).astype(np.float32)
    mask = rng.random((2, 3, L)) < 0.7
    fw = None
    if fold:
        fw = (jnp.asarray(0.4 * rng.normal(size=(H, H)), jnp.float32),
              jnp.asarray(0.1 * rng.normal(size=(1, H)), jnp.float32))
    jmod = JaxLSTM(H, chunk=4)
    params = jmod.init(jax.random.PRNGKey(seed), x, mask, fold=fw)
    p = jax.tree.map(np.asarray, params["params"])
    p["bh"] = (0.2 * rng.normal(size=p["bh"].shape)).astype(np.float32)
    want = np.asarray(jmod.apply({"params": p}, x, mask, fold=fw))
    mod = LSTMAggregation(H)
    mod.load_state_dict({k: torch.as_tensor(np.array(v))
                         for k, v in p.items()})
    tfold = None if fw is None else tuple(torch.as_tensor(np.array(a))
                                          for a in fw)
    with torch.no_grad():
        got = mod(torch.as_tensor(x), torch.as_tensor(mask), fold=tfold)
    return got, want


@pytest.mark.parametrize("fold", [False, True], ids=["plain", "fold"])
def test_lstm_aggregation_matches_jax_scan(fold):
    got, want = _jax_lstm_pair(fold)
    assert got.shape == (2, 3, H) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_lstm_aggregation_init():
    gen = lambda: prng.prng_key(0)
    a, b = LSTMAggregation(H), LSTMAggregation(H)
    a.reset_parameters(gen())
    b.reset_parameters(gen())
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))
    assert a.wi.shape == (H, 4 * H) and a.wh.shape == (H, 4 * H)
    assert torch.all(a.bh == 0)
    t = LSTMAggregation(H, torch_init=True)
    t.reset_parameters(gen())
    bound = H ** -0.5
    for p in t.parameters():
        a = p.detach().abs()
        assert float(a.max()) <= bound and float(a.min()) > 0


# ------------------------------------------------------------ the Net
NET_H = 16


@pytest.fixture(scope="module", params=[(10, 3), (200, 4)],
                ids=["lo_only", "lead_in_hi"])
def joins(request):
    """JAX-sampled sets, one batch joined by JAX, the gathered rows for
    the port's join, and the LSTM Net's flax weights (with a nonzero
    LSTM bias)."""
    nw, ns = request.param
    g = rmat_graph(120, 500, seed=41)
    spgk = sample_gsets_device_keys(g, np.arange(120, dtype=np.int32),
                                    num_walks=nw, num_steps=ns, seed=3,
                                    block_size=64)
    edges = np.random.default_rng(42).integers(0, 120, size=(2, 12))
    jj = jax.jit(jax_make_keys_join(nw, ns))(
        spgk.nodes, spgk.khi, spgk.klo, spgk.sizes,
        jnp.asarray(edges, jnp.int32))
    c = lambda x: torch.as_tensor(np.array(x).view(np.int32))
    rows = [c(x)[torch.as_tensor(edges)] for x in (spgk.nodes, spgk.khi,
                                                   spgk.klo, spgk.sizes)]
    jnet = JaxNet(input_dim=ns + 1, hidden_dim=NET_H, aggrs="lstm",
                  dropout=0.0, key_layout=(nw, ns), fused_hidden=False)
    enc = jnp.zeros((1, 1), jnp.float32)
    params = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(0), enc,
                                                jj))
    bh = params["params"]["aggr"]["bh"]
    params["params"]["aggr"]["bh"] = np.random.default_rng(5).normal(
        scale=0.2, size=bh.shape).astype(np.float32)
    tspgk = SpGKeys(nodes=c(spgk.nodes), khi=c(spgk.khi), klo=c(spgk.klo),
                    sizes=c(spgk.sizes), num_walks=nw, num_steps=ns)
    return nw, ns, jj, rows, params, tspgk


def _jax_logits(joins, dtype, fused):
    nw, ns, jj, _, params, _ = joins
    jnet = JaxNet(input_dim=ns + 1, hidden_dim=NET_H, aggrs="lstm",
                  dropout=0.0, dtype=dtype, key_layout=(nw, ns),
                  fused_hidden=fused)
    return np.asarray(jnet.apply(params, jnp.zeros((1, 1), jnp.float32), jj))


def _port_net(joins, dtype, fused, queries=None):
    """The port's lstm Net with the fixture's weights and its join of the
    batch (of its first `queries` queries)."""
    nw, ns, _, rows, params, _ = joins
    net = Net(ns + 1, NET_H, aggrs="lstm", dropout=0.0, dtype=dtype,
              key_layout=(nw, ns), fused_hidden=fused,
              key=prng.prng_key(0), device="cpu")
    net.load_state_dict(params_from_flax(params))
    rows = [x[:, :queries] for x in rows]
    joined = join_gathered_keys(*rows, nw, ns,
                                **net.join_outputs(torch.device("cpu")))
    return net.eval(), joined


def test_lstm_net_routes_match_jax_unfused(joins):
    want = _jax_logits(joins, "float32", False)
    for fused in (True, False):
        net, joined = _port_net(joins, "float32", fused)
        with torch.no_grad():
            got = net(joined).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=f"fused={fused}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_lstm_net_matches_jax_fused(joins, dtype):
    """The port's fused route against JAX's (its keys-LSTM, impl t2, in
    interpret mode): both fold the projection and round wi_eff and the
    LSTM's output to the compute dtype."""
    tol = 1e-4 if dtype == "float32" else 3e-2
    net, joined = _port_net(joins, dtype, True)
    with torch.no_grad():
        got = net(joined).numpy()
    np.testing.assert_allclose(got, _jax_logits(joins, dtype, True),
                               rtol=tol, atol=tol)


def test_fused_lstm_route_reads_only_the_aligned_keys(joins):
    """The fused LSTM route's join carries the aligned keys but no
    feature pairs, and the route never forms the per-slot hidden rows."""
    nw, ns, _, rows, _, _ = joins
    cpu = torch.device("cpu")
    net = Net(ns + 1, NET_H, aggrs="lstm", key_layout=(nw, ns),
              fused_hidden=True, device="cpu",
              key=prng.prng_key(0))
    assert net.join_outputs(cpu) == dict(aligned=True, features=False)
    lean = join_gathered_keys(*rows, nw, ns, **net.join_outputs(cpu))
    assert lean.eidx is None and lean.kcross_al is not None

    def no_hidden(x):
        raise AssertionError("the fused lstm route formed hsum")

    net.pe_embedding.hidden = no_hidden
    with torch.no_grad():
        assert torch.isfinite(net.eval()(lean)).all()
    unfused = Net(ns + 1, NET_H, aggrs="lstm", fused_hidden=False,
                  key=prng.prng_key(0), device="cpu")
    assert unfused.join_outputs(cpu) == dict(aligned=True, features=True)


def test_keys_lstm_is_forward_only():
    """The keys-LSTM is differentiable (the name dates from when it was
    not): in u_ext, wi, wh and bh (the plain BPTT's gradients, bit for bit,
    on the CPU), not in the keys and the mask, and it gives the same
    output with grad mode off."""
    c = _case("lo_only-q2")
    keys, ws, _ = _operands(c)
    for w in ws:
        w.requires_grad_()
    out = lstm_from_keys(*keys, *ws, c["shift"])
    assert out.shape == (2, B, H) and out.requires_grad
    out.sum().backward()
    want = _port_bwd(c, np.ones((2, B, H), np.float32))
    for name, w, x in zip(WEIGHTS, ws, want):
        assert torch.equal(w.grad, x), name
        assert bool((w.grad != 0).any()), name
    assert not any(k.requires_grad for k in keys)
    with torch.no_grad():
        again = lstm_from_keys(*keys, *ws, c["shift"])
    assert torch.equal(again, out.detach())


def test_fused_lstm_net_raises_under_grad_and_unfused_trains(joins):
    """Both routes train (the name dates from when the fused one raised
    under grad): the same parameter gradients of the summed logits (fp32,
    dropout 0) on the batch's first 4 queries (the unfused route's plain
    scan costs the CPU about L^2 a row), and a fit on the fused route
    moves every parameter."""
    nw, ns, _, _, _, tspgk = joins
    grads = []
    for fused in (True, False):
        net, joined = _port_net(joins, "float32", fused, queries=4)
        net.train()(joined).sum().backward()
        grads.append({k: p.grad for k, p in net.named_parameters()})
    assert set(grads[0]) == set(grads[1])
    for k, want in grads[1].items():
        assert bool(torch.isfinite(grads[0][k]).all()), k
        np.testing.assert_allclose(grads[0][k].numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    assert bool((grads[0]["aggr.wh"] != 0).any())
    net, _ = _port_net(joins, "float32", True)
    start = {k: v.clone() for k, v in net.state_dict().items()}
    trainer = trainer_from_keys(net, tspgk, TrainConfig(batch_size=4))
    edges = torch.as_tensor(np.random.default_rng(6).integers(
        0, tspgk.nodes.shape[0], size=(2, 8)))
    losses, _ = trainer.fit(edges, torch.ones(8), 1, prng.prng_key(0))
    assert bool(torch.isfinite(losses).all())
    assert all(not torch.equal(v, start[k])
               for k, v in net.state_dict().items())


def test_cuda_wrapper_rejects_cpu_tensors():
    k = torch.zeros(2, 3, 4, dtype=torch.int32)
    w = torch.zeros(8, 32)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        lstm_from_keys_cuda(k, k, k.bool(), torch.zeros(6, 8), w, w,
                            torch.zeros(32), 4)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        lstm_from_keys_bwd_cuda(k, k, k.bool(), torch.zeros(6, 8), w, w,
                                torch.zeros(32), torch.zeros(2, 3, 8), 4)


def test_other_devices_raise():
    """No fallback: a device with no kernel and no plain route raises."""
    k = torch.zeros(2, 3, 4, dtype=torch.int32, device="meta")
    z = lambda *s: torch.zeros(*s, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        lstm_from_keys(k, k, k.bool(), z(6, 8), z(8, 32), z(8, 32), z(32), 4)
