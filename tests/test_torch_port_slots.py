"""PyTorch port, the per-slot hidden rows from the packed keys
(`fused_key_hidden_slots`, K7 and K7 bwd on the card): the plain forward
and backward against the JAX package's `fused_key_hidden_slots` (its
`_slots_fwd_kernel` and `_slots_bwd_kernel`, in Pallas interpret mode)
and its VJP, the autograd Function against torch's autograd of the plain
forward, and the unfused keys route of the Net (the hidden rows from the
aligned keys, no feature pairs) against the JAX Net's unfused route, in
the lo-only and the lead-in-hi key layouts.

Tolerances, with their reasons:
- forward, fp32: rtol = atol = 1e-5 (the same fp32 terms, summed in
  another order); bf16 output: within one bf16 rounding, rtol 2^-7
  (both round an fp32 sum once, and sums a rounding apart may round to
  neighbouring bf16 values) with atol 1e-5;
- backward against JAX: within 1e-4 of each dU row's largest entry (sums
  over every slot of both sides in other orders), the masking row
  exactly 0; against torch's autograd of the plain forward: rtol 1e-5,
  atol 1e-6 of the largest entry; the plain backward as the Function's
  backward on the CPU: bit for bit;
- `gradcheck` in float64 at its default tolerances;
- the Net's logits: rtol = atol = 1e-4 in fp32 and 5e-2 in bf16 (the
  JAX route rounds each side's hidden row to bf16 and sums in bf16, the
  port sums in fp32 and rounds once); one training step's loss at rtol
  1e-5, its gradients at rtol 1e-4, atol 1e-6 (fp32, dropout 0), as
  tests/test_torch_port_train.py holds the other routes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from surel_plus_tpu.graph.synthetic import rmat_graph
from surel_plus_tpu.models import Net as JaxNet
from surel_plus_tpu.ops.join import make_keys_join as jax_make_keys_join
from surel_plus_tpu.ops.pallas.hidden_sum_kernel import (
    fused_key_hidden_slots as jax_fused_key_hidden_slots,
)
from surel_plus_tpu.ops.sampler import sample_gsets_device_keys
from surel_plus_tpu.ops.walk import enc_field_layout
from surel_plus_tpu_torch.convert import params_from_flax
from surel_plus_tpu_torch.models import Net
from surel_plus_tpu_torch.ops import prng
from surel_plus_tpu_torch.ops.join import make_keys_join
from surel_plus_tpu_torch.ops.kernels.hidden_sum import (
    NEG,
    FusedKeyHiddenSlots,
    fused_key_hidden_slots,
    fused_key_hidden_slots_bwd_cuda,
    fused_key_hidden_slots_bwd_plain,
    fused_key_hidden_slots_cuda,
    fused_key_hidden_slots_plain,
    u_core_rows,
)
from surel_plus_tpu_torch.train.device import batch_loss
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

# (num_walks, num_steps): lo-only (3 fields of 4 bits and the root bit in
# the lo word) and lead-in-hi (4 fields of 8 bits fill the lo word, the
# root comes from a plane)
LAYOUTS = {"lo_only": (10, 3), "lead_in_hi": (200, 4)}
# (Q, B, L, H): odd B and L, and Q=4
SHAPES = {"odd": (2, 5, 11, 16), "q4": (4, 3, 7, 16)}
BF16_RTOL = 2.0 ** -7
AGGRS = ("attn", "lstm", "mean")
NET_H, N_NODES = 16, 120


def _rand_keys(rng, shape, nw, ns):
    """Random keys covering every field plus the root bit in the lo word
    (tests/test_pallas_hidden_sum.py:_rand_keys), about a fifth of them
    0 (an absent partner, a padded slot)."""
    shift, starts, lead_bit = enc_field_layout(nw, ns)
    k = np.zeros(shape, np.uint32)
    for j in range(1, ns + 1):
        k |= rng.integers(0, nw + 1, size=shape).astype(
            np.uint32) << np.uint32(starts[j])
    if lead_bit < 32:
        k |= rng.integers(0, 2, size=shape).astype(np.uint32) << np.uint32(
            lead_bit)
    k[rng.random(shape) < 0.2] = 0
    return k


def _operands(layout, shape, seed):
    """(kown, kcross_al, w1, b1, roots) as numpy: uint32 keys [Q, B, L],
    and int32 0/1 root planes in the lead-in-hi layout, else None."""
    nw, ns = LAYOUTS[layout]
    q, b, ell, h = SHAPES[shape]
    rng = np.random.default_rng(seed)
    kown = _rand_keys(rng, (q, b, ell), nw, ns)
    kc = _rand_keys(rng, (q, b, ell), nw, ns)
    w1 = rng.normal(size=(ns + 1, h)).astype(np.float32)
    b1 = rng.normal(size=(h,)).astype(np.float32)
    roots = None
    if enc_field_layout(nw, ns)[2] == 32:
        # a slot with key 0 is no root (as in a join)
        roots = tuple(np.where(k == 0, 0, rng.integers(
            0, 2, size=(q, b, ell))).astype(np.int32) for k in (kown, kc))
    return kown, kc, w1, b1, roots


def _u_ext(w1, b1, nw, ns):
    return torch.cat([u_core_rows(torch.as_tensor(w1), nw, ns),
                      torch.full((1, w1.shape[1]), NEG),
                      torch.as_tensor(b1)[None]])


def _jax_args(kown, kc, roots):
    jr = {} if roots is None else dict(root_own=jnp.asarray(roots[0]),
                                       root_cross=jnp.asarray(roots[1]))
    return jnp.asarray(kown), jnp.asarray(kc), jr


def _torch_args(kown, kc, roots):
    t = lambda x: torch.as_tensor(np.array(x))
    tr = {} if roots is None else dict(root_own=t(roots[0]),
                                       root_cross=t(roots[1]))
    return t(kown.view(np.int32)), t(kc.view(np.int32)), tr


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_plain_matches_jax_forward(layout, shape, dtype):
    nw, ns = LAYOUTS[layout]
    kown, kc, w1, b1, roots = _operands(layout, shape, seed=1)
    shift = int(nw).bit_length()
    u = _u_ext(w1, b1, nw, ns)
    jk, jc, jr = _jax_args(kown, kc, roots)
    want = np.asarray(jax_fused_key_hidden_slots(
        jk, jc, jnp.asarray(u.numpy()), shift,
        out_dtype=getattr(jnp, dtype), interpret=True,
        **jr).astype(jnp.float32))
    tk, tc, tr = _torch_args(kown, kc, roots)
    out = fused_key_hidden_slots_plain(tk, tc, u, shift,
                                       getattr(torch, dtype), **tr)
    assert out.dtype == getattr(torch, dtype)
    assert out.shape == SHAPES[shape]
    rtol = 1e-5 if dtype == "float32" else BF16_RTOL
    np.testing.assert_allclose(out.float().numpy(), want, rtol=rtol,
                               atol=1e-5)
    # a slot whose keys are both 0 gives 2 relu(b1)
    both0 = torch.as_tensor((kown == 0) & (kc == 0))
    if roots is not None:
        both0 &= (tr["root_own"] == 0) & (tr["root_cross"] == 0)
    assert bool(both0.any())
    two_b1 = (2 * torch.relu(torch.as_tensor(b1))).to(out.dtype)
    assert torch.equal(out[both0], two_b1.expand(int(both0.sum()), -1))


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_plain_backward_matches_jax_vjp(layout, shape):
    nw, ns = LAYOUTS[layout]
    kown, kc, w1, b1, roots = _operands(layout, shape, seed=2)
    shift = int(nw).bit_length()
    u = _u_ext(w1, b1, nw, ns)
    g = np.random.default_rng(3).normal(size=SHAPES[shape]).astype(
        np.float32)
    jk, jc, jr = _jax_args(kown, kc, roots)
    _, vjp = jax.vjp(lambda uj: jax_fused_key_hidden_slots(
        jk, jc, uj, shift, interpret=True, **jr), jnp.asarray(u.numpy()))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    tk, tc, tr = _torch_args(kown, kc, roots)
    got = fused_key_hidden_slots_bwd_plain(tk, tc, u, torch.as_tensor(g),
                                           shift, **tr).numpy()
    assert got.shape == (ns + 3, SHAPES[shape][3])
    assert got.dtype == np.float32
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert np.all(np.abs(got - want) <= 1e-4 * scale)
    np.testing.assert_array_equal(got[ns + 1], 0.0)   # the masking row
    np.testing.assert_array_equal(want[ns + 1], 0.0)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_function_matches_autograd_of_plain(layout):
    """On the CPU `fused_key_hidden_slots` is the plain forward and the
    plain backward: its output and gradient are theirs bit for bit, and
    the gradient is torch's autograd of the plain forward's within
    1e-6 of its largest entry."""
    nw, ns = LAYOUTS[layout]
    kown, kc, w1, b1, roots = _operands(layout, "odd", seed=4)
    shift = int(nw).bit_length()
    tk, tc, tr = _torch_args(kown, kc, roots)
    g = torch.as_tensor(np.random.default_rng(5).normal(
        size=SHAPES["odd"]).astype(np.float32))
    outs, grads = [], []
    for fn in (fused_key_hidden_slots, fused_key_hidden_slots_plain):
        u = _u_ext(w1, b1, nw, ns).requires_grad_()
        out = fn(tk, tc, u, shift, **tr)
        (out * g).sum().backward()
        outs.append(out.detach())
        grads.append(u.grad)
    assert torch.equal(outs[0], outs[1])
    direct = fused_key_hidden_slots_bwd_plain(
        tk, tc, _u_ext(w1, b1, nw, ns), g, shift, **tr)
    assert torch.equal(grads[0], direct)
    scale = float(grads[1].abs().max())
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(),
                               rtol=1e-5, atol=1e-6 * scale)


def test_gradcheck_float64():
    kown, kc, w1, b1, roots = _operands("lead_in_hi", "q4", seed=6)
    tk, tc, tr = _torch_args(kown, kc, roots)
    u = _u_ext(w1, b1, 200, 4).double().requires_grad_()
    f64 = lambda u: FusedKeyHiddenSlots.apply(
        tk, tc, u, 8, torch.float64, tr["root_own"], tr["root_cross"])
    assert torch.autograd.gradcheck(f64, (u,))


def test_cuda_wrappers_reject_cpu_tensors():
    k = torch.zeros(2, 3, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        fused_key_hidden_slots_cuda(k, k, torch.zeros(6, 8), 4)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        fused_key_hidden_slots_bwd_cuda(k, k, torch.zeros(6, 8),
                                        torch.zeros(2, 3, 4, 8), 4)


def test_other_devices_raise():
    """No fallback: a device with no kernel and no plain route raises."""
    k = torch.zeros(2, 3, 4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fused_key_hidden_slots(k, k, torch.zeros(6, 8, device="meta"), 4)


# ------------------------------------------------------------ the Net
@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def sampled(request):
    """JAX-sampled sets and one batch of 16 query edges (the last three
    weigh 0 in the loss), joined by JAX, and the port's rows."""
    nw, ns = LAYOUTS[request.param]
    g = rmat_graph(N_NODES, 500, seed=41)
    spgk = sample_gsets_device_keys(g, np.arange(N_NODES, dtype=np.int32),
                                    num_walks=nw, num_steps=ns, seed=3,
                                    block_size=64)
    edges = np.random.default_rng(42).integers(0, N_NODES, size=(2, 16))
    jj = jax.jit(jax_make_keys_join(nw, ns))(
        spgk.nodes, spgk.khi, spgk.klo, spgk.sizes,
        jnp.asarray(edges, jnp.int32))
    c = lambda x: torch.as_tensor(np.array(x).view(np.int32))
    rows = (c(spgk.nodes), c(spgk.khi), c(spgk.klo), c(spgk.sizes),
            torch.as_tensor(edges))
    return nw, ns, jj, rows


def _jax_net(sampled, aggrs, dtype="float32"):
    nw, ns, jj, _ = sampled
    jnet = JaxNet(input_dim=ns + 1, hidden_dim=NET_H, aggrs=aggrs,
                  dropout=0.0, dtype=dtype, key_layout=(nw, ns),
                  fused_hidden=False)
    enc = jnp.zeros((1, 1), jnp.float32)
    params = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(4), enc,
                                                jj))
    return jnet, enc, params


def _keys_route(sampled, aggrs, params, dtype="float32"):
    """The port's unfused Net over a join with the aligned keys and no
    feature pairs: the route that forms hsum from the keys."""
    nw, ns, _, rows = sampled
    net = Net(ns + 1, NET_H, aggrs=aggrs, dropout=0.0, dtype=dtype,
              key_layout=(nw, ns), fused_hidden=False,
              key=prng.prng_key(0), device="cpu")
    net.load_state_dict(params_from_flax(params))
    joined = make_keys_join(nw, ns, aligned=True, features=False)(*rows)
    assert joined.eidx is None and joined.kcross_al is not None
    return net, joined


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("aggrs", AGGRS)
def test_keys_route_logits_match_jax_unfused(sampled, aggrs, dtype):
    jnet, enc, params = _jax_net(sampled, aggrs, dtype)
    want = np.asarray(jnet.apply(params, enc, sampled[2]))
    net, joined = _keys_route(sampled, aggrs, params, dtype)
    with torch.no_grad():
        got = net.eval()(joined).numpy()
    tol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("aggrs", AGGRS)
def test_keys_route_train_step_matches_jax(sampled, aggrs):
    """One step's loss and parameter gradients of the keys route against
    the JAX Net's unfused route (fp32, dropout 0)."""
    jnet, enc, params = _jax_net(sampled, aggrs)
    rng = np.random.default_rng(32)
    labels = (rng.random(16) < 0.5).astype(np.float32)
    w = np.ones(16, np.float32)
    w[-3:] = 0.0

    def loss_fn(p):
        logits = jnet.apply(p, enc, sampled[2], train=True)
        per = optax.sigmoid_binary_cross_entropy(logits, labels)
        return (per * w).sum() / jnp.maximum(w.sum(), 1.0)

    want_loss, want_grads = jax.value_and_grad(loss_fn)(params)
    want = params_from_flax(jax.tree.map(np.asarray, want_grads))
    net, joined = _keys_route(sampled, aggrs, params)
    loss = batch_loss(net.train()(joined), torch.as_tensor(labels),
                      torch.as_tensor(w))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got = {n: p.grad.numpy() for n, p in net.named_parameters()}
    assert set(got) == set(want)
    for name, gw in want.items():
        atol = 1e-5 if name == "aggr.gate_nn.bias" else 1e-6
        rtol = 0.0 if name == "aggr.gate_nn.bias" else 1e-4
        np.testing.assert_allclose(got[name], gw.numpy(), rtol=rtol,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("aggrs", AGGRS)
def test_join_outputs_of_the_unfused_route(aggrs):
    """The unfused route asks for the aligned keys without feature pairs
    on CUDA (K7 forms the hidden rows) and for the feature pairs on the
    CPU (the JAX package's XLA route); the default route is the unfused
    one on the CPU and the fused one on CUDA."""
    net = Net(4, NET_H, aggrs=aggrs, fused_hidden=False,
              key=prng.prng_key(0), device="cpu")
    assert net.join_outputs(torch.device("cuda")) == dict(aligned=True,
                                                          features=False)
    assert net.join_outputs(torch.device("cpu")) == dict(aligned=True,
                                                         features=True)
    default = Net(4, NET_H, aggrs=aggrs, key=prng.prng_key(0), device="cpu")
    assert default.join_outputs(torch.device("cpu")) == dict(aligned=True,
                                                             features=True)
    assert default.fused_on(torch.device("cuda"))
    assert not default.fused_on(torch.device("cpu"))


def test_keys_route_equals_feature_route(sampled):
    """On one set of weights the keys route and the feature-pair route
    give the same logits (fp32, 1e-5), and the keys route needs the key
    layout."""
    nw, ns, _, rows = sampled
    net = Net(ns + 1, NET_H, aggrs="attn", dropout=0.0, fused_hidden=False,
              key_layout=(nw, ns), device="cpu",
              key=prng.prng_key(0)).eval()
    pairs = make_keys_join(nw, ns, aligned=True, features=True)(*rows)
    keys = make_keys_join(nw, ns, aligned=True, features=False)(*rows)
    with torch.no_grad():
        np.testing.assert_allclose(net(keys).numpy(), net(pairs).numpy(),
                                   rtol=1e-5, atol=1e-5)
        net.key_layout = None
        with pytest.raises(ValueError, match="key_layout"):
            net(keys)
