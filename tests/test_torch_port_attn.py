"""PyTorch port, the fused attention pool and the attention Net.

The plain versions of the attention pool's forward and backward kernels
are held to the JAX package's `fused_attn_pool` in Pallas interpret mode
(as tests/test_pallas_hidden_sum.py runs it), both its monolithic route
and its slot-chunked one (`chunk=4`, the kernels the TPU needs at wide
shapes), in the lo-only and the lead-in-hi (root planes) layouts and at
Q=4. The attention Net's logits, on both of the port's routes, are held
to JAX's `Net(aggrs="attn", fused_hidden=False)` with the same weights.

Tolerances, with their reasons:
- forward: rtol = atol = 1e-5 (fp32 sums over the slots in other
  orders);
- gradients: rtol 1e-4, atol 1e-5 (sums of a few hundred products of
  counts up to 200 with cotangents of either sign). The gconst gradient
  is 0 in exact arithmetic (the softmax does not change when every gate
  of a set moves by the same amount), so both sides give rounding noise
  there: it is held to atol 1e-5 alone, as JAX's own test holds the gate
  bias (tests/test_pallas_hidden_sum.py:488-490);
- Net logits: rtol = atol = 1e-4 in fp32; 3e-2 in bf16, where the
  frameworks round to bf16 at different points and the fused route keeps
  fp32 up to the pooled rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surel_plus_tpu.graph.synthetic import rmat_graph
from surel_plus_tpu.models import Net as JaxNet
from surel_plus_tpu.ops.join import make_keys_join as jax_make_keys_join
from surel_plus_tpu.ops.pallas.hidden_sum_kernel import (
    fused_attn_pool as jax_fused_attn_pool,
)
from surel_plus_tpu.ops.sampler import sample_gsets_device_keys
from surel_plus_tpu_torch.convert import params_from_flax
from surel_plus_tpu_torch.models import Net
from surel_plus_tpu_torch.ops import prng
from surel_plus_tpu_torch.ops.join import join_gathered_keys
from surel_plus_tpu_torch.ops.kernels.attn_pool import (
    attn_slots_plain,
    attn_softmax_plain,
    fused_attn_pool,
    fused_attn_pool_bwd_cuda,
    fused_attn_pool_bwd_plain,
    fused_attn_pool_cuda,
    fused_attn_pool_plain,
)
from surel_plus_tpu_torch.ops.kernels.hidden_sum import NEG, u_core_rows
from surel_plus_tpu_torch.ops.walk import enc_field_layout
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

LAYOUTS = {"lo_only": (10, 3), "lead_in_hi": (200, 4)}
CASES = {"lo_only-q2": ("lo_only", 2), "lead_in_hi-q2": ("lead_in_hi", 2),
         "lo_only-q4": ("lo_only", 4)}
CHUNKS = {"monolithic": None, "chunked": 4}
B, L, H = 5, 11, 8


def _case(name, seed=0):
    """Random operands at Q, B=5, L=11, H=8: keys with every field used,
    random masks with at least one valid slot per set, and the root
    planes of the lead-in-hi layout."""
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
    mask = rng.random((q, B, L)) < 0.6
    mask[:, :, rng.integers(0, L)] = True
    w1 = rng.normal(size=(ns + 1, H)).astype(np.float32)
    b1 = (0.1 * rng.normal(size=H)).astype(np.float32)
    u = torch.cat([u_core_rows(torch.as_tensor(w1), nw, ns),
                   torch.full((1, H), NEG), torch.as_tensor(b1)[None]])
    gvec = (0.3 * rng.normal(size=(H, 1))).astype(np.float32)
    gconst = np.array([[0.3]], np.float32)
    roots = None
    if lead_bit == 32:
        roots = tuple(rng.integers(0, 2, size=(q, B, L)).astype(np.int32)
                      for _ in range(2))
    g = rng.normal(size=(q, B, H)).astype(np.float32)
    return dict(kown=kown, kcross=kcross, mask=mask, u=u.numpy(),
                gvec=gvec, gconst=gconst, roots=roots, g=g,
                shift=int(nw).bit_length())


def _jax_pool(c, chunk, u, gvec, gconst):
    jr = {} if c["roots"] is None else dict(
        root_own=jnp.asarray(c["roots"][0]),
        root_cross=jnp.asarray(c["roots"][1]))
    return jax_fused_attn_pool(
        jnp.asarray(c["kown"]), jnp.asarray(c["kcross"]),
        jnp.asarray(c["mask"]), u, gvec, gconst, c["shift"], chunk=chunk,
        interpret=True, **jr)


def _torch_args(c):
    t = lambda x: torch.as_tensor(np.array(x))
    args = (t(c["kown"].view(np.int32)), t(c["kcross"].view(np.int32)),
            t(c["mask"]))
    roots = {} if c["roots"] is None else dict(root_own=t(c["roots"][0]),
                                               root_cross=t(c["roots"][1]))
    return args, roots


def _gv(c):
    return torch.as_tensor(np.concatenate([c["gvec"], c["gconst"]]))


@pytest.mark.parametrize("chunk", sorted(CHUNKS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_forward_matches_jax(case, chunk):
    c = _case(case)
    want = np.asarray(_jax_pool(c, CHUNKS[chunk], jnp.asarray(c["u"]),
                                jnp.asarray(c["gvec"]),
                                jnp.asarray(c["gconst"])))
    args, roots = _torch_args(c)
    got, m, s = fused_attn_pool_plain(*args, torch.as_tensor(c["u"]),
                                      _gv(c), c["shift"], **roots)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert m.shape == s.shape == c["mask"].shape[:2]


@pytest.mark.parametrize("case", sorted(CASES))
def test_masked_slots_weigh_exactly_zero(case):
    """Masked slots keep a hidden row (their partner key is 0, so the
    cross side gives relu(b1)); only the NEG offset of the gate keeps
    them out, by an exactly zero weight."""
    c = _case(case)
    args, roots = _torch_args(c)
    *_, hs, gate = attn_slots_plain(*args, torch.as_tensor(c["u"]), _gv(c),
                                    c["shift"], **roots)
    a = attn_softmax_plain(gate)[0]
    masked = ~args[2]
    assert bool(masked.any()) and float(hs[masked].abs().sum()) > 0
    assert bool((a[masked] == 0).all())
    torch.testing.assert_close(a.sum(dim=-1), torch.ones(a.shape[:2]))


@pytest.mark.parametrize("chunk", sorted(CHUNKS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_jax_grad(case, chunk):
    c = _case(case, seed=1)

    def loss(u, gvec, gconst):
        return jnp.sum(_jax_pool(c, CHUNKS[chunk], u, gvec, gconst)
                       * jnp.asarray(c["g"]))

    want_u, want_gvec, want_gconst = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(c["u"]), jnp.asarray(c["gvec"]), jnp.asarray(c["gconst"]))
    args, roots = _torch_args(c)
    u, gv = torch.as_tensor(c["u"]), _gv(c)
    _, m, s = fused_attn_pool_plain(*args, u, gv, c["shift"], **roots)
    du, dgv = fused_attn_pool_bwd_plain(*args, u, gv, torch.as_tensor(c["g"]),
                                        m, s, c["shift"], **roots)
    assert du.shape == u.shape and dgv.shape == (H + 1, 1)
    np.testing.assert_allclose(du.numpy(), np.asarray(want_u), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(dgv[:H].numpy(), np.asarray(want_gvec),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dgv[H:].numpy(), np.asarray(want_gconst),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_function_gradient_matches_autograd_of_plain(case):
    c = _case(case, seed=2)
    args, roots = _torch_args(c)
    g = torch.as_tensor(c["g"])
    grads, outs = [], []
    for fused in (True, False):
        u = torch.as_tensor(c["u"]).requires_grad_()
        gvec = torch.as_tensor(c["gvec"]).requires_grad_()
        gconst = torch.as_tensor(c["gconst"]).requires_grad_()
        if fused:
            out = fused_attn_pool(*args, u, gvec, gconst, c["shift"], **roots)
        else:
            out = fused_attn_pool_plain(*args, u, torch.cat([gvec, gconst]),
                                        c["shift"], **roots)[0]
        (out * g).sum().backward()
        outs.append(out.detach())
        grads.append((u.grad, gvec.grad, gconst.grad))
    assert torch.equal(outs[0], outs[1])
    for got, want in zip(grads[0][:2], grads[1][:2]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(grads[0][2], grads[1][2], rtol=0, atol=1e-5)


def test_cuda_wrappers_reject_cpu_tensors():
    k = torch.zeros(2, 3, 4, dtype=torch.int32)
    u, gv = torch.zeros(6, 8), torch.zeros(9, 1)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        fused_attn_pool_cuda(k, k, k.bool(), u, gv, 7)
    m = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        fused_attn_pool_bwd_cuda(k, k, k.bool(), u, gv, torch.zeros(2, 3, 8),
                                 m, m, 7)


def test_other_devices_raise():
    """No fallback: a device with no kernel and no plain route raises."""
    k = torch.zeros(2, 3, 4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fused_attn_pool(k, k, k.bool(), torch.zeros(6, 8, device="meta"),
                        torch.zeros(8, 1, device="meta"),
                        torch.zeros(1, 1, device="meta"), 7)


# ------------------------------------------------------------ the Net
NET_H = 16


@pytest.fixture(scope="module", params=[(100, 3), (200, 4)],
                ids=["lo_only", "lead_in_hi"])
def joins(request):
    """JAX-sampled sets, and one batch joined by both packages."""
    nw, ns = request.param
    g = rmat_graph(120, 500, seed=41)
    spgk = sample_gsets_device_keys(g, np.arange(120, dtype=np.int32),
                                    num_walks=nw, num_steps=ns, seed=3,
                                    block_size=64)
    edges = np.random.default_rng(42).integers(0, 120, size=(2, 12))
    jj = jax.jit(jax_make_keys_join(nw, ns))(
        spgk.nodes, spgk.khi, spgk.klo, spgk.sizes,
        jnp.asarray(edges, jnp.int32))
    rows = [torch.as_tensor(np.array(x).view(np.int32))[
        torch.as_tensor(edges)] for x in (spgk.nodes, spgk.khi, spgk.klo,
                                          spgk.sizes)]
    return nw, ns, jj, rows


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attn_net_logits_match_jax(joins, dtype):
    nw, ns, jj, rows = joins
    jnet = JaxNet(input_dim=ns + 1, hidden_dim=NET_H, aggrs="attn",
                  dropout=0.0, dtype=dtype, key_layout=(nw, ns),
                  fused_hidden=False)
    enc = jnp.zeros((1, 1), jnp.float32)
    params = jnet.init(jax.random.PRNGKey(0), enc, jj)
    want = np.asarray(jnet.apply(params, enc, jj))
    state = params_from_flax(jax.tree.map(np.asarray, params))
    assert "aggr.gate_nn.weight" in state and "aggr.value_nn.bias" in state
    tol = 1e-4 if dtype == "float32" else 3e-2
    for fused in (True, False):
        net = Net(ns + 1, NET_H, aggrs="attn", dropout=0.0, dtype=dtype,
                  key_layout=(nw, ns), fused_hidden=fused,
                  key=prng.prng_key(0), device="cpu")
        net.load_state_dict(state)
        joined = join_gathered_keys(*rows, nw, ns,
                                    **net.join_outputs(torch.device("cpu")))
        with torch.no_grad():
            got = net.eval()(joined).numpy()
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                   err_msg=f"fused={fused}")


def test_fused_attn_route_reads_only_the_aligned_keys(joins):
    """The fused attention route's join carries the aligned keys but no
    feature pairs, and the route never forms the per-slot hidden rows;
    the fused mean route's join has no aligned outputs at all."""
    nw, ns, jj, rows = joins
    cpu = torch.device("cpu")
    net = Net(ns + 1, NET_H, aggrs="attn", key_layout=(nw, ns),
              fused_hidden=True, device="cpu",
              key=prng.prng_key(0))
    assert net.join_outputs(cpu) == dict(aligned=True, features=False)
    lean = join_gathered_keys(*rows, nw, ns, **net.join_outputs(cpu))
    full = join_gathered_keys(*rows, nw, ns)
    assert lean.eidx is None and full.eidx is not None
    for name in full._fields:
        if name != "eidx" and getattr(full, name) is not None:
            assert torch.equal(getattr(lean, name), getattr(full, name)), name

    def no_hidden(x):
        raise AssertionError("the fused attention route formed hsum")

    net.pe_embedding.hidden = no_hidden
    with torch.no_grad():
        assert torch.isfinite(net.eval()(lean)).all()
    mean = Net(ns + 1, NET_H, fused_hidden=True,
               key=prng.prng_key(0), device="cpu")
    assert mean.join_outputs(cpu) == dict(aligned=False)
    unfused = Net(ns + 1, NET_H, aggrs="attn", fused_hidden=False,
                  key=prng.prng_key(0), device="cpu")
    assert unfused.join_outputs(cpu) == dict(aligned=True, features=True)
