"""PyTorch port, the fused key hidden set sum: the plain versions of the
forward and backward kernels held to the JAX Pallas kernel in interpret
mode (the method of tests/test_pallas_hidden_sum.py; the backward against
jax.grad through its custom VJP), with and without root planes, including
an all-masked set, at Q=2 and Q=4. Tolerance: fp32, rtol 1e-5, atol 1e-5
for the forward (the two sum the same fp32 terms in different orders);
for dU, rtol 1e-5 and atol 1e-6 of the largest |dU| (sums of a few
thousand products of counts up to 200 with cotangents of either sign)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surel_plus_tpu.ops.pallas.hidden_sum_kernel import NEG as JAX_NEG
from surel_plus_tpu.ops.pallas.hidden_sum_kernel import (
    fused_key_hidden_sum as jax_fused_key_hidden_sum,
)
from surel_plus_tpu.ops.pallas.hidden_sum_kernel import (
    u_core_rows as jax_u_core_rows,
)
from surel_plus_tpu.ops.walk import enc_field_layout
from surel_plus_tpu_torch.ops.kernels.hidden_sum import (
    NEG,
    fused_key_hidden_sum,
    fused_key_hidden_sum_bwd_cuda,
    fused_key_hidden_sum_bwd_plain,
    fused_key_hidden_sum_cuda,
    fused_key_hidden_sum_plain,
    u_core_rows,
)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

# (num_walks, num_steps): lo-only fields + root bit, and lead-in-hi
# (4 fields filling the lo word, root from a plane)
LAYOUTS = {"lo_only": (10, 3), "lead_in_hi": (200, 4)}


def _rand_keys(rng, shape, nw, ns):
    shift, starts, lead_bit = enc_field_layout(nw, ns)
    k = np.zeros(shape, np.uint32)
    for j in range(1, ns + 1):
        k |= rng.integers(0, nw + 1, size=shape).astype(
            np.uint32) << np.uint32(starts[j])
    if lead_bit < 32:
        k |= rng.integers(0, 2, size=shape).astype(np.uint32) << np.uint32(
            lead_bit)
    return k


def _case(rng, nw, ns, Q, B, L, Lc, H, shared_cross=False):
    """Random operands. A join puts each cross slot in at most one
    endpoint's selection; `shared_cross` lets endpoints share slots, as
    the kernels allow."""
    kown = _rand_keys(rng, (Q, B, L), nw, ns)
    kcross = _rand_keys(rng, (B, Lc), nw, ns)
    mask = rng.random((Q, B, L)) < 0.7
    mask[:, 0] = False                      # set 0: all masked ...
    if shared_cross:
        mc = rng.random((Q, B, Lc)) < 0.5
        mc[:, 0] = False
    else:
        pick = rng.integers(0, Q + 1, size=(B, Lc))
        pick[0] = Q                         # ... and selects no cross slot
        mc = np.stack([pick == qi for qi in range(Q)])
    w1 = rng.normal(size=(ns + 1, H)).astype(np.float32)
    b1 = rng.normal(size=(H,)).astype(np.float32)
    roots = None
    if enc_field_layout(nw, ns)[2] == 32:
        roots = (rng.integers(0, 2, size=(Q, B, L)).astype(np.int32),
                 rng.integers(0, 2, size=(B, Lc)).astype(np.int32))
    return kown, mask, kcross, mc, w1, b1, roots


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_plain_matches_jax_kernel(layout):
    nw, ns = LAYOUTS[layout]
    rng = np.random.default_rng(1)
    kown, mask, kcross, mc, w1, b1, roots = _case(rng, nw, ns, 2, 11, 19,
                                                  38, 16)
    shift = int(nw).bit_length()
    ju = jnp.concatenate([jax_u_core_rows(jnp.asarray(w1), nw, ns),
                          jnp.full((1, 16), JAX_NEG, jnp.float32),
                          jnp.asarray(b1)[None]], axis=0)
    jr = {} if roots is None else dict(root_own=jnp.asarray(roots[0]),
                                       root_cross=jnp.asarray(roots[1]))
    want = np.asarray(jax_fused_key_hidden_sum(
        jnp.asarray(kown), jnp.asarray(mask), jnp.asarray(kcross),
        jnp.asarray(mc), ju, shift, interpret=True, **jr))

    t = lambda x: torch.as_tensor(np.array(x))
    tu = torch.cat([u_core_rows(t(w1), nw, ns),
                    torch.full((1, 16), NEG), t(b1)[None]])
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    tr = {} if roots is None else dict(root_own=t(roots[0]),
                                       root_cross=t(roots[1]))
    got = fused_key_hidden_sum(t(kown.view(np.int32)), t(mask),
                               t(kcross.view(np.int32)), t(mc), tu, shift,
                               **tr).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[:, 0], 0.0)   # the all-masked set


def test_cuda_wrapper_rejects_cpu_tensors():
    k = torch.zeros(2, 3, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        fused_key_hidden_sum_cuda(k, k.bool(), k[0], k.bool(),
                                  torch.zeros(6, 8), 7)


def _u_ext(w1, b1, nw, ns):
    t = torch.as_tensor(w1)
    return torch.cat([u_core_rows(t, nw, ns),
                      torch.full((1, w1.shape[1]), NEG),
                      torch.as_tensor(b1)[None]])


def _torch_args(kown, mask, kcross, mc, roots):
    t = lambda x: torch.as_tensor(np.array(x))
    return ((t(kown.view(np.int32)), t(mask), t(kcross.view(np.int32)),
             t(mc)),
            {} if roots is None else dict(root_own=t(roots[0]),
                                          root_cross=t(roots[1])))


def _assert_du_close(got, want):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale)


@pytest.mark.parametrize("q", [2, 4])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_plain_backward_matches_jax_grad(layout, q):
    nw, ns = LAYOUTS[layout]
    rng = np.random.default_rng(2 + q)
    H = 16
    kown, mask, kcross, mc, w1, b1, roots = _case(
        rng, nw, ns, q, 9, 19, 38, H, shared_cross=True)
    g = rng.normal(size=(q, 9, H)).astype(np.float32)
    shift = int(nw).bit_length()
    u = _u_ext(w1, b1, nw, ns)
    jr = {} if roots is None else dict(root_own=jnp.asarray(roots[0]),
                                       root_cross=jnp.asarray(roots[1]))

    def loss(uj):
        out = jax_fused_key_hidden_sum(
            jnp.asarray(kown), jnp.asarray(mask), jnp.asarray(kcross),
            jnp.asarray(mc), uj, shift, interpret=True, **jr)
        return jnp.sum(out * jnp.asarray(g))

    want = np.asarray(jax.grad(loss)(jnp.asarray(u.numpy())))
    args, tr = _torch_args(kown, mask, kcross, mc, roots)
    got = fused_key_hidden_sum_bwd_plain(*args, u, torch.as_tensor(g),
                                         shift, **tr).numpy()
    assert got.shape == (ns + 3, H) and got.dtype == np.float32
    _assert_du_close(got, want)
    np.testing.assert_array_equal(got[ns + 1], 0.0)   # the masking row
    # the all-masked set contributes nothing: its cotangent is irrelevant
    g0 = g.copy()
    g0[:, 0] = 1e3
    got0 = fused_key_hidden_sum_bwd_plain(*args, u, torch.as_tensor(g0),
                                          shift, **tr).numpy()
    _assert_du_close(got0, want)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_function_gradient_matches_autograd_of_plain(layout):
    nw, ns = LAYOUTS[layout]
    rng = np.random.default_rng(7)
    kown, mask, kcross, mc, w1, b1, roots = _case(rng, nw, ns, 2, 7, 15,
                                                  30, 12)
    g = torch.as_tensor(rng.normal(size=(2, 7, 12)).astype(np.float32))
    shift = int(nw).bit_length()
    args, tr = _torch_args(kown, mask, kcross, mc, roots)
    grads = []
    for fn in (fused_key_hidden_sum, fused_key_hidden_sum_plain):
        u = _u_ext(w1, b1, nw, ns).requires_grad_()
        out = fn(*args, u, shift, **tr)
        (out * g).sum().backward()
        grads.append(u.grad.numpy())
    _assert_du_close(grads[0], grads[1])
    # the Function's forward is the plain forward on CPU tensors
    with torch.no_grad():
        u = _u_ext(w1, b1, nw, ns)
        np.testing.assert_array_equal(
            fused_key_hidden_sum(*args, u, shift, **tr).numpy(),
            fused_key_hidden_sum_plain(*args, u, shift, **tr).numpy())


def test_cuda_backward_rejects_cpu_tensors():
    k = torch.zeros(2, 3, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        fused_key_hidden_sum_bwd_cuda(k, k.bool(), k[0], k.bool(),
                                      torch.zeros(6, 8),
                                      torch.zeros(2, 3, 8), 7)
