"""PyTorch port, the masked LSTM over given rows, backward: the plain BPTT
beside K5 bwd (`lstm_final_hidden_bwd_plain`) against `jax.grad` of the
JAX package's `lstm_final_hidden` (its `_lstm_bwd_kernel`, in Pallas
interpret mode), and the autograd Function `FinalHiddenLSTM` around K5
and K5 bwd against torch's autograd of the plain forward.

Tolerances, with their reasons:
- against JAX: rtol 1e-4, atol 1e-5, as JAX's own test holds its kernel's
  VJP to its scan's (tests/test_pallas_hidden_sum.py:318-350: sums over
  every row and slot, and back through the recurrence, in other orders);
- against torch's autograd of the same plain forward: rtol = atol = 1e-5
  (the same formulas, other summation orders); the plain pair as the
  Function's backward on the CPU: bit for bit;
- `gradcheck` in float64 at its default tolerances;
- dx at masked slots and every gradient of an empty row: exactly 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surel_plus_tpu.ops.pallas.lstm_kernel import (
    lstm_final_hidden as jax_lstm_final_hidden,
)
from surel_plus_tpu_torch.ops.kernels.lstm import (
    FinalHiddenLSTM,
    lstm_final_hidden,
    lstm_final_hidden_bwd_cuda,
    lstm_final_hidden_bwd_plain,
    lstm_final_hidden_plain,
)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, L, h, H = 9, 23, 6, 8
GRADS = ("dx", "dwi", "dwh", "dbh")


def _operands(holes, seed=8):
    """x [9, 23, 6], the mask, wi [6, 32], wh [8, 32], bh [32] and the
    cotangent g [9, 8]: prefix masks of random sizes >= 1, or, with
    `holes`, random masks with row 0 empty and row 1 valid only at its
    last slot."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, h)).astype(np.float32)
    if holes:
        mask = rng.random((B, L)) < 0.6
        mask[0] = False
        mask[1] = False
        mask[1, -1] = True
    else:
        sizes = rng.integers(1, L + 1, size=B)
        mask = np.arange(L)[None, :] < sizes[:, None]
    w = lambda *s: (0.4 * rng.normal(size=s)).astype(np.float32)
    g = rng.normal(size=(B, H)).astype(np.float32)
    return (x, mask, w(h, 4 * H), w(H, 4 * H), w(4 * H)), g


@pytest.mark.parametrize("holes", [False, True], ids=["prefix", "holes"])
def test_bwd_plain_matches_jax_grad(holes):
    ops, g = _operands(holes)
    x, mask, wi, wh, bh = map(jnp.asarray, ops)

    def loss(x, wi, wh, bh):
        return (jax_lstm_final_hidden(x, mask, wi, wh, bh, chunk=4,
                                      interpret=True) * g).sum()

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(x, wi, wh, bh)
    got = lstm_final_hidden_bwd_plain(*map(torch.as_tensor, ops),
                                      torch.as_tensor(g))
    for name, a, b in zip(GRADS, got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("holes", [False, True], ids=["prefix", "holes"])
def test_function_matches_autograd_of_plain(holes):
    """On the CPU `lstm_final_hidden` is the plain forward and the plain
    BPTT: its gradients are `lstm_final_hidden_bwd_plain`'s bit for bit
    and torch's autograd of the plain forward's within 1e-5."""
    ops, g = _operands(holes)
    g = torch.as_tensor(g)

    def grads(fn):
        ts = [torch.as_tensor(a) for a in ops]
        for i in (0, 2, 3, 4):
            ts[i].requires_grad_()
        out = fn(*ts)
        (out * g).sum().backward()
        return out.detach(), [ts[i].grad for i in (0, 2, 3, 4)]

    out, got = grads(lstm_final_hidden)
    ref_out, ref = grads(lstm_final_hidden_plain)
    assert torch.equal(out, ref_out)
    direct = lstm_final_hidden_bwd_plain(*map(torch.as_tensor, ops), g)
    for name, a, b, c in zip(GRADS, got, ref, direct):
        assert torch.equal(a, c), name
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_gradcheck_float64():
    """The Function in float64 on 4 rows of 7 slots (row 0 empty, row 1
    valid at its last slot only, row 2 full)."""
    ops, _ = _operands(True, seed=3)
    x, mask, wi, wh, bh = (torch.as_tensor(a) for a in ops)
    x = x[:4, :7].contiguous()
    mask = mask[:4, :7].clone()
    mask[1, -1] = True
    mask[2] = True
    leaves = [t.double().requires_grad_() for t in (x, wi, wh, bh)]
    f64 = lambda x, wi, wh, bh: FinalHiddenLSTM.apply(x, mask, wi, wh, bh)
    assert torch.autograd.gradcheck(f64, leaves)


def test_nothing_flows_where_nothing_is_valid():
    """dx is exactly 0 at masked slots; an empty row gives no gradient to
    anything (a huge cotangent there changes no bit)."""
    ops, g = _operands(True)
    ts = [torch.as_tensor(a) for a in ops]
    mask = ts[1]
    dx, dwi, dwh, dbh = lstm_final_hidden_bwd_plain(*ts, torch.as_tensor(g))
    assert bool((dx[~mask] == 0).all())
    assert bool((dx[mask] != 0).any())
    assert bool((dx[0] == 0).all())                 # row 0 is empty
    loud = torch.as_tensor(g).clone()
    loud[0] = 1e3
    again = lstm_final_hidden_bwd_plain(*ts, loud)
    for name, a, b in zip(GRADS, (dx, dwi, dwh, dbh), again):
        assert torch.equal(a, b), name


def test_bwd_cuda_wrapper_rejects_cpu_tensors():
    ops, g = _operands(False)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        lstm_final_hidden_bwd_cuda(*map(torch.as_tensor, ops),
                                   torch.as_tensor(g))


def test_backward_on_other_devices_raises():
    """No fallback: a device with no kernel and no plain route raises, in
    the backward as in the forward."""
    z = lambda *s, **kw: torch.zeros(*s, device="meta", **kw)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        lstm_final_hidden(z(9, 23, 6, requires_grad=True),
                          z(9, 23, dtype=torch.bool), z(6, 32), z(8, 32),
                          z(32))
