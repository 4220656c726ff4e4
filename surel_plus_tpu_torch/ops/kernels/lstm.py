"""Masked LSTM over given input rows: the CUDA kernel `csrc/lstm.cu` (K5),
its plain PyTorch version and the wrapper that picks between them.

Replaces surel_plus_tpu/ops/pallas/lstm_kernel.py `lstm_final_hidden`
(the kernel `_lstm_kernel`): the LSTM aggregator's serving route on the
encoding-table path, where the set rows come as x [R, L, h] and not as
packed keys. For each row r and slot l in order:

    gates = x[r, l] @ wi + h @ wh + bh          [4H], order (i, f, g, o)
    c'    = sigmoid(f) c + sigmoid(i) tanh(g),  h' = sigmoid(o) tanh(c')
    (c, h) <- (c', h') where mask[r, l]; out[r] = the final h

all in float32: x and wi are cast to float32 BEFORE the input product, as
lstm_final_hidden casts them (lstm_kernel.py:340-348). That is this
module's contract; `lstm_keys.lstm_scan_plain` follows the JAX package's
scan instead (the input product in the promoted dtype of x and wi,
layers.py:286), and `lstm_final_hidden_plain` is that scan on float32
operands.

Forward only: the backward (`_lstm_bwd_kernel`) is not ported, so a call
that would need a gradient raises.
"""

from __future__ import annotations

import ctypes

import torch

from surel_plus_tpu_torch.ops.kernels.build import (
    CudaKernel,
    check_cuda,
    pick,
    ptr,
    ptr_or_null,
)
from surel_plus_tpu_torch.ops.kernels.lstm_keys import (
    MAX_H,
    lstm_scan_plain,
    row_order,
)

LSTM_X_KERNEL = CudaKernel("lstm", "lstm_x_fwd_launch",
                           [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                           + [ctypes.c_void_p])
BWD_TODO = "surel_plus_tpu/ops/pallas/lstm_kernel.py:_lstm_bwd_kernel"


def lstm_final_hidden_plain(x, mask, wi, wh, bh):
    """[R, H] float32 in plain PyTorch: `lstm_scan_plain` on x and wi cast
    to float32."""
    f32 = lambda t: t.to(torch.float32)
    return lstm_scan_plain(f32(x), mask, f32(wi), wh, bh)


def lstm_final_hidden_cuda(x, mask, wi, wh, bh, sort_rows: bool = True,
                           order=None):
    """Launch K5; see csrc/lstm.cu. x [R, L, h], wi [h, 4H], wh [H, 4H],
    bh [4H]: contiguous float32; mask bool [R, L]. The rows run in `order`
    (int32 [R]) if given, else, with `sort_rows`, by their last valid slot,
    longest first (`row_order`), else in their own order. Returns [R, H]
    float32."""
    r, ell, h = x.shape
    hh = wh.shape[0]
    dev = x.device
    check_cuda("x", x, torch.float32, (r, ell, h), dev)
    check_cuda("mask", mask, torch.bool, (r, ell), dev)
    check_cuda("wi", wi, torch.float32, (h, 4 * hh), dev)
    check_cuda("wh", wh, torch.float32, (hh, 4 * hh), dev)
    check_cuda("bh", bh, torch.float32, (4 * hh,), dev)
    if not (1 <= h <= MAX_H and 1 <= hh <= MAX_H and ell >= 1):
        raise ValueError(f"unsupported shape: L={ell} h={h} H={hh} "
                         f"(h, H <= {MAX_H})")
    out = torch.empty(r, hh, dtype=torch.float32, device=dev)
    if r:
        if order is None and sort_rows:
            order = row_order(mask)
        LSTM_X_KERNEL(dev, ptr(x), ptr(mask), ptr_or_null(order), ptr(wi),
                      ptr(wh), ptr(bh), ptr(out), r, ell, h, hh)
    return out


def lstm_final_hidden(x: torch.Tensor, mask: torch.Tensor, wi: torch.Tensor,
                      wh: torch.Tensor, bh: torch.Tensor) -> torch.Tensor:
    """Final masked-LSTM hidden state -> [R, H] float32.

    x [R, L, h] (any float dtype, computed in float32), mask bool [R, L]
    (any pattern; a masked slot leaves the carry as it is), wi [h, 4H],
    wh [H, 4H], bh [4H]. On CUDA tensors this launches K5, on CPU tensors
    it takes the plain version. Raises NotImplementedError when grad mode
    is on and an input requires grad: the backward is not ported."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, wi, wh, bh)):
        raise NotImplementedError(
            f"lstm_final_hidden is forward only: its backward ({BWD_TODO}) "
            "is not ported; train the LSTM Net without keys on the unfused "
            "route (fused_hidden=False)")
    fn = pick("lstm_final_hidden", x, lstm_final_hidden_cuda,
              lstm_final_hidden_plain)
    f32 = lambda t: t.to(torch.float32).contiguous()
    return fn(f32(x), mask.contiguous(), f32(wi), f32(wh),
              f32(bh).reshape(-1))
