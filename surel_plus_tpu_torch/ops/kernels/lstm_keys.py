"""Masked LSTM straight from the packed keys: the CUDA kernel
`csrc/lstm_keys.cu` (K4, forward) and its plain PyTorch version.

Replaces surel_plus_tpu/ops/pallas/lstm_kernel.py `lstm_from_keys`: impl
"t2" (`_klstm_t2_fwd_kernel`, the default) and impl "t1"
(`_klstm_t_fwd_kernel`). For each row r = (q, b) and slot l in order:

    x_l   = relu(fext(kown[l], 0) @ U) + relu(fext(kcross_al[l], 0) @ U)
    gates = x_l @ wi + h @ wh + bh              [4H], order (i, f, g, o)
    c'    = sigmoid(f) c + sigmoid(i) tanh(g),  h' = sigmoid(o) tanh(c')
    (c, h) <- (c', h') where mask[r, l]; out[q, b] = the final h

with fext(k, 0) = [f(k) | 0 | 1] (`_fields_ext`: the invalid field is 0 on
BOTH sides here, unlike the attention pool's own side) and U = u_ext. A
row with no valid slot gives 0. Any mask is allowed (t1's contract); t2's
prefix-mask shortcut is not carried over.

The TPU kernels carry the mask as an extra lane of U and wi, keep the
planes transposed and extract fields chunk by chunk, all for Mosaic's lane
rules: none of that is here. The kernel reads the mask plane.

Forward only: the gradient (`_klstm_t2_bwd_kernel`, a BPTT recomputed
from the keys) is not ported yet, and `lstm_from_keys` raises rather than
let autograd differentiate the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from surel_plus_tpu_torch.ops.kernels.build import (
    CudaKernel,
    check_cuda,
    pick,
    ptr,
)
from surel_plus_tpu_torch.ops.kernels.hidden_sum import (
    MAX_NCOL,
    MAX_Q,
    _fields_ext,
)

LSTM_KERNEL = CudaKernel("lstm_keys", "lstm_keys_fwd_launch",
                         [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                         + [ctypes.c_void_p])
MAX_H = 256     # LSTM width H and input width h (csrc/lstm_keys.cuh kMaxH)
BWD_TODO = ("the keys-LSTM backward (surel_plus_tpu/ops/pallas/"
            "lstm_kernel.py:934 `_klstm_t2_bwd_kernel`) is not ported yet: "
            "lstm_from_keys is forward only")


def lstm_scan_plain(x, mask, wi, wh, bh):
    """Final hidden state [R, H] float32 of the masked LSTM over rows
    x [R, L, h], mask bool [R, L], in the order of the JAX package's scan
    (layers.py:286-302): x_l @ wi in the promoted type of x and wi, then
    float32 for the rest. The input product is taken a step at a time:
    all of x @ wi at once would be 4H/h times the size of x."""
    r, ell, _ = x.shape
    hh = wh.shape[0]
    dt = torch.promote_types(x.dtype, wi.dtype)
    wi = wi.to(dt)
    wh = wh.to(torch.float32)
    bh = bh.to(torch.float32)
    c = torch.zeros(r, hh, dtype=torch.float32, device=x.device)
    h = torch.zeros_like(c)
    for t in range(ell):
        gates = (x[:, t].to(dt) @ wi).to(torch.float32) + h @ wh + bh
        gi, gf, gg, go = gates.chunk(4, dim=-1)
        nc = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
        nh = torch.sigmoid(go) * torch.tanh(nc)
        keep = mask[:, t, None]
        c = torch.where(keep, nc, c)
        h = torch.where(keep, nh, h)
    return h


def lstm_rows_plain(kown, kcross_al, u_ext, shift: int, root_own=None,
                    root_cross=None):
    """The hidden rows x [Q, B, L, h] float32 that the LSTM reads."""
    ncol = u_ext.shape[0] - 2
    zero = torch.zeros(kown.shape, dtype=torch.bool, device=kown.device)
    x = torch.relu(_fields_ext(kown, zero, shift, ncol, root_own) @ u_ext)
    return x + torch.relu(_fields_ext(kcross_al, zero, shift, ncol,
                                      root_cross) @ u_ext)


def lstm_from_keys_plain(kown, kcross_al, mask, u_ext, wi, wh, bh,
                         shift: int, root_own=None, root_cross=None):
    """[Q, B, H] float32 in plain PyTorch: materializes the hidden rows,
    then runs `lstm_scan_plain` over them."""
    q, b, ell = kown.shape
    x = lstm_rows_plain(kown, kcross_al, u_ext, shift, root_own, root_cross)
    out = lstm_scan_plain(x.reshape(q * b, ell, -1),
                          mask.reshape(q * b, ell), wi, wh, bh)
    return out.reshape(q, b, -1)


def row_order(mask: torch.Tensor) -> torch.Tensor:
    """int32 [R]: the rows of mask [R, L] by their last valid slot, the
    longest first (stable), so that a block's rows end together."""
    ell = mask.shape[-1]
    pos = torch.arange(1, ell + 1, dtype=torch.int32, device=mask.device)
    last = torch.where(mask, pos, 0).amax(dim=-1)
    return torch.argsort(last, descending=True, stable=True).to(torch.int32)


def _check_operands(kown, kcross_al, mask, u_ext, wi, wh, bh, shift,
                    root_own, root_cross):
    """Raise unless the operands are what the CUDA kernel takes; returns
    (Q, B, L, h, H, ncol)."""
    q, b, ell = kown.shape
    nbx, h = u_ext.shape
    ncol = nbx - 2
    hh = wh.shape[0]
    dev = kown.device
    check_cuda("kown", kown, torch.int32, (q, b, ell), dev)
    check_cuda("kcross_al", kcross_al, torch.int32, (q, b, ell), dev)
    check_cuda("mask", mask, torch.bool, (q, b, ell), dev)
    check_cuda("u_ext", u_ext, torch.float32, (nbx, h), dev)
    check_cuda("wi", wi, torch.float32, (h, 4 * hh), dev)
    check_cuda("wh", wh, torch.float32, (hh, 4 * hh), dev)
    check_cuda("bh", bh, torch.float32, (4 * hh,), dev)
    if (root_own is None) != (root_cross is None):
        raise ValueError("pass both root planes or neither")
    if root_own is not None:
        check_cuda("root_own", root_own, torch.int32, (q, b, ell), dev)
        check_cuda("root_cross", root_cross, torch.int32, (q, b, ell), dev)
    nshift = ncol - 1 if root_own is not None else ncol
    if not (1 <= q <= MAX_Q and 2 <= ncol <= MAX_NCOL and 1 <= h <= MAX_H
            and 1 <= hh <= MAX_H and ell >= 1):
        raise ValueError(f"unsupported shape: Q={q} L={ell} ncol={ncol} "
                         f"h={h} H={hh} (h, H <= {MAX_H})")
    if (nshift - 1) * shift >= 32 or (root_own is not None
                                      and nshift * shift > 32):
        raise ValueError(f"{ncol} fields of {shift} bits do not fit the "
                         "lo word")
    return q, b, ell, h, hh, ncol


def lstm_from_keys_cuda(kown, kcross_al, mask, u_ext, wi, wh, bh,
                        shift: int, root_own=None, root_cross=None,
                        sort_rows: bool = True):
    """Launch K4; see csrc/lstm_keys.cu. wi [h, 4H], wh [H, 4H], bh [4H]:
    contiguous float32. With `sort_rows` the rows run by their last valid
    slot, longest first (`row_order`). Returns [Q, B, H] float32."""
    q, b, ell, h, hh, ncol = _check_operands(
        kown, kcross_al, mask, u_ext, wi, wh, bh, shift, root_own,
        root_cross)
    dev = kown.device
    out = torch.empty(q, b, hh, dtype=torch.float32, device=dev)
    if b:
        null = ctypes.c_void_p(None)
        order = row_order(mask.reshape(q * b, ell)) if sort_rows else None
        LSTM_KERNEL(dev, ptr(kown), ptr(kcross_al), ptr(mask),
                    null if root_own is None else ptr(root_own),
                    null if root_cross is None else ptr(root_cross),
                    null if order is None else ptr(order), ptr(u_ext),
                    ptr(wi), ptr(wh), ptr(bh), ptr(out), q * b, ell, h, hh,
                    ncol, shift)
    return out


def lstm_from_keys(kown: torch.Tensor, kcross_al: torch.Tensor,
                   mask: torch.Tensor, u_ext: torch.Tensor,
                   wi: torch.Tensor, wh: torch.Tensor, bh: torch.Tensor,
                   shift: int, root_own: Optional[torch.Tensor] = None,
                   root_cross: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Masked LSTM final hidden state from the packed keys -> [Q, B, H]
    float32.

    kown, kcross_al [Q, B, L]: int32 bits of the own and the slot-aligned
    partner lo keys; mask bool [Q, B, L] (any pattern); u_ext
    [ncol + 2, h] as for `fused_key_hidden_sum`; wi [h, 4H] (the input
    weights, projection folded in), wh [H, 4H], bh [4H], cast to float32
    here. root_own / root_cross: int32 0/1 planes replacing the key's root
    bit (lead-in-hi layout). On CUDA tensors this launches K4, on CPU
    tensors it takes the plain version. Forward only: raises
    NotImplementedError when grad mode is on and a weight requires grad."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (u_ext, wi, wh, bh)):
        raise NotImplementedError(BWD_TODO)
    fn = pick("lstm_from_keys", kown, lstm_from_keys_cuda,
              lstm_from_keys_plain)
    f32 = lambda t: t.to(torch.float32).contiguous()
    return fn(kown, kcross_al, mask, f32(u_ext), f32(wi), f32(wh),
              f32(bh).reshape(-1), shift, root_own, root_cross)
