"""Fused attention pool from the packed keys: the CUDA kernels
`csrc/attn_pool.cu` (forward) and `csrc/attn_pool_bwd.cu` (backward),
their plain PyTorch versions, and the autograd Function that joins them.

Replaces surel_plus_tpu/ops/pallas/hidden_sum_kernel.py
(`fused_attn_pool`: `_attn_fwd_kernel`, `_attn_bwd_kernel` and the custom
VJP `_fused_attn`; and the slot-chunked `_attn_cstats_kernel`,
`_attn_ct_kernel`, `_attn_cbwd_kernel` behind `_fused_attn_ck`). For each
endpoint q, query row b and slot l:

    hs[l]   = relu(fext(kown[l], 1 - mask[l]) @ U)
              + relu(fext(kcross_al[l], 0) @ U)
    gate[l] = hs[l] @ gvec + NEG * (1 - mask[l]) + gconst
    out     = sum_l softmax_l(gate)[l] * hs[l]                     [Q, B, H]

with fext(k, inv) = [f(k) | inv | 1] (`_fields_ext`) and U = u_ext as the
fused set sum builds it. A masked slot's gate lies 1e9 below the others,
so its weight is exactly 0 (sets always hold their root). The gradient is
taken for u_ext and gv = [gvec; gconst] only, with the hidden rows
recomputed from the keys.

The TPU needs the chunked kernels where the monolithic backward's
slot-aligned planes overflow its 16 MB of scoped VMEM (L=801 at M=200).
The CUDA kernels give each row a warp that walks only the 32-slot tiles
holding a valid slot; the forward keeps an online softmax and no
per-slot state, the backward two floats per slot in its warp's shared
memory, so ONE pair of kernels covers every L, chunked shapes included:
there is no `chunk` argument.
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
    ptr_or_null,
)
from surel_plus_tpu_torch.ops.kernels.hidden_sum import (
    MAX_H,
    MAX_NCOL,
    MAX_Q,
    NEG,
    _fields_ext,
)

ATTN_KERNEL = CudaKernel("attn_pool", "attn_pool_fwd_launch",
                         [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                         + [ctypes.c_void_p])
ATTN_BWD_KERNEL = CudaKernel("attn_pool_bwd", "attn_pool_bwd_launch",
                             [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
                             + [ctypes.c_void_p])
TILE = 32              # slots per tile (csrc/attn_pool.cuh kTile)
BWD_PARTS = 4096       # row groups of the backward, each one partial sum
MAX_DYN_SMEM = 232448  # bytes of dynamic shared memory a block may have


def bwd_smem_bytes(ell: int, h: int, ncol: int) -> int:
    """Shared memory of a backward block of one warp (the most that any
    shape needs of either kernel): the channels' weight records, then the
    warp's slot records, sums and a group's sums, g row, a and dgate per
    slot, walked bits and dgconst (csrc/attn_pool_bwd.cu `WarpLayout`)."""
    pad = lambda n, k: -(-n // k) * k
    hp = pad(h, 32)
    rec_k, rec_s = pad(ncol + 3, 4), pad(2 * ncol + 3, 4)
    warp = (TILE * rec_s + (2 * ncol + 7) * hp + 2 * pad(ell, 4)
            + pad(-(-ell // TILE), 4) + 4)
    return 4 * (hp * rec_k + warp)


def attn_slots_plain(kown, kcross_al, mask, u_ext, gv, shift: int,
                     root_own=None, root_cross=None):
    """Per-slot (fo, fc, zo, zc, hs, gate) in plain fp32: the extended
    fields [Q, B, L, ncol+2] of both sides, their pre-relu hidden rows
    [Q, B, L, H], the hidden rows hs and the gate logits [Q, B, L]."""
    ncol = u_ext.shape[0] - 2
    h = u_ext.shape[1]
    inv = ~mask
    fo = _fields_ext(kown, inv, shift, ncol, root_own)
    fc = _fields_ext(kcross_al, torch.zeros_like(mask), shift, ncol,
                     root_cross)
    zo, zc = fo @ u_ext, fc @ u_ext
    hs = torch.relu(zo) + torch.relu(zc)
    gate = hs @ gv[:h, 0] + NEG * inv.to(torch.float32) + gv[h, 0]
    return fo, fc, zo, zc, hs, gate


def attn_softmax_plain(gate):
    """(a, m, s): the softmax weights over the last axis, its max m and
    its sum s = sum exp(gate - m)."""
    m = gate.amax(dim=-1)
    e = torch.exp(gate - m[..., None])
    s = e.sum(dim=-1)
    return e / s[..., None], m, s


def fused_attn_pool_plain(kown, kcross_al, mask, u_ext, gv, shift: int,
                          root_own=None, root_cross=None):
    """(out [Q, B, H], m [Q, B], s [Q, B]) in plain fp32: materializes
    every slot's hidden row, as the JAX package's XLA path does."""
    *_, hs, gate = attn_slots_plain(kown, kcross_al, mask, u_ext, gv, shift,
                                    root_own, root_cross)
    a, m, s = attn_softmax_plain(gate)
    return (a[..., None] * hs).sum(dim=-2), m, s


def fused_attn_pool_bwd_plain(kown, kcross_al, mask, u_ext, gv, g, m, s,
                              shift: int, root_own=None, root_cross=None):
    """(du [ncol+2, H], dgv [H+1, 1]) for the cotangent g [Q, B, H], by the
    explicit formula of the softmax's VJP (the TPU kernel's), with the
    weights a = exp(gate - m) / s from the forward's residuals."""
    fo, fc, zo, zc, hs, gate = attn_slots_plain(
        kown, kcross_al, mask, u_ext, gv, shift, root_own, root_cross)
    h = u_ext.shape[1]
    c = u_ext.shape[0]
    gb = g.to(torch.float32)[:, :, None, :]                   # [Q,B,1,H]
    a = torch.exp(gate - m[..., None]) / s[..., None]          # [Q,B,L]
    da = (hs * gb).sum(dim=-1)
    t = (a * da).sum(dim=-1, keepdim=True)
    dgate = a * (da - t)
    dhs = a[..., None] * gb + dgate[..., None] * gv[:h, 0]
    dzo = torch.where(zo > 0, dhs, 0.0).reshape(-1, h)
    dzc = torch.where(zc > 0, dhs, 0.0).reshape(-1, h)
    du = fo.reshape(-1, c).T @ dzo + fc.reshape(-1, c).T @ dzc
    dgv = torch.cat([hs.reshape(-1, h).T @ dgate.reshape(-1, 1),
                     dgate.sum().reshape(1, 1)])
    return du, dgv


def _check_operands(kown, kcross_al, mask, u_ext, gv, shift, root_own,
                    root_cross):
    """Raise unless the operands are what the CUDA kernels take; returns
    (Q, B, L, H, ncol)."""
    q, b, ell = kown.shape
    nbx, h = u_ext.shape
    ncol = nbx - 2
    dev = kown.device
    check_cuda("kown", kown, torch.int32, (q, b, ell), dev)
    check_cuda("kcross_al", kcross_al, torch.int32, (q, b, ell), dev)
    check_cuda("mask", mask, torch.bool, (q, b, ell), dev)
    check_cuda("u_ext", u_ext, torch.float32, (nbx, h), dev)
    check_cuda("gv", gv, torch.float32, (h + 1, 1), dev)
    if (root_own is None) != (root_cross is None):
        raise ValueError("pass both root planes or neither")
    if root_own is not None:
        check_cuda("root_own", root_own, torch.int32, (q, b, ell), dev)
        check_cuda("root_cross", root_cross, torch.int32, (q, b, ell), dev)
    nshift = ncol - 1 if root_own is not None else ncol
    if not (1 <= q <= MAX_Q and 2 <= ncol <= MAX_NCOL and 1 <= h <= MAX_H
            and ell >= 1):
        raise ValueError(f"unsupported shape: Q={q} L={ell} ncol={ncol} "
                         f"H={h}")
    if (nshift - 1) * shift >= 32 or (root_own is not None
                                      and nshift * shift > 32):
        raise ValueError(f"{ncol} fields of {shift} bits do not fit the "
                         "lo word")
    if bwd_smem_bytes(ell, h, ncol) > MAX_DYN_SMEM:
        raise ValueError(f"L={ell} at H={h} needs more shared memory than "
                         "a block has")
    return q, b, ell, h, ncol


def fused_attn_pool_cuda(kown, kcross_al, mask, u_ext, gv, shift: int,
                         root_own=None, root_cross=None):
    """Launch the forward kernel; see csrc/attn_pool.cu. Returns
    (out [Q, B, H], m [Q, B], s [Q, B]), fp32."""
    q, b, ell, h, ncol = _check_operands(kown, kcross_al, mask, u_ext, gv,
                                         shift, root_own, root_cross)
    dev = kown.device
    out = torch.empty(q, b, h, dtype=torch.float32, device=dev)
    m = torch.empty(q, b, dtype=torch.float32, device=dev)
    s = torch.empty_like(m)
    if b:
        ATTN_KERNEL(dev, ptr(kown), ptr(kcross_al), ptr(mask),
                    ptr_or_null(root_own), ptr_or_null(root_cross),
                    ptr(u_ext), ptr(gv), ptr(out), ptr(m), ptr(s), q, b, ell,
                    h, ncol, shift)
    return out, m, s


def fused_attn_pool_bwd_cuda(kown, kcross_al, mask, u_ext, gv, g, m, s,
                             shift: int, root_own=None, root_cross=None):
    """Launch the backward kernel and its reduction pass; see
    csrc/attn_pool_bwd.cu. g: contiguous fp32 [Q, B, H]; m, s: the
    forward's residuals. Returns (du [ncol+2, H], dgv [H+1, 1])."""
    q, b, ell, h, ncol = _check_operands(kown, kcross_al, mask, u_ext, gv,
                                         shift, root_own, root_cross)
    dev = kown.device
    check_cuda("g", g, torch.float32, (q, b, h), dev)
    check_cuda("m", m, torch.float32, (q, b), dev)
    check_cuda("s", s, torch.float32, (q, b), dev)
    out = torch.zeros((ncol + 3) * h + 1, dtype=torch.float32, device=dev)
    if b:
        parts = min(q * b, BWD_PARTS)
        scratch = torch.empty(out.numel() * parts, dtype=torch.float32,
                              device=dev)
        ATTN_BWD_KERNEL(dev, ptr(kown), ptr(kcross_al), ptr(mask),
                        ptr_or_null(root_own), ptr_or_null(root_cross),
                        ptr(u_ext), ptr(gv), ptr(g), ptr(m), ptr(s),
                        ptr(scratch), ptr(out), q, b, ell, h, ncol, shift,
                        parts)
    return (out[:(ncol + 2) * h].view(ncol + 2, h),
            out[(ncol + 2) * h:].view(h + 1, 1))


class FusedAttnPool(torch.autograd.Function):
    """The attention pool with its gradient for u_ext and gv only (the
    custom VJP `_fused_attn` of the JAX kernel). The forward saves the
    softmax's max and sum per row; the backward recomputes the hidden rows
    from the saved keys, on the card with the backward kernel."""

    @staticmethod
    def forward(ctx, kown, kcross_al, mask, u_ext, gv, shift, root_own,
                root_cross):
        fwd = pick("fused_attn_pool forward", kown, fused_attn_pool_cuda,
                   fused_attn_pool_plain)
        out, m, s = fwd(kown, kcross_al, mask, u_ext, gv, shift, root_own,
                        root_cross)
        ctx.shift = shift
        ctx.save_for_backward(kown, kcross_al, mask, u_ext, gv, m, s,
                              root_own, root_cross)
        return out

    @staticmethod
    def backward(ctx, g):
        kown, kcross_al, mask, u_ext, gv, m, s, root_own, root_cross = \
            ctx.saved_tensors
        bwd = pick("fused_attn_pool backward", kown,
                   fused_attn_pool_bwd_cuda, fused_attn_pool_bwd_plain)
        du, dgv = bwd(kown, kcross_al, mask, u_ext, gv,
                      g.to(torch.float32).contiguous(), m, s, ctx.shift,
                      root_own, root_cross)
        return None, None, None, du, dgv, None, None, None


def fused_attn_pool(kown: torch.Tensor, kcross_al: torch.Tensor,
                    mask: torch.Tensor, u_ext: torch.Tensor,
                    gvec: torch.Tensor, gconst: torch.Tensor, shift: int,
                    root_own: Optional[torch.Tensor] = None,
                    root_cross: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Masked attention pool over the per-slot hidden rows -> [Q, B, H]
    fp32, differentiable in u_ext, gvec and gconst.

    kown, kcross_al [Q, B, L]: int32 bits of the own and the slot-aligned
    partner lo keys; mask bool [Q, B, L]; u_ext float32 [ncol + 2, H] as
    for `fused_key_hidden_sum`; gvec [H, 1] (the folded gate vector
    W2 @ wg) and gconst (one element, c2 @ wg + bg). root_own /
    root_cross: int32 0/1 [Q, B, L] planes replacing the key's root bit
    (lead-in-hi layout). On CUDA tensors this launches the kernels
    (forward, and backward when differentiated), on CPU tensors it takes
    the plain versions."""
    h = u_ext.shape[1]
    gv = torch.cat([gvec.to(torch.float32).reshape(h, 1),
                    gconst.to(torch.float32).reshape(1, 1)])
    return FusedAttnPool.apply(kown, kcross_al, mask, u_ext, gv, shift,
                               root_own, root_cross)
