"""Fused key unpack + hidden layer + masked set sum: the CUDA kernels
`csrc/hidden_sum.cu` (forward) and `csrc/hidden_sum_bwd.cu` (backward),
their plain PyTorch versions, and the autograd Function that joins them.
Below them, the per-slot variant (`fused_key_hidden_slots`, kernels
`csrc/hidden_slots.cu` and `csrc/hidden_slots_bwd.cu`).

Replaces surel_plus_tpu/ops/pallas/hidden_sum_kernel.py
(`fused_key_hidden_sum`, `_fwd_kernel`, `_bwd_kernel` and the custom VJP
`_fused`). The function:

    out[q, b] = sum_l  mask_own[q, b, l]   * relu(f(kown[q, b, l]) @ U + b1)
              + sum_l' mask_cross[q, b, l'] * relu(f(kcross[b, l']) @ U + b1)

with f() unpacking a packed key into its count fields and U = W1's rows
permuted and scaled to the field order (`u_core_rows`). kcross is ONE
shared [B, Lc] plane (the join's merged order) whose positions each
endpoint selects with its mask_cross row. Its gradient with respect to
u_ext recomputes the activations from the keys. The port issues one
launch per batch and direction: the TPU's VMEM gating and lane padding do
not apply.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from surel_plus_tpu_torch.ops.kernels.build import (
    CudaKernel,
    check_cuda,
    pick,
    ptr,
    ptr_or_null,
)
from surel_plus_tpu_torch.ops.walk import enc_field_layout

NEG = -1e9      # masked-slot logit offset (relu clamps to 0)

KERNEL = CudaKernel("hidden_sum", "hidden_sum_fwd_launch",
                    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                    + [ctypes.c_void_p])
BWD_KERNEL = CudaKernel("hidden_sum_bwd", "hidden_sum_bwd_launch",
                        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                        + [ctypes.c_void_p])
SLOTS_KERNEL = CudaKernel("hidden_slots", "hidden_slots_fwd_launch",
                          [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                          + [ctypes.c_void_p])
SLOTS_BWD_KERNEL = CudaKernel("hidden_slots_bwd", "hidden_slots_bwd_launch",
                              [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                              + [ctypes.c_void_p])
MAX_Q, MAX_NCOL, MAX_H = 4, 8, 1024
# The backwards' partitions, each part one partial dU (fixed, so that the
# bits do not depend on the card): K1 bwd runs a warp per query row, TC_WARPS
# rows a block, in at most BWD_PARTS blocks; K7 bwd a persistent grid of
# SLOTS_BWD_PARTS blocks (three an SM of an H100) over its tiles.
BWD_PARTS = 1024
SLOTS_BWD_PARTS = 396
SLOTS_OUT_DTYPES = (torch.float32, torch.bfloat16)

# csrc/hidden_tc.cuh's layout, mirrored for the tests:
# warps a block, stages of K7 bwd's ring and the cotangent bytes a stage
# holds, K1 bwd's queue, the widest field exact in TF32, and K1's recheck
# bound: a tensor-core z within S / 2^TC_NEAR_SHIFT of 0 is recomputed in
# the fmaf order (a slot's S = max |b1| + sum_i f_i max |U_i| over the
# slab's channels, 0 where its fields meet no nonzero U row).
TC_WARPS, TC_STAGES, TC_STAGE_BYTES, TC_QUEUE, TC_EXACT_SHIFT = \
    4, 2, 6144, 64, 11
TC_NEAR_SHIFT = 16


def slab_mtiles(ncol: int, slots: bool) -> int:
    """m-tiles (16 channels) of a channel slab of K7 bwd (`slots`), or of
    K1 bwd and K1."""
    if slots:
        return 6 if ncol <= 5 else (4 if ncol <= 6 else 3)
    return 6 if ncol <= 4 else 3


def tile_slots(ncol: int, itemsize: int) -> int:
    """Slots of a K7 bwd tile (its accumulator's slab): whole k-steps of 4
    slots of a slab's cotangent rows in TC_STAGE_BYTES, 4 to 32."""
    ts = TC_STAGE_BYTES // (16 * slab_mtiles(ncol, True) * itemsize) // 4 * 4
    return min(max(ts, 4), 32)


def u_core_rows(w1: torch.Tensor, num_walks: int,
                num_steps: int) -> torch.Tensor:
    """W1 [ncol, H] (rows in encoding-column order) permuted and scaled to
    the kernel's field order: field i < num_steps is column num_steps-i,
    the last field is the root column. The 1/num_walks feature
    normalization rides on the rows; the root column's cancels."""
    _, _, lead_bit = enc_field_layout(num_walks, num_steps)
    if lead_bit > 32:
        raise ValueError(
            "u_core_rows requires the count fields in the lo word")
    # rows num_steps, ..., 1: a flip, not an index list (which would be
    # copied to the device, and waited for, on every call)
    return torch.cat([w1[1:num_steps + 1].flip(0).to(torch.float32)
                      / num_walks, w1[0:1].to(torch.float32)], dim=0)


def _fields_ext(keys, inv, shift: int, ncol: int, root=None):
    """[..., ncol+2] float32: unpacked fields | invalid-slot | always-one."""
    ku = keys.to(torch.int64) & 0xFFFFFFFF
    nf = ncol if root is None else ncol - 1
    fm = (1 << shift) - 1
    cols = [(ku >> (i * shift)) & (1 if root is None and i == ncol - 1
                                   else fm) for i in range(nf)]
    if root is not None:
        cols.append(root.to(torch.int64))
    fields = torch.stack(cols, dim=-1).to(torch.float32)
    return torch.cat([fields, inv[..., None].to(torch.float32),
                      torch.ones_like(fields[..., :1])], dim=-1)


def fma32(a, b, c):
    """fmaf on float32 tensors: a * b + c rounded once to float32, where
    a * b is exact in float64 (a an integer below 2^29). The sum is taken
    in float64 and rounded to odd (its last bit set where it was inexact,
    its error from TwoSum), then to float32: rounding to odd with 29 bits to
    spare and then to nearest is the sum rounded once."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    back = s - p
    err = (p - (s - back)) + (c - back)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.nextafter(s, torch.where(err > 0, math.inf, -math.inf))
    return torch.where((err != 0) & even, away, s).float()


def zed_fmaf(fields, u_ext):
    """z = f . U + b1 [..., H] in the fmaf order of csrc/hidden_tc.cuh's
    `zed` (b1 first, then field 0, 1, ...): the relu decisions (z > 0)
    that K1 keeps and its backward recomputes. `fields` [..., ncol]
    float32, integers below 2^29."""
    ncol = fields.shape[-1]
    z = u_ext[ncol + 1].expand(*fields.shape[:-1], u_ext.shape[1])
    for i in range(ncol):
        z = fma32(fields[..., i:i + 1], u_ext[i], z)
    return z


def fused_key_hidden_sum_plain(kown, mask_own, kcross, mask_cross, u_ext,
                               shift: int, root_own=None, root_cross=None):
    """The set sum in plain fp32 PyTorch: materializes every slot's
    hidden row, as the JAX package's XLA reference does."""
    ncol = u_ext.shape[0] - 2
    zc = torch.relu(_fields_ext(kcross, torch.zeros_like(kcross), shift,
                                ncol, root_cross) @ u_ext)      # [B, Lc, H]
    zo = torch.relu(_fields_ext(kown, ~mask_own, shift, ncol, root_own)
                    @ u_ext)                                     # [Q,B,Lo,H]
    return (zo.sum(dim=-2)
            + (zc[None] * mask_cross[..., None].to(zc.dtype)).sum(dim=-2))


def fused_key_hidden_sum_bwd_plain(kown, mask_own, kcross, mask_cross,
                                   u_ext, g, shift: int, root_own=None,
                                   root_cross=None):
    """dU [ncol+2, H] fp32 for the cotangent g [Q, B, H], by the explicit
    formula: fields_ext^T @ where(z > 0, g, 0) per side, a cross slot's
    cotangent being the sum of g over the endpoints that select it."""
    ncol = u_ext.shape[0] - 2
    g = g.to(torch.float32)
    fo = _fields_ext(kown, ~mask_own, shift, ncol, root_own)   # [Q,B,Lo,C]
    dz = torch.where(fo @ u_ext > 0, g[:, :, None, :], 0.0)    # [Q,B,Lo,H]
    fc = _fields_ext(kcross, torch.zeros_like(kcross), shift, ncol,
                     root_cross)                                # [B,Lc,C]
    gc = torch.einsum("qbl,qbh->blh", mask_cross.to(torch.float32), g)
    dzc = torch.where(fc @ u_ext > 0, gc, 0.0)                  # [B,Lc,H]
    return (fo.reshape(-1, ncol + 2).T @ dz.reshape(-1, dz.shape[-1])
            + fc.reshape(-1, ncol + 2).T @ dzc.reshape(-1, dzc.shape[-1]))


def _cross_row_stride(kcross, mask_cross, root_cross) -> int:
    """ldc, the elements between two rows of the cross planes that the
    kernels read: kcross and root_cross [B, Lc] with rows ldc apart,
    mask_cross [Q, B, Lc] with rows ldc and planes B ldc apart, each row
    dense (contiguous planes: ldc = Lc; HONet's halves of its [B, 4L]
    plane: 4L). Raises for any other layout. Strides of dimensions of size
    1 do not matter."""
    q, b, lc = mask_cross.shape
    ldc = (kcross.stride(0) if b > 1 else mask_cross.stride(0) if q > 1
           else lc)
    ok = ldc >= lc
    for t, want in ((kcross, (ldc, 1)), (mask_cross, (b * ldc, ldc, 1)),
                    (root_cross, (ldc, 1))):
        if t is None:
            continue
        ok = ok and all(n == 1 or st == w for n, st, w in
                        zip(t.shape, t.stride(), want))
    if not ok:
        raise ValueError("kcross, mask_cross and root_cross must be dense "
                         "rows the same stride apart")
    return ldc


def _check_operands(kown, mask_own, kcross, mask_cross, u_ext, shift,
                    root_own, root_cross):
    """Raise unless the operands are what the CUDA kernels take; returns
    (Q, B, Lo, Lc, ldc, H, ncol). The cross planes may be row-strided
    views (`_cross_row_stride`); every other operand is contiguous."""
    q, b, lo = kown.shape
    lc = kcross.shape[1]
    nbx, h = u_ext.shape
    ncol = nbx - 2
    dev = kown.device
    check_cuda("kown", kown, torch.int32, (q, b, lo), dev)
    check_cuda("mask_own", mask_own, torch.bool, (q, b, lo), dev)
    check_cuda("kcross", kcross, torch.int32, (b, lc), dev,
               contiguous=False)
    check_cuda("mask_cross", mask_cross, torch.bool, (q, b, lc), dev,
               contiguous=False)
    check_cuda("u_ext", u_ext, torch.float32, (nbx, h), dev)
    if (root_own is None) != (root_cross is None):
        raise ValueError("pass both root planes or neither")
    if root_own is not None:
        check_cuda("root_own", root_own, torch.int32, (q, b, lo), dev)
        check_cuda("root_cross", root_cross, torch.int32, (b, lc), dev,
                   contiguous=False)
    ldc = _cross_row_stride(kcross, mask_cross, root_cross)
    _check_layout(q, ncol, h, shift, root_own is not None)
    return q, b, lo, lc, ldc, h, ncol


def _check_layout(q: int, ncol: int, h: int, shift: int, root: bool):
    """Raise unless the kernels take Q endpoints, ncol fields of `shift`
    bits (the last from a root plane with `root`) and H channels."""
    nshift = ncol - 1 if root else ncol
    if not (1 <= q <= MAX_Q and 2 <= ncol <= MAX_NCOL and 1 <= h <= MAX_H):
        raise ValueError(f"unsupported shape: Q={q} ncol={ncol} H={h}")
    if (nshift - 1) * shift >= 32 or (root and nshift * shift > 32):
        raise ValueError(f"{ncol} fields of {shift} bits do not fit the "
                         "lo word")


def fused_key_hidden_sum_cuda(kown, mask_own, kcross, mask_cross, u_ext,
                              shift: int, root_own=None, root_cross=None):
    """Launch the set-sum kernel; see csrc/hidden_sum.cu."""
    q, b, lo, lc, ldc, h, ncol = _check_operands(
        kown, mask_own, kcross, mask_cross, u_ext, shift, root_own,
        root_cross)
    out = torch.empty(q, b, h, dtype=torch.float32, device=kown.device)
    if b:
        KERNEL(kown.device, ptr(kown), ptr(mask_own), ptr(kcross),
               ptr(mask_cross), ptr_or_null(root_own),
               ptr_or_null(root_cross), ptr(u_ext), ptr(out), q, b, lo, lc,
               ldc, h, ncol, shift)
    return out


def fused_key_hidden_sum_bwd_cuda(kown, mask_own, kcross, mask_cross, u_ext,
                                  g, shift: int, root_own=None,
                                  root_cross=None):
    """Launch the backward kernel and its reduction pass; see
    csrc/hidden_sum_bwd.cu. g: contiguous fp32 [Q, B, H]."""
    q, b, lo, lc, ldc, h, ncol = _check_operands(
        kown, mask_own, kcross, mask_cross, u_ext, shift, root_own,
        root_cross)
    dev = kown.device
    check_cuda("g", g, torch.float32, (q, b, h), dev)
    du = torch.zeros(ncol + 2, h, dtype=torch.float32, device=dev)
    if b:
        parts = min(-(-b // TC_WARPS), BWD_PARTS)
        scratch = torch.empty((ncol + 1) * h * parts, dtype=torch.float32,
                              device=dev)
        BWD_KERNEL(dev, ptr(kown), ptr(mask_own), ptr(kcross),
                   ptr(mask_cross), ptr_or_null(root_own),
                   ptr_or_null(root_cross), ptr(u_ext), ptr(g), ptr(scratch),
                   ptr(du), q, b, lo, lc, ldc, h, ncol, shift, parts)
    return du


class FusedKeyHiddenSum(torch.autograd.Function):
    """The set sum with its gradient for u_ext only (the custom VJP
    `_fused` of the JAX kernel): the backward recomputes the activations
    from the saved keys, on the card with the backward kernel."""

    @staticmethod
    def forward(ctx, kown, mask_own, kcross, mask_cross, u_ext, shift,
                root_own, root_cross):
        ctx.shift = shift
        ctx.save_for_backward(kown, mask_own, kcross, mask_cross, u_ext,
                              root_own, root_cross)
        fwd = pick("fused_key_hidden_sum forward", kown,
                   fused_key_hidden_sum_cuda, fused_key_hidden_sum_plain)
        return fwd(kown, mask_own, kcross, mask_cross, u_ext, shift,
                   root_own, root_cross)

    @staticmethod
    def backward(ctx, g):
        kown, mask_own, kcross, mask_cross, u_ext, root_own, root_cross = \
            ctx.saved_tensors
        bwd = pick("fused_key_hidden_sum backward", kown,
                   fused_key_hidden_sum_bwd_cuda,
                   fused_key_hidden_sum_bwd_plain)
        du = bwd(kown, mask_own, kcross, mask_cross, u_ext,
                 g.to(torch.float32).contiguous(), ctx.shift, root_own,
                 root_cross)
        return None, None, None, None, du, None, None, None


def fused_key_hidden_sum(kown: torch.Tensor, mask_own: torch.Tensor,
                         kcross: torch.Tensor, mask_cross: torch.Tensor,
                         u_ext: torch.Tensor, shift: int,
                         root_own: Optional[torch.Tensor] = None,
                         root_cross: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Masked set sum of both sides' hidden activations -> [Q, B, H] fp32,
    differentiable in u_ext.

    kown [Q, B, Lo]: int32 bits of the packed lo keys, mask_own bool.
    kcross [B, Lc]: the shared cross plane, selected per endpoint by
    mask_cross [Q, B, Lc]; on the card these and root_cross may be views
    whose rows lie the same stride apart (HONet's halves). u_ext float32
    [ncol + 2, H] = concat(u_core_rows(W1), [NEG row], [b1 row]).
    root_own / root_cross: int32 0/1 planes replacing the key's root bit
    (lead-in-hi layout).
    On CUDA tensors this launches the kernels (forward, and backward when
    differentiated), on CPU tensors it takes the plain versions."""
    return FusedKeyHiddenSum.apply(kown, mask_own, kcross, mask_cross,
                                   u_ext, shift, root_own, root_cross)


# ---------------------------------------------------------------------------
# Per-slot variant: the pair-summed hidden rows [Q, B, L, H] themselves,
# for the aggregators that read every slot (the unfused keys routes of
# models/net.py). Replaces `fused_key_hidden_slots` of the same JAX module
# (`_slots_fwd_kernel`, `_slots_bwd_kernel`, the custom VJP
# `_fused_slots`). The partner keys are slot-aligned (the join's
# kcross_al) and no mask is read: a masked slot gives finite values that
# the aggregators mask, and an absent partner's key 0 gives relu(b1), as
# the feature route's zero feature row does.


def fused_key_hidden_slots_plain(kown, kcross_al, u_ext, shift: int,
                                 out_dtype=torch.float32, root_own=None,
                                 root_cross=None):
    """relu(fields_ext(kown) @ u_ext) + relu(fields_ext(kcross_al) @ u_ext)
    in u_ext's precision (at least fp32), cast once to `out_dtype`. The
    invalid-slot column is all zeros on both sides, so u_ext's masking row
    never enters."""
    ncol = u_ext.shape[0] - 2
    ct = torch.promote_types(u_ext.dtype, torch.float32)
    u = u_ext.to(ct)
    zero = torch.zeros(kown.shape, dtype=torch.bool, device=kown.device)
    out = torch.relu(_fields_ext(kown, zero, shift, ncol, root_own).to(ct)
                     @ u)
    out = out + torch.relu(_fields_ext(kcross_al, zero, shift, ncol,
                                       root_cross).to(ct) @ u)
    return out.to(out_dtype)


def fused_key_hidden_slots_bwd_plain(kown, kcross_al, u_ext, g, shift: int,
                                     root_own=None, root_cross=None):
    """dU [ncol+2, H] (fp32, or u_ext's wider type) for the cotangent
    g [Q, B, L, H]: the sum over both sides and all slots of
    fields_ext^T @ where(z > 0, g, 0). Row ncol is exactly 0."""
    ncol, h = u_ext.shape[0] - 2, u_ext.shape[1]
    ct = torch.promote_types(u_ext.dtype, torch.float32)
    u = u_ext.to(ct)
    g = g.to(ct).reshape(-1, h)
    zero = torch.zeros(kown.shape, dtype=torch.bool, device=kown.device)
    du = torch.zeros(ncol + 2, h, dtype=ct, device=u_ext.device)
    for keys, root in ((kown, root_own), (kcross_al, root_cross)):
        f = _fields_ext(keys, zero, shift, ncol, root).to(ct).reshape(
            -1, ncol + 2)
        du += f.T @ torch.where(f @ u > 0, g, 0.0)
    return du


def _check_slots_operands(kown, kcross_al, u_ext, shift, root_own,
                          root_cross):
    """Raise unless the operands are what the per-slot CUDA kernels take;
    returns (Q, B, L, H, ncol)."""
    q, b, ell = kown.shape
    nbx, h = u_ext.shape
    ncol = nbx - 2
    dev = kown.device
    check_cuda("kown", kown, torch.int32, (q, b, ell), dev)
    check_cuda("kcross_al", kcross_al, torch.int32, (q, b, ell), dev)
    check_cuda("u_ext", u_ext, torch.float32, (nbx, h), dev)
    if (root_own is None) != (root_cross is None):
        raise ValueError("pass both root planes or neither")
    if root_own is not None:
        check_cuda("root_own", root_own, torch.int32, (q, b, ell), dev)
        check_cuda("root_cross", root_cross, torch.int32, (q, b, ell), dev)
    _check_layout(q, ncol, h, shift, root_own is not None)
    return q, b, ell, h, ncol


def fused_key_hidden_slots_cuda(kown, kcross_al, u_ext, shift: int,
                                out_dtype=torch.float32, root_own=None,
                                root_cross=None):
    """Launch the per-slot kernel; see csrc/hidden_slots.cu. out_dtype:
    float32 or bfloat16."""
    q, b, ell, h, ncol = _check_slots_operands(kown, kcross_al, u_ext,
                                               shift, root_own, root_cross)
    if out_dtype not in SLOTS_OUT_DTYPES:
        raise ValueError(f"out_dtype {out_dtype} is not float32 or "
                         "bfloat16")
    out = torch.empty(q, b, ell, h, dtype=out_dtype, device=kown.device)
    if out.numel():
        SLOTS_KERNEL(kown.device, ptr(kown), ptr(kcross_al),
                     ptr_or_null(root_own), ptr_or_null(root_cross),
                     ptr(u_ext), ptr(out), q, b, ell, h, ncol, shift,
                     int(out_dtype == torch.bfloat16))
    return out


def fused_key_hidden_slots_bwd_cuda(kown, kcross_al, u_ext, g, shift: int,
                                    root_own=None, root_cross=None):
    """Launch the per-slot backward and its reduction pass; see
    csrc/hidden_slots_bwd.cu. g: contiguous [Q, B, L, H], float32 or
    bfloat16, read as it is."""
    q, b, ell, h, ncol = _check_slots_operands(kown, kcross_al, u_ext,
                                               shift, root_own, root_cross)
    dev = kown.device
    if g.dtype not in SLOTS_OUT_DTYPES:
        raise ValueError(f"g has dtype {g.dtype}, expected float32 or "
                         "bfloat16")
    check_cuda("g", g, g.dtype, (q, b, ell, h), dev)
    du = torch.zeros(ncol + 2, h, dtype=torch.float32, device=dev)
    n = q * b * ell
    if n:
        parts = min(n, SLOTS_BWD_PARTS)
        scratch = torch.empty((ncol + 1) * h * parts, dtype=torch.float32,
                              device=dev)
        SLOTS_BWD_KERNEL(dev, ptr(kown), ptr(kcross_al),
                         ptr_or_null(root_own), ptr_or_null(root_cross),
                         ptr(u_ext), ptr(g), ptr(scratch), ptr(du), q, b,
                         ell, h, ncol, shift,
                         int(g.dtype == torch.bfloat16), parts)
    return du


class FusedKeyHiddenSlots(torch.autograd.Function):
    """The per-slot rows with their gradient for u_ext only (the custom
    VJP `_fused_slots` of the JAX kernel): the backward recomputes the
    activations from the saved keys, on the card with the backward
    kernel."""

    @staticmethod
    def forward(ctx, kown, kcross_al, u_ext, shift, out_dtype, root_own,
                root_cross):
        ctx.shift = shift
        ctx.save_for_backward(kown, kcross_al, u_ext, root_own, root_cross)
        fwd = pick("fused_key_hidden_slots forward", kown,
                   fused_key_hidden_slots_cuda, fused_key_hidden_slots_plain)
        return fwd(kown, kcross_al, u_ext, shift, out_dtype, root_own,
                   root_cross)

    @staticmethod
    def backward(ctx, g):
        kown, kcross_al, u_ext, root_own, root_cross = ctx.saved_tensors
        bwd = pick("fused_key_hidden_slots backward", kown,
                   fused_key_hidden_slots_bwd_cuda,
                   fused_key_hidden_slots_bwd_plain)
        du = bwd(kown, kcross_al, u_ext, g.contiguous(), ctx.shift,
                 root_own, root_cross)
        return None, None, du, None, None, None, None


def fused_key_hidden_slots(kown: torch.Tensor, kcross_al: torch.Tensor,
                           u_ext: torch.Tensor, shift: int,
                           out_dtype: torch.dtype = torch.float32,
                           root_own: Optional[torch.Tensor] = None,
                           root_cross: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Pair-summed per-slot hidden activations -> [Q, B, L, H] out_dtype
    (computed in fp32 and rounded once; a bf16 output halves the only
    large write), differentiable in u_ext.

    kown, kcross_al [Q, B, L]: int32 bits of the packed lo keys, slot
    aligned. u_ext float32 [ncol + 2, H] = concat(u_core_rows(W1), [any
    row], [b1 row]); the masking row meets a zero column here. root_own /
    root_cross: int32 0/1 planes replacing the key's root bit (lead-in-hi
    layout). Masked slots give finite values the caller must mask. On
    CUDA tensors this launches the kernels (forward, and backward when
    differentiated), on CPU tensors it takes the plain versions. The JAX
    wrapper's `tb` (its TPU program tile) and `interpret` (Pallas
    interpret mode) have no counterpart here."""
    return FusedKeyHiddenSlots.apply(kown, kcross_al, u_ext, shift,
                                     out_dtype, root_own, root_cross)
