"""Cross lookup of both key words in both directions of a join: the CUDA
kernel `csrc/cross_lookup.cu` (K6), its plain PyTorch version, and the
wrapper that picks between them.

Replaces surel_plus_tpu/ops/pallas/join_kernel.py `pallas_cross_lookup_pair`
(the kernel `_join_kernel`, called once a direction), the keys join's
impl="pallas". For rows nodes_u, nodes_v [B, L] (int32 node ids, INT32_MAX
padding) and payload words hi_u, lo_u, hi_v, lo_v [B, L] (int32 tensors
holding uint32 bits): for each row and slot i of u, the payloads of the
slots j of v with v[j] == u[i], summed mod 2^32, and 0 where u[i] is
padding; and the same for v's slots in u. On sets (distinct nodes per row,
as the sampler makes them) that is the payload of the node's slot in the
other row, or 0 when that row lacks the node. The TPU kernel sums 16-bit
halves over an f32 equality contraction, which equals this on sets.
"""

from __future__ import annotations

import ctypes

import torch

from surel_plus_tpu_torch.ops.kernels.build import (
    CudaKernel,
    check_cuda,
    pick,
    ptr,
)
from surel_plus_tpu_torch.ops.walk import INT32_MAX, to_bits, u32

KERNEL = CudaKernel("cross_lookup", "cross_lookup_pair_launch",
                    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2
                    + [ctypes.c_void_p])
MAX_L = 232448 // 8 - 8             # both node rows in shared memory
PLAIN_CHUNK = 1 << 27               # [rows, L, L] entries per plain pass


def _mask_lookup(nodes_a, nodes_b, hi_b, lo_b):
    """One direction: the literal [B, L, L] equality mask, contracted
    against each word in int64, a block of rows at a time (at most
    PLAIN_CHUNK mask entries). Returns (cross_hi, cross_lo) int32 bits."""
    rows, ell = nodes_a.shape
    step = max(1, PLAIN_CHUNK // max(1, ell * ell))
    outs = []
    for s in range(0, rows, step):
        a, b = nodes_a[s:s + step], nodes_b[s:s + step]
        eq = ((a[:, :, None] == b[:, None, :])
              & (a != INT32_MAX)[:, :, None])               # [b, L, L]
        outs.append([to_bits(torch.where(
            eq, u32(w[s:s + step])[:, None, :], 0).sum(dim=-1) & 0xFFFFFFFF)
            for w in (hi_b, lo_b)])
    if not outs:
        return torch.zeros_like(hi_b), torch.zeros_like(lo_b)
    return tuple(torch.cat(ws) for ws in zip(*outs))


def cross_lookup_pair_plain(nodes_u, nodes_v, hi_u, lo_u, hi_v, lo_v):
    """The literal equality mask in plain PyTorch, in both directions; any
    row order. Returns (cross_hi_u, cross_lo_u, cross_hi_v, cross_lo_v)."""
    return (*_mask_lookup(nodes_u, nodes_v, hi_v, lo_v),
            *_mask_lookup(nodes_v, nodes_u, hi_u, lo_u))


def cross_lookup_pair_cuda(nodes_u, nodes_v, hi_u, lo_u, hi_v, lo_v):
    """Launch K6 once for both directions; see csrc/cross_lookup.cu. All
    six: contiguous int32 [B, L] CUDA tensors, every row of nodes_u and
    nodes_v ascending (INT32_MAX padding last). Returns (cross_hi_u,
    cross_lo_u, cross_hi_v, cross_lo_v) int32 [B, L]."""
    rows, ell = nodes_u.shape
    dev = nodes_u.device
    for name, t in (("nodes_u", nodes_u), ("nodes_v", nodes_v),
                    ("hi_u", hi_u), ("lo_u", lo_u), ("hi_v", hi_v),
                    ("lo_v", lo_v)):
        check_cuda(name, t, torch.int32, (rows, ell), dev)
    if ell > MAX_L:
        raise ValueError(f"row width {ell} exceeds {MAX_L}")
    outs = [torch.empty(rows, ell, dtype=torch.int32, device=dev)
            for _ in range(4)]
    if rows and ell:
        KERNEL(dev, *map(ptr, (nodes_u, nodes_v, hi_u, lo_u, hi_v, lo_v,
                               *outs)), rows, ell)
    return tuple(outs)


def cross_lookup_pair(nodes_u: torch.Tensor, nodes_v: torch.Tensor,
                      hi_u: torch.Tensor, lo_u: torch.Tensor,
                      hi_v: torch.Tensor, lo_v: torch.Tensor):
    """(cross_hi_u, cross_lo_u, cross_hi_v, cross_lo_v) int32 [B, L]: for
    each slot of nodes_u the (hi, lo) payload words of the same node in
    nodes_v, 0 if absent, and for each slot of nodes_v those of nodes_u.
    Every row must be ascending with INT32_MAX padding last, as SpGKeys
    rows are. On CUDA tensors this launches K6 once, on CPU tensors it
    takes the plain version."""
    fn = pick("cross_lookup", nodes_u, cross_lookup_pair_cuda,
              cross_lookup_pair_plain)
    c = lambda t: t.to(torch.int32).contiguous()
    return fn(*map(c, (nodes_u, nodes_v, hi_u, lo_u, hi_v, lo_v)))
