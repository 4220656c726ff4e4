"""Cross lookup of both key words: the CUDA kernel `csrc/cross_lookup.cu`
(K6), its plain PyTorch version and the wrapper that picks between them.

Replaces surel_plus_tpu/ops/pallas/join_kernel.py `pallas_cross_lookup_pair`
(the kernel `_join_kernel`), the keys join's impl="pallas". For rows
nodes_a, nodes_b [B, L] (int32 node ids, INT32_MAX padding) and payload
words hi_b, lo_b [B, L] (int32 tensors holding uint32 bits), for each row
and slot i of a, the payloads of the slots j of b with b[j] == a[i],
summed mod 2^32, and 0 where a[i] is padding: on sets (distinct nodes per
row, as the sampler makes them) the payload of a[i]'s slot in b, or 0
when b lacks the node. The TPU kernel sums 16-bit halves over an f32
equality contraction, which equals this on sets.
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

KERNEL = CudaKernel("cross_lookup", "cross_lookup_launch",
                    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                    + [ctypes.c_void_p])
MAX_L = (232448 - 1024) // 12   # b and its two words in shared memory
PLAIN_CHUNK = 1 << 27           # [rows, L, L] entries per plain pass


def cross_lookup_plain(nodes_a, nodes_b, hi_b, lo_b):
    """The literal [B, L, L] equality mask in plain PyTorch, contracted
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


def cross_lookup_cuda(nodes_a, nodes_b, hi_b, lo_b):
    """Launch K6; see csrc/cross_lookup.cu. All four: contiguous int32
    [B, L] CUDA tensors. Returns (cross_hi, cross_lo) int32 [B, L]."""
    rows, ell = nodes_a.shape
    dev = nodes_a.device
    for name, t in (("nodes_a", nodes_a), ("nodes_b", nodes_b),
                    ("hi_b", hi_b), ("lo_b", lo_b)):
        check_cuda(name, t, torch.int32, (rows, ell), dev)
    if ell > MAX_L:
        raise ValueError(f"row width {ell} exceeds {MAX_L}")
    cross_hi = torch.empty(rows, ell, dtype=torch.int32, device=dev)
    cross_lo = torch.empty_like(cross_hi)
    if rows and ell:
        KERNEL(dev, ptr(nodes_a), ptr(nodes_b), ptr(hi_b), ptr(lo_b),
               ptr(cross_hi), ptr(cross_lo), rows, ell)
    return cross_hi, cross_lo


def cross_lookup(nodes_a: torch.Tensor, nodes_b: torch.Tensor,
                 hi_b: torch.Tensor, lo_b: torch.Tensor):
    """(cross_hi, cross_lo) int32 [B, L]: for each slot of nodes_a, the
    (hi, lo) payload words of the same node in nodes_b, 0 if absent. On
    CUDA tensors this launches K6, on CPU tensors it takes the plain
    version."""
    fn = pick("cross_lookup", nodes_a, cross_lookup_cuda, cross_lookup_plain)
    c = lambda t: t.to(torch.int32).contiguous()
    return fn(c(nodes_a), c(nodes_b), c(hi_b), c(lo_b))
