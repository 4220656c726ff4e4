"""Merge of two per-row sorted key rows with one payload each: the CUDA
kernel `csrc/merge.cu` and its plain PyTorch version.

Replaces surel_plus_tpu/ops/pallas/bitonic_merge.py (`_merge_kernel`)
and its XLA twin merge_net.py:merge_pairs_xor. Both versions compute the
same function: for keys_a [B, la] and keys_b [B, lb], each row ascending
as unsigned 32-bit values, the keys and payloads [B, la+lb] of a stable
sort of concat(a, b) (a before b on equal keys). Keys and payloads are
int32 tensors holding the unsigned words' bits.
"""

from __future__ import annotations

import ctypes

import torch

from surel_plus_tpu_torch.ops.kernels.build import CudaKernel, check_cuda, ptr

KERNEL = CudaKernel("merge", "merge_pairs_launch",
                    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                    + [ctypes.c_void_p])
MAX_ROW = 12288  # la + lb keys must fit the 48 KB of static shared memory


def merge_pairs_plain(keys_a, pay_a, keys_b, pay_b):
    """Merge by rank: a[i] lands at i + #{b < a[i]}, b[j] at
    j + #{a <= b[j]} (unsigned compares, via int64)."""
    ua = keys_a.to(torch.int64) & 0xFFFFFFFF
    ub = keys_b.to(torch.int64) & 0xFFFFFFFF
    rows, la = ua.shape
    lb = ub.shape[1]
    dev = ua.device
    pos_a = torch.arange(la, device=dev) + torch.searchsorted(ub, ua)
    pos_b = torch.arange(lb, device=dev) + torch.searchsorted(ua, ub,
                                                              right=True)
    keys = keys_a.new_empty(rows, la + lb)
    pay = pay_a.new_empty(rows, la + lb)
    keys.scatter_(1, pos_a, keys_a)
    keys.scatter_(1, pos_b, keys_b)
    pay.scatter_(1, pos_a, pay_a)
    pay.scatter_(1, pos_b, pay_b)
    return keys, pay


def merge_pairs_cuda(keys_a, pay_a, keys_b, pay_b):
    """Launch the merge kernel on CUDA int32 tensors."""
    rows, la = keys_a.shape
    lb = keys_b.shape[1]
    dev = keys_a.device
    check_cuda("keys_a", keys_a, torch.int32, (rows, la), dev)
    check_cuda("pay_a", pay_a, torch.int32, (rows, la), dev)
    check_cuda("keys_b", keys_b, torch.int32, (rows, lb), dev)
    check_cuda("pay_b", pay_b, torch.int32, (rows, lb), dev)
    if la + lb > MAX_ROW:
        raise ValueError(f"merged row width {la + lb} exceeds {MAX_ROW}")
    keys = torch.empty(rows, la + lb, dtype=torch.int32, device=dev)
    pay = torch.empty(rows, la + lb, dtype=torch.int32, device=dev)
    if rows:
        KERNEL(dev, ptr(keys_a), ptr(pay_a), ptr(keys_b), ptr(pay_b),
               ptr(keys), ptr(pay), rows, la, lb)
    return keys, pay
