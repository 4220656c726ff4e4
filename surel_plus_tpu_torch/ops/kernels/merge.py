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
# la + lb: a row's keys, payloads and output tile (16 bytes a word) must fit
# one block's shared memory
MAX_ROW = 12288
# threads that share a row in the kernel: a warp while four rows fit 48 KB
WARP_ROW_THREADS, BLOCK_ROW_THREADS = 32, 128


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


def merge_path_corank(keys_a, keys_b, d):
    """The kernel's partition: for each row, the number of keys_a's entries
    among the first d outputs (d: int64 [B] or [B, T], 0 <= d <= la + lb):
    the least i with a[i] > b[d - 1 - i], found by a binary search over
    max(0, d - lb) <= i <= min(d, la). An entry a[i] precedes b[j] while
    a[i] <= b[j] (unsigned), so a comes first on ties."""
    ua = keys_a.to(torch.int64) & 0xFFFFFFFF
    ub = keys_b.to(torch.int64) & 0xFFFFFFFF
    la, lb = ua.shape[1], ub.shape[1]
    d = d.reshape(ua.shape[0], -1)
    lo = (d - lb).clamp(min=0)
    hi = d.clamp(max=la)
    while bool((lo < hi).any()):   # then la, lb >= 1
        go = lo < hi
        mid = (lo + hi) // 2
        up = go & (ua.gather(1, mid.clamp(max=la - 1))
                   <= ub.gather(1, (d - 1 - mid).clamp(0, lb - 1)))
        lo = torch.where(up, mid + 1, lo)
        hi = torch.where(go & ~up, mid, hi)
    return lo


def merge_pairs_path(keys_a, pay_a, keys_b, pay_b,
                     threads: int = WARP_ROW_THREADS):
    """The kernel's merge path on the CPU: `threads` runs of
    P = ceil((la + lb) / threads) outputs a row, each starting at its
    co-rank split (`merge_path_corank`) and merged sequentially, a[i]
    taken while a[i] <= b[j]. Equal to `merge_pairs_plain`."""
    rows, la = keys_a.shape
    lb = keys_b.shape[1]
    n = la + lb
    p = -(-n // threads)
    d = (torch.arange(threads) * p).clamp(max=n).expand(rows, threads)
    i = merge_path_corank(keys_a, keys_b, d)
    j = d - i
    # one column past each side, so that a used-up side gathers in range
    ext = lambda t: torch.cat([t, t.new_zeros(rows, 1)], dim=1)
    ka, kb, pa, pb = ext(keys_a), ext(keys_b), ext(pay_a), ext(pay_b)
    ua = ka.to(torch.int64) & 0xFFFFFFFF
    ub = kb.to(torch.int64) & 0xFFFFFFFF
    keys = keys_a.new_zeros(rows, n)
    pay = pay_a.new_zeros(rows, n)
    row = torch.arange(rows)[:, None].expand(rows, threads)
    for k in range(p):
        live = d + k < n
        take_a = (j >= lb) | ((i < la) & (ua.gather(1, i) <= ub.gather(1, j)))
        keys[row[live], (d + k)[live]] = torch.where(
            take_a, ka.gather(1, i), kb.gather(1, j))[live]
        pay[row[live], (d + k)[live]] = torch.where(
            take_a, pa.gather(1, i), pb.gather(1, j))[live]
        i = i + (take_a & live)
        j = j + (~take_a & live)
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
