"""The yardstick's arithmetic: the H100's peaks, the work a query needs,
and each kernel's least time.

Counts follow the work the inputs need, whatever implements it: only
valid slots count, and of the partner encodings only those present (an
absent partner's hidden row is the constant relu(b1)). For one query
(u, v) with sets S_u and S_v:

- O = |S_u| + |S_v|, the valid slots of both endpoints;
- H = 2 |S_u & S_v|, the slots whose partner holds the node.

Peaks (NVIDIA H100 SXM data sheet, dense): HBM 3.35 TB/s, TF32 tensor
cores 495 TFLOP/s, float32 CUDA cores 67 TFLOP/s; integer operations at
half the float32 rate (four warp instructions a clock, an FMA counting
two). Frozen copies of the repository's `chip_smoke.py` bounds
(`bound`, `k1_work`, `k1_bound`, `k1b_bound`, `attn_bound`,
`attn_bwd_bound`, K8's), counted over valid slots only.
"""

from __future__ import annotations

from typing import Tuple

import torch

from perfbench.reference.model import join

HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12
INT32_OPS = FP32_FLOPS / 2
# a threefry word: 20 rounds of an add, a rotate and a xor, 12 key
# additions, the counter's split and the final xor
THREEFRY_OPS = 20 * 3 + 12 + 2 + 1


def slot_counts(rows_u, rows_v) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, H) int64 [n] of the queries whose endpoint rows are rows_u and
    rows_v, each (nodes, khi, klo, sizes)."""
    own = torch.zeros(rows_u[0].shape[0], dtype=torch.int64,
                      device=rows_u[0].device)
    hits = torch.zeros_like(own)
    for a, b in ((rows_u, rows_v), (rows_v, rows_u)):
        mask, hi, lo = join(a, b)        # a present node's key is not 0
        own += mask.sum(dim=1)
        hits += (mask & ((hi != 0) | (lo != 0))).sum(dim=1)
    return own, hits


def forward_flops(own: float, hits: float, queries: float, ncol: int,
                  hidden: int, aggr: str) -> float:
    """FLOPs of the model's forward over queries with `own` valid slots
    and `hits` partner hits in all: the first layer over each valid slot
    and each hit (its products and bias), the pair sums and the set sums,
    the projection once a set (it is linear and comes after the sum), the
    attention's gate dot and weighted sum a valid slot and its value layer
    once a set, and the scorer."""
    h = hidden
    first = (own + hits) * 2 * (ncol + 1) * h
    sums = 2 * own * h
    per_set = 2 * h * h + h
    flops = first + sums + 2 * queries * per_set
    if aggr == "attn":
        flops += own * 4 * h + 2 * queries * per_set
    scorer = 2 * (2 * h) * h + h + 2 * h + 1
    return flops + queries * scorer


def least_ms(nbytes: float, tc_flops: float = 0.0, fp32_ops: float = 0.0,
             int_ops: float = 0.0) -> Tuple[float, str]:
    """(least time in ms, what bounds it): the largest of the bytes at the
    memory rate and each unit's operations at its peak."""
    t = {"bytes": nbytes / HBM_BYTES_PER_S,
         "tensor cores": tc_flops / TF32_FLOPS,
         "cuda cores": fp32_ops / FP32_FLOPS,
         "integer": int_ops / INT32_OPS}
    by = max(t, key=t.get)
    return t[by] * 1e3, by


def hidden_sum_ms(own: float, hits: float, queries: float, ncol: int,
                  hidden: int, backward: bool) -> float:
    """K1's (or K1 bwd's) least time over a batch: each computed slot's z
    on the tensor cores (its encoding and the bias), a relu a channel and
    the sums on the CUDA cores; a valid slot's own and partner key words
    and masks read once, the [2, B, h] sums written (read, backward). The
    backward's dU products, which depend on the signs of z, are left out:
    its share reads low, never high."""
    h = hidden
    tc = (own + hits) * 2 * (ncol + 1) * h
    cuda = (own + hits) * h + (0 if backward else 2 * own * h)
    nbytes = own * 10 + 2 * queries * h * 4 + (ncol + 2) * h * 4
    return least_ms(nbytes, tc_flops=tc, fp32_ops=cuda)[0]


def attn_pool_ms(own: float, hits: float, queries: float, ncol: int,
                 hidden: int, backward: bool) -> float:
    """K3's (or K3 bwd's) least time over a batch: each computed slot's z
    on the tensor cores (its encoding and the bias), as `hidden_sum_ms`
    counts the same products; a relu a channel, and a valid slot's pair
    sum, gate and pool multiply-adds and its softmax terms (the backward:
    the hidden row again, da, dhs and dgvec, and the weight, t and dgate)
    on the CUDA cores; a valid slot's key words and mask read once, the
    pooled rows written (read). The backward's dU work where z > 0 is left
    out."""
    h = hidden
    tc = (own + hits) * 2 * (ncol + 1) * h
    cuda = (own + hits) * h
    cuda += own * (h * 10 + 8) if backward else own * (h * 5 + 2)
    nbytes = own * 9 + 2 * queries * (h + 2) * 4 + (ncol + 2) * h * 4
    return least_ms(nbytes, tc_flops=tc, fp32_ops=cuda)[0]


def threefry_ms(words: float) -> float:
    """K8's least time for `words` int64 words: written once, and its
    integer operations."""
    return least_ms(8 * words, int_ops=THREEFRY_OPS * words)[0]

