"""The join's merge of two sorted halves (port of
surel_plus_tpu/ops/merge_net.py:merge_pairs).

On a CUDA tensor `merge_pairs` launches the hand-written kernel
(ops/kernels/merge.py, csrc/merge.cu); on a CPU tensor it takes the plain
version. Either way the output equals a stable sort of the concatenation,
as the JAX merge networks' output does for the join's inputs.
"""

from __future__ import annotations

import torch

from surel_plus_tpu_torch.ops.kernels.build import pick
from surel_plus_tpu_torch.ops.kernels.merge import (
    merge_pairs_cuda,
    merge_pairs_plain,
)


def merge_pairs(keys_a: torch.Tensor, pay_a: torch.Tensor,
                keys_b: torch.Tensor, pay_b: torch.Tensor):
    """Merge per-row ascending (keys_a, keys_b) -> (keys, pay) [B, la+lb].

    keys_*: int32 bits of unsigned keys [B, L], ascending per row as
    unsigned values; pay_*: int32 [B, L]."""
    merge = pick("merge_pairs", keys_a, merge_pairs_cuda, merge_pairs_plain)
    return merge(keys_a, pay_a, keys_b, pay_b)
