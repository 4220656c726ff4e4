"""The mean aggregator: the average of the rows of a set's valid slots.
No weights of its own."""

import torch


def shapes(hidden: int) -> dict:
    return {}


def pool(x: torch.Tensor, mask: torch.Tensor, w) -> torch.Tensor:
    """x [n, L, h], mask [n, L] -> [n, h]."""
    cnt = mask.sum(dim=1, keepdim=True).clamp(min=1).to(torch.float32)
    return torch.where(mask[..., None], x, 0.0).sum(dim=1) / cnt
