"""The attention aggregator: the rows of a set's valid slots weighed by a
softmax over the set of a scalar gate (Wg x + bg), summing their value
rows (Wv x + bv)."""

import torch
from torch.nn import functional as F


def shapes(hidden: int) -> dict:
    return {"aggr.gate_nn.weight": (1, hidden), "aggr.gate_nn.bias": (1,),
            "aggr.value_nn.weight": (hidden, hidden),
            "aggr.value_nn.bias": (hidden,)}


def pool(x: torch.Tensor, mask: torch.Tensor, w) -> torch.Tensor:
    """x [n, L, h], mask [n, L] -> [n, h]."""
    m = mask[..., None]
    gate = torch.where(m, F.linear(x, w["aggr.gate_nn.weight"],
                                   w["aggr.gate_nn.bias"]), -torch.inf)
    att = torch.where(m, torch.softmax(gate, dim=1), 0.0)
    return (att * F.linear(x, w["aggr.value_nn.weight"],
                           w["aggr.value_nn.bias"])).sum(dim=1)
