"""The benchmark's queries and weights, drawn on the device from the seed.

Training: the first `train_ratio` share of the (randomly ordered) edges
are the positive queries, held out of the graph the sets are sampled on;
each has `negatives` uniform node pairs, label 0. Scoring: `sources`
edges drawn at random, each oriented at random into (source, positive),
and `candidates` uniform negative nodes per source. Weights: a
xavier-normal draw for each weight matrix and a normal of deviation 0.1
for each bias, from one base draw, hidden channels permuted by the seed.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from perfbench.gen.graph import generator
from perfbench.reference.model import aggregator


def training_split(edges: torch.Tensor, train_ratio: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(positives [P, 2], the observed edges left) of a randomly ordered
    edge list."""
    p = int(round(train_ratio * edges.shape[0]))
    return edges[:p], edges[p:]


def training_queries(pos: torch.Tensor, num_nodes: int, negatives: int,
                     seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Query edges int64 [2, P (1 + negatives)] (positives first) and
    their 0/1 labels float32."""
    dev = pos.device
    g = generator(seed, dev, 2)
    p = pos.shape[0]
    neg = torch.randint(0, num_nodes, (2, p * negatives), generator=g,
                        device=dev)
    edges = torch.cat([pos.t().to(torch.int64), neg], dim=1)
    labels = torch.cat([torch.ones(p, device=dev),
                        torch.zeros(p * negatives, device=dev)])
    return edges, labels


def ranking_queries(edges: torch.Tensor, num_nodes: int, sources: int,
                    candidates: int, seed: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(positives int64 [2, sources], negatives int64 [2, sources *
    candidates]): the negatives of source i are columns i * candidates ..
    (i + 1) * candidates - 1."""
    dev = edges.device
    g = generator(seed, dev, 3)
    pick = torch.randint(0, edges.shape[0], (sources,), generator=g,
                         device=dev)
    flip = torch.randint(0, 2, (sources,), generator=g, device=dev)
    e = edges[pick].to(torch.int64)
    src = torch.where(flip == 1, e[:, 1], e[:, 0])
    dst = torch.where(flip == 1, e[:, 0], e[:, 1])
    neg_dst = torch.randint(0, num_nodes, (sources * candidates,),
                            generator=g, device=dev)
    neg = torch.stack([src.repeat_interleave(candidates), neg_dst])
    return torch.stack([src, dst]), neg


def weight_shapes(aggr: str, ncol: int, hidden: int
                  ) -> Dict[str, Sequence[int]]:
    """The model's weights by the program's module names, Linear layout
    [out, in]: the set encoder's two layers, the aggregator's own (its
    reference module's `shapes`), the scorer's two layers."""
    shapes = {
        "pe_embedding.fc0.weight": (hidden, ncol),
        "pe_embedding.fc0.bias": (hidden,),
        "pe_embedding.fc1.weight": (hidden, hidden),
        "pe_embedding.fc1.bias": (hidden,),
    }
    shapes.update(aggregator(aggr).shapes(hidden))
    shapes.update({
        "affinity_score.fc0.weight": (hidden, 2 * hidden),
        "affinity_score.fc0.bias": (hidden,),
        "affinity_score.fc1.weight": (1, hidden),
        "affinity_score.fc1.bias": (1,),
    })
    return shapes


# the seed of the one weight draw that every run's weights permute
BASE_WEIGHTS = 0


def weights(aggr: str, ncol: int, hidden: int, seed: int, device
            ) -> Dict[str, torch.Tensor]:
    """The model's float32 weights on `device`: one base draw, the same
    for every seed, with the hidden channels of the encoder's first layer
    and of the scorer's first layer permuted by the seed. Every seed gets
    the same weights in another order, so the same model: K1's work hangs
    on the weights (it rechecks the z that lie near 0), and the seed
    should not change the work."""
    shapes = weight_shapes(aggr, ncol, hidden)
    sizes = [int(torch.Size(s).numel()) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=generator(BASE_WEIGHTS, device,
                                                       4), device=device)
    out, lo = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        x = flat[lo:lo + n].reshape(shape)
        lo += n
        if len(shape) == 2:
            x = x * (2.0 / (shape[0] + shape[1])) ** 0.5
        else:
            x = x * 0.1
        out[name] = x
    g = generator(seed, device, 4)
    for layer, after in (("pe_embedding.fc0", "pe_embedding.fc1"),
                         ("affinity_score.fc0", "affinity_score.fc1")):
        p = torch.randperm(hidden, generator=g, device=device)
        out[layer + ".weight"] = out[layer + ".weight"][p]
        out[layer + ".bias"] = out[layer + ".bias"][p]
        out[after + ".weight"] = out[after + ".weight"][:, p]
    return {k: v.contiguous() for k, v in out.items()}
