"""The benchmark's graph: an R-MAT edge list drawn on the device from the
seed, at a dataset's own node and edge counts.

R-MAT (Chakrabarti et al., SDM 2004) with the configuration's quadrant
probabilities: each pair picks one quadrant of the adjacency matrix a
level at a time; a pair with an id past the node count is dropped (no
id takes a second id's mass). Ids are relabelled by a random permutation
of the nodes (Graph500's relabelling, so that no id order follows the
degree). Every node first draws one edge to a partner taken from
R-MAT's cited side (its first reference: the datasets hold almost no
isolated node, where plain R-MAT at their density leaves 19-45% of the
nodes alone), and R-MAT pairs fill the rest. Edges are
made undirected without self-loops and merged; exactly `num_edges`
distinct edges are kept, in a random order. Every seed draws the same
number of edges.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

# R-MAT pairs drawn for each edge still wanted: room for the pairs that
# are dropped (past the node count, self-loops, repeats)
OVERDRAW = 1.6


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator on `device` for one use of the seed (`stream`)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + stream) & ((1 << 63) - 1))
    return g


def rmat_pairs(count: int, num_nodes: int, abc: Sequence[float],
               g: torch.Generator, device):
    """(src, dst) int64 of `count` R-MAT draws, the pairs with an id past
    `num_nodes` dropped, before relabelling."""
    scale = max(1, math.ceil(math.log2(max(num_nodes, 2))))
    pa, pb, pc = abc[0], abc[0] + abc[1], abc[0] + abc[1] + abc[2]
    src = torch.zeros(count, dtype=torch.int64, device=device)
    dst = torch.zeros_like(src)
    for _ in range(scale):
        r = torch.rand(count, generator=g, device=device)
        src = src * 2 + (r >= pb)
        dst = dst * 2 + (((r >= pa) & (r < pb)) | (r >= pc))
    keep = (src < num_nodes) & (dst < num_nodes)
    return src[keep], dst[keep]


def edge_keys(src: torch.Tensor, dst: torch.Tensor, num_nodes: int
              ) -> torch.Tensor:
    """lo * n + hi of each pair that is no self-loop, sorted, distinct."""
    keep = src != dst
    lo = torch.minimum(src, dst)[keep]
    hi = torch.maximum(src, dst)[keep]
    return torch.unique(lo * num_nodes + hi)


def rmat_edges(num_nodes: int, num_edges: int, seed: int, device,
               rmat_abc: Sequence[float]) -> torch.Tensor:
    """int32 [num_edges, 2] distinct undirected edges (lower id first),
    in a random order, on `device`."""
    n = num_nodes
    g = generator(seed, device, 1)
    relabel = torch.randperm(n, generator=g, device=device)
    partner = torch.empty(0, dtype=torch.int64, device=device)
    while partner.numel() < n:
        _, dst = rmat_pairs(int((n - partner.numel()) * OVERDRAW) + 16, n,
                            rmat_abc, g, device)
        partner = torch.cat([partner, dst])
    fixed = edge_keys(torch.arange(n, device=device), relabel[partner[:n]],
                      n)
    del partner
    uniq = torch.empty(0, dtype=torch.int64, device=device)
    need = num_edges - fixed.numel()
    while uniq.numel() < need:
        src, dst = rmat_pairs(int((need - uniq.numel()) * OVERDRAW) + 16, n,
                              rmat_abc, g, device)
        uniq = torch.unique(torch.cat([uniq, edge_keys(
            relabel[src], relabel[dst], n)]))
        del src, dst
        uniq = uniq[~torch.isin(uniq, fixed)]
    pick = torch.randperm(uniq.numel(), generator=g, device=device)
    chosen = torch.cat([fixed, uniq[pick[:need]]])
    del uniq, pick, fixed
    chosen = chosen[torch.randperm(num_edges, generator=g, device=device)]
    return torch.stack([chosen // n, chosen % n], dim=1).to(torch.int32)
