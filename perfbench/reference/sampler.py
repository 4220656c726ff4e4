"""Plain reference of the set sampler: the walk graph built again from the
edge list, each seed's walks from the seed's key tree, and the seed's set
with its packed landing-count keys, row by row.

Semantics (SUREL+'s walk-based set sampler, in the program's key layout):
the graph is the edge list made undirected, self-loops dropped,
duplicates merged, each row ascending. Seed r of a call runs in block
b = r // block_size, whose key is fold_in(key_of(seed), b + 1); walk step
t > 0 draws bits(split(block key, S' - 1)[t - 1], [block, M]) at the
seed's row of the block. The first hop of walk m takes entry m % deg of
the seed's row shuffled by `draws.shuffled_row`, a later hop entry
bits % deg of the current node's sorted row; a walker on a node of no
neighbours stays. The set is the seed and every node visited, ascending;
a slot's key packs the visits of its node at each step in fields of
bit_length(M) bits (step S' lowest), never straddling the 32-bit word,
and a root bit above them.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from perfbench.reference import draws

INT32_MAX = 2**31 - 1


class RefGraph:
    """The undirected walk graph of an edge list [E, 2] (int tensor, any
    device): one sort of the packed (source, target) pairs."""

    def __init__(self, edges: torch.Tensor, num_nodes: int):
        e = edges.to(torch.int64)
        src = torch.cat([e[:, 0], e[:, 1]])
        dst = torch.cat([e[:, 1], e[:, 0]])
        keep = src != dst
        pairs = torch.unique((src[keep] << 32) | dst[keep])   # sorted
        del src, dst, keep
        self.src = (pairs >> 32).to(torch.int32)
        self.dst = (pairs & 0xFFFFFFFF).to(torch.int32)
        self.indptr = torch.searchsorted(
            self.src, torch.arange(num_nodes + 1, dtype=torch.int32,
                                   device=edges.device))
        self.num_nodes = num_nodes

    def rows(self, nodes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(start, degree) of each node, int64 on the graph's device."""
        nodes = nodes.to(torch.int64)
        start = self.indptr[nodes]
        return start, self.indptr[nodes + 1] - start

    def row(self, node: int) -> List[int]:
        lo, hi = int(self.indptr[node]), int(self.indptr[node + 1])
        return self.dst[lo:hi].tolist()


def key_layout(num_walks: int, num_steps: int) -> Tuple[int, Dict[int, int],
                                                        int]:
    """(field bits, start bit of each step's field, root bit)."""
    shift = int(num_walks).bit_length()
    starts, bit = {}, 0
    for j in range(num_steps, 0, -1):
        if bit < 32 < bit + shift:
            bit = 32
        starts[j] = bit
        bit += shift
    if bit < 32 < bit + 1:
        bit = 32
    return shift, starts, bit


def walks(graph: RefGraph, seeds: Sequence[int], rows: Sequence[int],
          num_walks: int, num_steps: int, seed: int, block_size: int,
          shuffle_seed: int) -> torch.Tensor:
    """The walks int64 [n, num_walks, num_steps] of the seeds at call rows
    `rows` (their positions in the sampler's seed list)."""
    dev = graph.dst.device
    root = draws.key_of(seed)
    n = len(seeds)
    m = torch.arange(num_walks, device=dev)
    # first hop: the shuffled row of each seed
    first = torch.empty(n, num_walks, dtype=torch.int64, device=dev)
    for i, s in enumerate(seeds):
        row = draws.shuffled_row(graph.row(int(s)), shuffle_seed, int(s))
        if row:
            pick = m % len(row)
            first[i] = torch.as_tensor(row, device=dev)[pick]
        else:
            first[i] = int(s)
    out = [first]
    cur = first
    if num_steps > 1:
        step_bits = torch.empty(num_steps - 1, n, num_walks,
                                dtype=torch.int64, device=dev)
        rows_t = torch.as_tensor(np.asarray(rows, np.int64), device=dev)
        for b in sorted({int(r) // block_size for r in rows}):
            sel = torch.nonzero(rows_t // block_size == b)[:, 0]
            ctr = ((rows_t[sel] - b * block_size)[:, None] * num_walks
                   + m[None, :])
            for t, k in enumerate(draws.split(
                    draws.fold_in(root, b + 1), num_steps - 1)):
                w0, w1 = draws.threefry2x32(k[0], k[1], ctr >> 32,
                                            ctr & draws.MASK)
                step_bits[t, sel] = w0 ^ w1
        for t in range(num_steps - 1):
            start, deg = graph.rows(cur)
            live = deg > 0
            idx = (start + step_bits[t] % deg.clamp(min=1)).clamp(
                max=graph.dst.shape[0] - 1)
            cur = torch.where(live, graph.dst[idx].to(torch.int64), cur)
            out.append(cur)
    return torch.stack(out, dim=-1)


def sets(graph: RefGraph, seeds: Sequence[int], rows: Sequence[int],
         num_walks: int, num_steps: int, bucket: int, seed: int,
         block_size: int, shuffle_seed: int):
    """The sets of the seeds at call rows `rows`: (nodes int32 [n, bucket]
    padded with INT32_MAX, sizes int32 [n], khi, klo int32 bit patterns
    [n, bucket]), on the graph's device."""
    w = walks(graph, seeds, rows, num_walks, num_steps, seed, block_size,
              shuffle_seed).cpu().numpy()
    _, starts, lead = key_layout(num_walks, num_steps)
    n = len(seeds)
    nodes = np.full((n, bucket), INT32_MAX, np.int64)
    keys = np.zeros((n, bucket), np.int64)
    sizes = np.zeros(n, np.int64)
    for i, s in enumerate(seeds):
        visited = {int(s): 1 << lead}
        for j in range(1, num_steps + 1):
            for v in w[i, :, j - 1].tolist():
                visited[v] = visited.get(v, 0) + (1 << starts[j])
        order = sorted(visited)[:bucket]
        sizes[i] = len(order)
        nodes[i, :len(order)] = order
        keys[i, :len(order)] = [visited[v] for v in order]
    hi = (keys >> 32).astype(np.uint32).view(np.int32)
    lo = (keys & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    dev = graph.dst.device
    return (torch.as_tensor(nodes.astype(np.int32), device=dev),
            torch.as_tensor(sizes.astype(np.int32), device=dev),
            torch.as_tensor(hi, device=dev), torch.as_tensor(lo, device=dev))
