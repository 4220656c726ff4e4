"""Synthetic graph generators (port of surel_plus_tpu/graph/synthetic.py).

RMAT stands in for the power-law OGB graphs the reference benchmarks on;
the Erdos-Renyi graph a uniform one; the ring of cliques is a small
structured graph for the tests.
"""

from __future__ import annotations

import numpy as np

from surel_plus_tpu_torch.graph.csr import CSRGraph, csr_from_edges


def rmat_graph(
    num_nodes: int,
    num_edges: int,
    seed: int = 0,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
) -> CSRGraph:
    """R-MAT power-law generator (Chakrabarti et al.), vectorized.

    Produces an undirected simple graph with ~num_edges unique edges.
    """
    rng = np.random.default_rng(seed)
    scale = max(1, int(np.ceil(np.log2(max(num_nodes, 2)))))
    n_gen = int(num_edges * 1.15) + 16
    src = np.zeros(n_gen, dtype=np.int64)
    dst = np.zeros(n_gen, dtype=np.int64)
    pa, pb, pc = a, a + b, a + b + c
    for _ in range(scale):
        r = rng.random(n_gen)
        src <<= 1
        dst <<= 1
        # quadrant choice: a -> (0,0), b -> (0,1), c -> (1,0), d -> (1,1)
        dst |= ((r >= pa) & (r < pb)) | (r >= pc)
        src |= (r >= pb)
    src %= num_nodes
    dst %= num_nodes
    edges = np.stack([src, dst], axis=1)
    edges = edges[src != dst][:num_edges]
    return csr_from_edges(edges, num_nodes=num_nodes)


def erdos_renyi(num_nodes: int, num_edges: int, seed: int = 0) -> CSRGraph:
    """Uniform random graph: about num_edges random node pairs, self
    loops dropped, symmetrized and coalesced (weights summed)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, num_nodes, size=int(num_edges * 1.1) + 8)
    dst = rng.integers(0, num_nodes, size=len(src))
    edges = np.stack([src, dst], axis=1)
    edges = edges[src != dst][:num_edges]
    return CSRGraph.from_scipy(
        csr_from_edges(edges, num_nodes=num_nodes).to_scipy())


def ring_of_cliques(num_cliques: int, clique_size: int) -> CSRGraph:
    """num_cliques cliques of clique_size nodes, adjacent cliques bridged."""
    edges = []
    for q in range(num_cliques):
        base = q * clique_size
        for i in range(clique_size):
            for j in range(i + 1, clique_size):
                edges.append((base + i, base + j))
        nxt = ((q + 1) % num_cliques) * clique_size
        edges.append((base, nxt))
    return csr_from_edges(np.array(edges, dtype=np.int64),
                          num_nodes=num_cliques * clique_size)


def rmat_pairs_chunked(n: int, draws: int, seed: int,
                       chunk: int = 20_000_000) -> np.ndarray:
    """Directed R-MAT pairs [E, 2] int32 drawn `chunk` at a time: the JAX
    package's `scripts/scale_demo.py:rmat_pairs_chunked` (the same draws
    from `default_rng(seed)`, self-loops dropped, duplicates left for the
    CSR build's coalesce). The pairs go straight into one [draws, 2]
    buffer whose unused tail is never touched, and each chunk's work
    arrays are reused, so the host holds the pairs and about one chunk
    beyond them."""
    rng = np.random.default_rng(seed)
    scale = max(1, int(np.ceil(np.log2(max(n, 2)))))
    pa, pb, pc = 0.57, 0.76, 0.95
    out = np.empty((draws, 2), np.int32)
    width = min(chunk, draws)
    src, dst = np.empty(width, np.int64), np.empty(width, np.int64)
    r = np.empty(width)
    bit, tmp = np.empty(width, bool), np.empty(width, bool)
    kept = 0
    for done in range(0, draws, chunk):
        m = min(chunk, draws - done)
        s, d, rr, b, t = src[:m], dst[:m], r[:m], bit[:m], tmp[:m]
        s[:] = 0
        d[:] = 0
        for _ in range(scale):
            rng.random(out=rr)
            s <<= 1
            d <<= 1
            # quadrant: b and d set the destination's bit, c and d the
            # source's (rmat_graph's choice)
            np.greater_equal(rr, pa, out=b)
            np.less(rr, pb, out=t)
            b &= t
            np.greater_equal(rr, pc, out=t)
            b |= t
            d |= b
            np.greater_equal(rr, pb, out=b)
            s |= b
        s %= n
        d %= n
        np.not_equal(s, d, out=b)
        k = int(np.count_nonzero(b))
        out[kept:kept + k, 0] = s[b]
        out[kept:kept + k, 1] = d[b]
        kept += k
    return out[:kept]
