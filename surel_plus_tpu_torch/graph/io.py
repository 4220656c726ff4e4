"""Graph files: edge lists and npz archives (port of
surel_plus_tpu/graph/io.py; numpy only, and the same file layouts, so
that either package reads what the other writes).

An edge list is whitespace-separated `src dst` lines (further columns
ignored, `#` comments); a graph npz holds `indptr`, `indices` and `data`
(empty for an unweighted graph).
"""

from __future__ import annotations

import numpy as np

from surel_plus_tpu_torch.graph.csr import CSRGraph, csr_from_edges

INT32_LIMIT = np.iinfo(np.int32).max


def load_edgelist(path: str, comments: str = "#",
                  symmetrize: bool = True) -> CSRGraph:
    """Whitespace-separated `src dst` lines -> CSRGraph."""
    edges = np.loadtxt(path, comments=comments, dtype=np.int64, ndmin=2)
    if edges.shape[1] > 2:
        edges = edges[:, :2]
    return csr_from_edges(edges, symmetrize=symmetrize)


def save_graph_npz(path: str, graph: CSRGraph) -> None:
    np.savez_compressed(path, indptr=graph.indptr, indices=graph.indices,
                        data=(graph.data if graph.data is not None
                              else np.array([])))


def load_graph_npz(path: str) -> CSRGraph:
    z = np.load(path)
    data = z["data"] if z["data"].size else None
    g = CSRGraph(indptr=z["indptr"].astype(np.int32),
                 indices=z["indices"].astype(np.int32), data=data)
    check_int32_capacity(g)
    return g


def check_int32_capacity(graph: CSRGraph) -> None:
    """The samplers index edges with int32 on the host (as the reference
    does, subg_acc.c:740-741): raise for a graph of 2^31 - 1 edges or
    more, which must be split into row shards whose edge counts fit."""
    if graph.num_edges >= INT32_LIMIT:
        raise ValueError(
            f"graph has {graph.num_edges} edges >= int32 capacity; "
            "split it into row shards whose edge counts fit int32")
