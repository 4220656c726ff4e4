"""Immutable CSR graph container (port of surel_plus_tpu/graph/csr.py).

Host arrays are numpy; `to(device)` places (indptr, indices) on a torch
device. Node ids and offsets are int32 on the host and on the device, the
JAX package's words (its `device()`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Compressed sparse row adjacency.

    indptr:  int32[N+1]
    indices: int32[E]   (column ids; sorted within each row)
    data:    optional float32[E] edge weights (None => unweighted)
    """

    indptr: np.ndarray
    indices: np.ndarray
    data: Optional[np.ndarray] = None

    @property
    def num_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def num_edges(self) -> int:
        return len(self.indices)

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def neighbors(self, u: int) -> np.ndarray:
        return self.indices[self.indptr[u]:self.indptr[u + 1]]

    def has_edge(self, u: int, v: int) -> bool:
        row = self.neighbors(u)
        i = np.searchsorted(row, v)
        return bool(i < len(row) and row[i] == v)

    def to_scipy(self):
        """The adjacency as a scipy.sparse.csr_matrix [N, N] of the edge
        weights, or of ones where the graph has none."""
        import scipy.sparse as sp

        data = self.data if self.data is not None else np.ones(
            self.num_edges, dtype=np.float32)
        n = self.num_nodes
        return sp.csr_matrix((data, self.indices, self.indptr), shape=(n, n))

    @staticmethod
    def from_scipy(mat) -> "CSRGraph":
        """A scipy sparse matrix as a CSR graph, rows sorted, weights
        float32."""
        mat = mat.tocsr()
        mat.sort_indices()
        return CSRGraph(
            indptr=np.asarray(mat.indptr, dtype=np.int32),
            indices=np.asarray(mat.indices, dtype=np.int32),
            data=np.asarray(mat.data, dtype=np.float32),
        )

    def to(self, device):
        """Return (indptr, indices) as int32 torch tensors on `device`, the
        JAX package's `device()` words, uploaded from the host arrays with
        no wider copy. Raises ValueError for 2^31 or more directed edges
        (`check_int32_edges`)."""
        check_int32_edges(self.num_edges)
        return tuple(torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
            device) for a in (self.indptr, self.indices))


# the most directed edges the int32 device words can offset: JAX's int32
# starts would wrap past it
MAX_DEVICE_EDGES = 2**31 - 1


def check_int32_edges(num_edges: int) -> None:
    """Raise ValueError if a graph of `num_edges` directed edges cannot be
    offset by the device's int32 words."""
    if num_edges > MAX_DEVICE_EDGES:
        raise ValueError(
            f"{num_edges:,} directed edges do not fit the device graph's "
            f"int32 offsets (at most {MAX_DEVICE_EDGES:,})")


# from this edge count on, `csr_from_edges` takes the C++/OpenMP
# counting-sort build (`graph/native.py`: the same semantics, O(E)), as
# the JAX package does
NATIVE_BUILD_THRESHOLD = 2_000_000


def coalesce_edge_list(edges: np.ndarray, weights: np.ndarray):
    """Deduplicate directed (u, v) pairs summing weights, sorted by (u, v):
    torch_sparse.coalesce's semantics, which the reference applies to the
    train edge list before the mask split."""
    edges = np.asarray(edges, dtype=np.int64)
    weights = np.asarray(weights)
    order = np.lexsort((edges[:, 1], edges[:, 0]))
    e, w = edges[order], weights[order]
    if not len(e):
        return e, w
    new = np.empty(len(e), dtype=bool)
    new[0] = True
    new[1:] = (e[1:, 0] != e[:-1, 0]) | (e[1:, 1] != e[:-1, 1])
    seg = np.cumsum(new) - 1
    w_out = np.bincount(seg, weights=w).astype(weights.dtype)
    return e[new], w_out


def csr_from_edges(
    edges: np.ndarray,
    num_nodes: Optional[int] = None,
    weights: Optional[np.ndarray] = None,
    symmetrize: bool = True,
    coalesce: bool = True,
    drop_self_loops: bool = True,
    prefer_native: Optional[bool] = None,
) -> CSRGraph:
    """Build a CSR graph from an edge list of shape [E, 2].

    `G = A + A^T` with the diagonal dropped: symmetrize sums the weights
    of (u, v) and (v, u); coalesce sums duplicate entries.

    `prefer_native=None` takes the native O(E) build
    (`native.build_csr_weighted_native`) from NATIVE_BUILD_THRESHOLD
    edges on, the numpy lexsort below that; True or False forces either.
    The native build takes node ids below 2^31 - 1 and at most 2^31 - 1
    entries; other edge lists take the numpy path, as in the JAX package.
    An int32 edge list reaches the native build without an int64 copy.
    """
    edges = np.asarray(edges)
    if prefer_native is None:
        prefer_native = len(edges) >= NATIVE_BUILD_THRESHOLD
    if (prefer_native and len(edges) and int(edges.max()) < 2**31 - 1
            and len(edges) * (2 if symmetrize else 1) < 2**31):
        from surel_plus_tpu_torch.graph.native import (
            build_csr_weighted_native,
        )
        return build_csr_weighted_native(
            edges, weights=weights, num_nodes=num_nodes,
            symmetrize=symmetrize, coalesce=coalesce,
            drop_self_loops=drop_self_loops)
    edges = edges.astype(np.int64, copy=False)
    if edges.ndim != 2 or edges.shape[1] != 2:
        raise ValueError(f"edges must be [E, 2], got {edges.shape}")
    if num_nodes is None:
        num_nodes = int(edges.max()) + 1 if len(edges) else 0
    if weights is None:
        weights = np.ones(len(edges), dtype=np.float32)
    else:
        weights = np.asarray(weights, dtype=np.float32)

    src, dst, w = edges[:, 0], edges[:, 1], weights
    if symmetrize:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        w = np.concatenate([w, w])
    if drop_self_loops:
        keep = src != dst
        src, dst, w = src[keep], dst[keep], w[keep]

    # sort by (src, dst) once; CSR rows come out column-sorted.
    order = np.lexsort((dst, src))
    src, dst, w = src[order], dst[order], w[order]

    if coalesce and len(src):
        key_new = np.empty(len(src), dtype=bool)
        key_new[0] = True
        key_new[1:] = (src[1:] != src[:-1]) | (dst[1:] != dst[:-1])
        seg = np.cumsum(key_new) - 1
        w = np.bincount(seg, weights=w).astype(np.float32)
        src, dst = src[key_new], dst[key_new]

    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    indptr = np.cumsum(indptr)
    return CSRGraph(
        indptr=indptr.astype(np.int32),
        indices=dst.astype(np.int32),
        data=w,
    )
