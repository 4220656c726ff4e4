"""The scalar structure encoders DEG / SPD / PPR and their sets (port of
surel_plus_tpu/ops/encoders.py).

The reference's `encoding()` (utils.py:20-39) turns a sparse score matrix
(the top-k PPR matrix) into one scalar structural feature per (seed,
node); the scalar itself is the model's input (no encoding table). The
matrices are scipy's `csr_matrix` throughout: on it `**` is the matrix
power SPD's two-hop reach needs (on `csr_array` it is elementwise). The
l1 row normalization is done in scipy, as sklearn's `normalize` does it
(the row sums in float64).

`scalar_spg_from_csr` pads the rows into a `ScalarSpG`, whose `device`
layout is an SpGDevice with float values in its `eidx` slot.
`gather_join_scalar` pairs each slot's value with the partner endpoint's
value of the same node (0 if absent).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from surel_plus_tpu_torch.ops.join import (
    JoinedBatch,
    _cross_lookup_bidir_multi,
)
from surel_plus_tpu_torch.ops.walk import INT32_MAX
from surel_plus_tpu_torch.spg.spg import SpGDevice


def l1_normalize_rows(mat):
    """Each row of a sparse matrix divided by the sum of its entries'
    magnitudes (rows that sum to 0 as they are), in a float copy:
    sklearn's normalize(mat, norm="l1", axis=1), its sums in float64."""
    import scipy.sparse as sp

    mat = sp.csr_matrix(mat, copy=True)
    if not np.issubdtype(mat.dtype, np.floating):
        mat = mat.astype(np.float64)
    sums = np.zeros(mat.shape[0], np.float64)
    rows = np.repeat(np.arange(mat.shape[0]), np.diff(mat.indptr))
    np.add.at(sums, rows, np.abs(mat.data.astype(np.float64)))
    div = sums[rows]
    div[div == 0.0] = 1.0
    mat.data = (mat.data.astype(np.float64) / div).astype(mat.dtype)
    return mat


def encoding(x, adj, kind: str = "DEG"):
    """x: CSR score matrix (the top-k PPR matrix); adj: CSR adjacency.
    Returns (x transformed, the DEG aggregate or None), as utils.py:20-39."""
    import scipy.sparse as sp

    agg = None
    if kind == "DEG":
        x = x + l1_normalize_rows(adj)
        x_deg = np.log(x.getnnz(axis=1) + 1)
        agg = x.copy()
        x.data = (x > 0).multiply(x_deg).tocsr().data.astype(x.data.dtype)
    elif kind == "SPD":
        x0 = x > 0
        x1 = adj > 0
        x2 = x1 ** 2
        x = x1 + x0.multiply(x2 * 0.5) + x0 * 0.3
        x = sp.csr_matrix(x)
        x.setdiag(2.3)
    elif kind == "PPR":
        x = x.copy()
        x.data = (x.data + 0.1) / (x.data.max() + 0.1)
    else:
        raise NotImplementedError(kind)
    return x, agg


@dataclasses.dataclass
class ScalarSpG:
    """Padded scalar-valued sets for the PPR / SPD / DEG paths: each row's
    node ids ascending, one float feature each (in place of an
    encoding-table index)."""

    nodes: np.ndarray    # int32 [n, L] ascending, pad INT32_MAX
    values: np.ndarray   # float32 [n, L], pad 0
    sizes: np.ndarray    # int32 [n]
    seeds: np.ndarray    # int32 [n]

    @property
    def bucket(self) -> int:
        return self.nodes.shape[1]

    def device(self, device="cuda") -> SpGDevice:
        """The device layout the trainers take: the values in the `eidx`
        slot, and a dummy `enc` [1, 1] (the scalar path has no table)."""
        t = lambda a: torch.as_tensor(a).to(device)
        return SpGDevice(nodes=t(self.nodes), eidx=t(self.values),
                         sizes=t(self.sizes),
                         enc=torch.zeros((1, 1), device=device))


def scalar_spg_from_csr(mat, seeds: Optional[np.ndarray] = None,
                        bucket: Optional[int] = None) -> ScalarSpG:
    """A scipy CSR score matrix (row = a seed's set, column = node, value
    = the scalar feature) in the padded layout, each row cut to its first
    `bucket` nodes (by default the widest row's width)."""
    mat = mat.tocsr()
    mat.sort_indices()
    n = mat.shape[0]
    sizes = np.diff(mat.indptr).astype(np.int32)
    L = bucket if bucket is not None else int(sizes.max()) if n else 0
    nodes = np.full((n, L), INT32_MAX, np.int32)
    values = np.zeros((n, L), np.float32)
    # one scatter of every entry to its (row, offset) slot
    row_of = np.repeat(np.arange(n, dtype=np.int64), sizes)
    off = (np.arange(mat.nnz, dtype=np.int64)
           - np.repeat(mat.indptr[:-1].astype(np.int64), sizes))
    keep = off < L
    nodes[row_of[keep], off[keep]] = mat.indices[keep]
    values[row_of[keep], off[keep]] = mat.data[keep]
    sizes = np.minimum(sizes, L)
    if seeds is None:
        seeds = np.arange(n, dtype=np.int32)
    return ScalarSpG(nodes=nodes, values=values, sizes=sizes,
                     seeds=np.asarray(seeds, np.int32))


def gather_join_scalar(nodes: torch.Tensor, values: torch.Tensor,
                       sizes: torch.Tensor,
                       edges: torch.Tensor) -> JoinedBatch:
    """The scalar-feature join (the reference's encode=None branch,
    train.py:39-43) of query edges [2, B] of row ids: each set slot's own
    value paired with the partner endpoint's value of the same node (0 if
    absent), eidx float32 [2, B, L, 2]. Both directions come out of one
    merge of the two node rows, the values' bits its payload; JAX looks
    each direction up on its own, the same values."""
    if edges.shape[0] != 2:
        raise ValueError("gather_join_scalar handles Q=2")
    # a contiguous index gathers contiguous rows, which the merge takes
    edges = edges.to(torch.int64).contiguous()
    rows_nodes, rows_vals = nodes[edges], values[edges]       # [2, B, L]
    vu, vv = rows_vals[0], rows_vals[1]
    (cross_u,), (cross_v,) = _cross_lookup_bidir_multi(
        rows_nodes[0], rows_nodes[1], (vu.view(torch.int32),),
        (vv.view(torch.int32),), aligned=True)
    pairs = torch.stack([
        torch.stack([vu, cross_u.view(torch.float32)], dim=-1),
        torch.stack([vv, cross_v.view(torch.float32)], dim=-1)])
    return JoinedBatch(eidx=pairs, mask=rows_nodes != INT32_MAX,
                       sizes=sizes[edges])
