"""Personalized PageRank on the device (port of
surel_plus_tpu/ops/ppr_device.py).

The same scores as the host push (`ops/ppr.py`) by truncated power
iteration over a block of seeds at a time,

    pi(seed) = alpha * sum_t (1-alpha)^t  e_seed P^t,   P = D^-1 A,

with T iterations chosen so that the tail (1-alpha)^(T+1) is below the
tolerance. Degree-0 nodes drop their outgoing mass, as the push does.

One iteration's product x -> x P over the block's state [N, S] is a
sparse CSR product of the adjacency with the state scaled by 1/deg: each
row sums its own edges' terms, where the JAX package forms the same sum
from a running sum over all edges in CSR order and a difference of its
values at the row bounds (ppr_device.py:58-66). The direct sums are
nearer the exact ones (the difference of two running sums loses the low
bits of the smaller term), and they hold the JAX package's scores to
1e-6 on the tests' graphs. The top k come from a stable descending sort,
so that equal scores keep ascending node order, as `lax.top_k` keeps them
(`torch.topk` leaves their order open); scores that differ only by
rounding may still fall in either order.

Like the JAX module, it is right on symmetric CSR only: the product reads
row u's edges as u's in-edges, which they are when A is symmetric.
"""

from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np
import torch


def _num_iters(alpha: float, tol: float) -> int:
    """Smallest T with (1-alpha)^(T+1) <= tol (residual tail bound)."""
    if alpha >= 1.0:
        return 1
    return max(1, int(np.ceil(np.log(tol) / np.log1p(-alpha))) + 1)


def _ppr_block(adj: torch.Tensor, inv_deg: torch.Tensor, e0: torch.Tensor,
               alpha: float, n_iters: int, topk: int):
    """One seed block. adj: the CSR adjacency (ones) [N, N]; e0 [N, S]
    one-hot seed columns. Returns (scores [S, topk], nodes [S, topk])
    sorted descending per seed."""
    x = alpha * e0
    for _ in range(n_iters):
        x = alpha * e0 + (1.0 - alpha) * (adj @ (x * inv_deg[:, None]))
    # equal scores in ascending node order, as lax.top_k orders them
    scores, nodes = torch.sort(x.T, dim=1, descending=True, stable=True)
    k = min(topk, x.shape[0])
    return scores[:, :k], nodes[:, :k]


def ppr_topk_device(indptr: np.ndarray, indices: np.ndarray,
                    seeds: np.ndarray, alpha: float, eps: float,
                    topk: int, block: int = 16, tol: float | None = None,
                    device="cuda"
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The device analog of `ops.ppr.ppr_topk`, with its return contract:
    nodes [S, topk], scores [S, topk], counts [S] (numpy; zero-score
    slots are not counted). `block` seeds a product; `tol` defaults to
    alpha * eps, the push's residual threshold per unit of degree."""
    indptr = np.ascontiguousarray(indptr, np.int32)
    indices = np.ascontiguousarray(indices, np.int32)
    seeds = np.ascontiguousarray(seeds, np.int32)
    n = len(indptr) - 1
    deg = (indptr[1:] - indptr[:-1]).astype(np.float32)
    with np.errstate(divide="ignore"):
        inv_deg = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0)
    n_iters = _num_iters(alpha, tol if tol is not None else alpha * eps)

    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "Sparse CSR tensor support")
        adj = torch.sparse_csr_tensor(
            torch.as_tensor(indptr, dtype=torch.int64),
            torch.as_tensor(indices, dtype=torch.int64),
            torch.ones(len(indices), dtype=torch.float32),
            size=(n, n), check_invariants=True).to(device)
    d_inv_deg = torch.as_tensor(inv_deg.astype(np.float32)).to(device)
    d_seeds = torch.as_tensor(seeds, dtype=torch.int64).to(device)

    k = min(topk, n)
    out_nodes = torch.zeros((len(seeds), topk), dtype=torch.int64,
                            device=device)
    out_scores = torch.zeros((len(seeds), topk), dtype=torch.float32,
                             device=device)
    cols = torch.arange(block, device=device)
    for lo in range(0, len(seeds), block):
        sel = d_seeds[lo:lo + block]
        s = sel.shape[0]
        e0 = torch.zeros((n, block), dtype=torch.float32, device=device)
        e0[sel, cols[:s]] = 1.0
        scores, nodes = _ppr_block(adj, d_inv_deg, e0, float(alpha),
                                   n_iters, topk)
        out_scores[lo:lo + s, :k] = scores[:s]
        out_nodes[lo:lo + s, :k] = nodes[:s]
    out_scores, out_nodes = out_scores.cpu().numpy(), out_nodes.cpu().numpy()
    # top-k is descending, so the valid (positive) entries are a prefix
    valid = out_scores > 0
    counts = valid.sum(axis=1).astype(np.int32)
    out_nodes = np.where(valid, out_nodes, 0).astype(np.int32)
    out_scores = np.where(valid, out_scores, 0.0).astype(np.float32)
    return out_nodes, out_scores, counts
