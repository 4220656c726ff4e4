"""Negative edge sampling on the host, numpy (port of
surel_plus_tpu/graph/negative.py): random node pairs, uniform, rejecting
existing edges and self-loops, with an optional force_undirected mode
(the vessel split); and uniform random targets. The draws are the JAX
package's, one for one.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _edge_keys(src: np.ndarray, dst: np.ndarray, num_nodes: int
               ) -> np.ndarray:
    return src.astype(np.int64) * num_nodes + dst.astype(np.int64)


def negative_sampling(
    edge_index: np.ndarray,
    num_nodes: int,
    num_neg_samples: int,
    rng: Optional[np.random.Generator] = None,
    force_undirected: bool = False,
    max_rounds: int = 64,
) -> np.ndarray:
    """Sample [2, num_neg_samples] pairs absent from edge_index (either
    direction if force_undirected) and off-diagonal."""
    if rng is None:
        rng = np.random.default_rng()
    src, dst = np.asarray(edge_index[0]), np.asarray(edge_index[1])
    existing = _edge_keys(src, dst, num_nodes)
    if force_undirected:
        existing = np.concatenate(
            [existing, _edge_keys(dst, src, num_nodes)])
    existing = np.unique(np.concatenate(
        [existing,
         _edge_keys(np.arange(num_nodes), np.arange(num_nodes),
                    num_nodes)]))

    out = np.empty((2, num_neg_samples), dtype=np.int64)
    got = 0
    for _ in range(max_rounds):
        need = num_neg_samples - got
        if need <= 0:
            break
        cand = rng.integers(0, num_nodes, size=(2, int(need * 1.2) + 8))
        keys = _edge_keys(cand[0], cand[1], num_nodes)
        ok = ~np.isin(keys, existing)
        # also reject duplicates within this draw (keep first)
        keys_ok = keys[ok]
        _, first = np.unique(keys_ok, return_index=True)
        keep = np.zeros(len(keys_ok), dtype=bool)
        keep[first] = True
        cand = cand[:, ok][:, keep][:, :need]
        out[:, got:got + cand.shape[1]] = cand
        got += cand.shape[1]
    if got < num_neg_samples:
        raise RuntimeError(
            f"negative_sampling: only {got}/{num_neg_samples} found")
    return out.astype(np.int32)


def random_targets(num_nodes: int, shape, rng: np.random.Generator
                   ) -> np.ndarray:
    """Uniform random nodes int32 of `shape`: the train-time MRR
    negatives (the reference's `torch.randint`, utils.py:82-83)."""
    return rng.integers(0, num_nodes, size=shape).astype(np.int32)
