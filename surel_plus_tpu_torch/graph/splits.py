"""Positive/negative query-edge assembly per split (port of
surel_plus_tpu/graph/splits.py) for the three split-edge formats:
'edge' (collab/ppa/ddi/vessel), 'source_node' (citation2-style,
per-source negatives) and 'hedge' (hypergraph triplets), with the
deterministic seed-123 `percent` subsampling. Like the JAX package's,
the subsampling reseeds numpy's global generator (`np.random.seed(123)`).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from surel_plus_tpu_torch.graph.negative import negative_sampling


def get_pos_neg_edges(split: str, split_edge: Dict, edge_index: np.ndarray,
                      num_nodes: int, percent: int = 100,
                      rng=None) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (pos_edge [Q, Ep], neg_edge [Q, En]) as int32 node-id edges.

    split_edge follows the OGB layout: split_edge[split] has either
    'edge'/'edge_neg' [E, 2], 'source_node'/'target_node'/'target_node_neg',
    or 'hedge'/'hedge_neg'.
    """
    if rng is None:
        rng = np.random.default_rng()
    train = split_edge["train"]

    if "edge" in train:
        pos_edge = np.asarray(split_edge[split]["edge"]).T  # [2, E]
        if split == "train":
            neg_edge = negative_sampling(
                edge_index, num_nodes=num_nodes,
                num_neg_samples=pos_edge.shape[1], rng=rng)
        else:
            neg_edge = np.asarray(split_edge[split]["edge_neg"]).T
        pos_edge = _subsample_cols(pos_edge, percent)
        neg_edge = _subsample_cols(neg_edge, percent)
        return pos_edge.astype(np.int32), neg_edge.astype(np.int32)

    if "source_node" in train:
        source = np.asarray(split_edge[split]["source_node"])
        target = np.asarray(split_edge[split]["target_node"])
        if split == "train":
            target_neg = rng.integers(0, num_nodes,
                                      size=(len(target), 1))
        else:
            target_neg = np.asarray(split_edge[split]["target_node_neg"])
        # seed-123 subsample
        np.random.seed(123)
        perm = np.random.permutation(len(source))
        perm = perm[:int(percent / 100 * len(source))]
        source, target = source[perm], target[perm]
        target_neg = target_neg[perm, :]
        pos_edge = np.stack([source, target])
        k = target_neg.shape[1]
        neg_edge = np.stack([np.repeat(source, k), target_neg.reshape(-1)])
        return pos_edge.astype(np.int32), neg_edge.astype(np.int32)

    if "hedge" in train:
        pos_edge = np.asarray(split_edge[split]["hedge"]).T  # [3, E]
        neg_edge = np.asarray(split_edge[split]["hedge_neg"]).T
        if percent < 100:
            np.random.seed(123)
            num_pos = pos_edge.shape[1]
            perm = np.random.permutation(num_pos)
            perm = perm[:int(percent / 100 * num_pos)]
            pos_edge = pos_edge[:, perm]
            k = neg_edge.shape[1] // num_pos
            neg_edge = neg_edge.reshape(3, num_pos, k)[
                :, perm, :].reshape(3, -1)
        return pos_edge.astype(np.int32), neg_edge.astype(np.int32)

    raise NotImplementedError(f"unknown split_edge format: "
                              f"{list(train.keys())}")


def _subsample_cols(edge: np.ndarray, percent: int) -> np.ndarray:
    """Deterministic seed-123 percent subsampling."""
    if percent >= 100:
        return edge
    np.random.seed(123)
    n = edge.shape[1]
    perm = np.random.permutation(n)[:int(percent / 100 * n)]
    return edge[:, perm]
