"""Evaluation metrics with OGB's semantics, on the host in numpy (port of
surel_plus_tpu/ops/metrics.py; a copy).

The reference delegates to `ogb.linkproppred.Evaluator` (main.py:209-210)
and `sklearn.roc_auc_score` (train.py:139). The semantics kept here:

  hits@K:  share of positive scores strictly greater than the K-th
           highest negative score (OGB linkproppred eval_hits).
  MRR:     per positive, its rank among its own k negatives, ties counted
           against it: rank = 1 + #(neg >= pos); mrr = mean(1/rank)
           (OGB eval_mrr 'mrr_list').
  ROC-AUC: the rank statistic (sklearn's for binary labels, ties by
           midranks).
"""

from __future__ import annotations

import numpy as np


def hits_at_k(pos_pred: np.ndarray, neg_pred: np.ndarray, k: int) -> float:
    pos_pred = np.asarray(pos_pred).ravel()
    neg_pred = np.asarray(neg_pred).ravel()
    if len(neg_pred) < k:
        return 1.0
    kth = np.sort(neg_pred)[-k]
    return float((pos_pred > kth).mean())


def mrr(pos_pred: np.ndarray, neg_pred: np.ndarray) -> float:
    """pos_pred: [n]; neg_pred: [n, k] (negatives per positive)."""
    pos_pred = np.asarray(pos_pred).reshape(-1, 1)
    neg_pred = np.asarray(neg_pred)
    assert neg_pred.ndim == 2 and neg_pred.shape[0] == pos_pred.shape[0]
    rank = 1 + (neg_pred >= pos_pred).sum(axis=1)
    return float((1.0 / rank).mean())


def mrr_list(pos_pred: np.ndarray, neg_pred: np.ndarray) -> np.ndarray:
    pos_pred = np.asarray(pos_pred).reshape(-1, 1)
    neg_pred = np.asarray(neg_pred)
    rank = 1 + (neg_pred >= pos_pred).sum(axis=1)
    return 1.0 / rank


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Binary ROC-AUC via the Mann-Whitney U statistic with midranks."""
    labels = np.asarray(labels).ravel().astype(bool)
    scores = np.asarray(scores).ravel().astype(np.float64)
    n_pos = int(labels.sum())
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    sorted_scores = scores[order]
    ranks = np.empty(len(scores), dtype=np.float64)
    # midranks for ties
    i = 0
    while i < len(sorted_scores):
        j = i
        while j + 1 < len(sorted_scores) and \
                sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    r_pos = ranks[labels].sum()
    return float((r_pos - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def evaluate_hits(pos_pred: np.ndarray, neg_pred: np.ndarray) -> dict:
    """Hits at the reference's standard cutoffs (utils.py:42-52)."""
    return {f"Hits@{k}": hits_at_k(pos_pred, neg_pred, k)
            for k in (10, 20, 50, 100)}


class Evaluator:
    """Drop-in for `ogb.linkproppred.Evaluator` over the metrics the
    reference uses (hits@K with settable .K, mrr_list, rocauc)."""

    def __init__(self, name: str = "", metric: str = "hits"):
        self.name = name
        self.metric = metric
        self.K = 100

    def eval(self, input_dict):
        pos = np.asarray(input_dict["y_pred_pos"])
        neg = np.asarray(input_dict["y_pred_neg"])
        if self.metric == "mrr" or neg.ndim == 2:
            return {"mrr_list": mrr_list(pos, neg)}
        if self.metric == "rocauc":
            labels = np.concatenate([np.ones(len(pos)), np.zeros(len(neg))])
            scores = np.concatenate([pos, neg])
            return {"rocauc": roc_auc(labels, scores)}
        return {f"hits@{self.K}": hits_at_k(pos, neg, self.K)}


def evaluator_for(dataset: str) -> "Evaluator":
    """Metric selection per dataset, mirroring main.py:100-118 overrides."""
    name = dataset.lower()
    if "citation" in name or "mag" in name or name in (
            "tags-math", "dblp-coauthor"):
        return Evaluator(dataset, "mrr")
    if "vessel" in name:
        return Evaluator(dataset, "rocauc")
    return Evaluator(dataset, "hits")
