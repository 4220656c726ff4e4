"""The host engine: training and evaluation with a host loop over batches
(port of surel_plus_tpu/train/loop.py).

`LinkPredictor` binds a model, its optimizer and a set store on a device,
and runs the reference's training semantics (train.py:114-317) from the
host: each epoch's batch order is a permutation drawn from the caller's
numpy Generator (`rng.permutation(E)`, the JAX package's draw for draw),
every batch has the static batch size (the tail padded with row 0 and
weighted 0), each step's dropout key the next of the epoch's dropout key
(`key, sub = split(key)`, the JAX package's), and each step's loss and
predictions are read back, so the
epoch's ROC-AUC is exact, on the host (`metrics.roc_auc`). A step is the
join on the device, the model, the weighted BCE, the gradients clipped
by their global norm and Adam, as `DeviceTrainer`'s. `predict` scores
batches the same way; `evaluate` reduces the valid and test splits'
scores to Hits@K, AUC or MRR on the host. The per-step reads are the
design: the device engine (`train/device.py`) is the one that never waits
for the device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from surel_plus_tpu_torch.ops import metrics as metrics_ops
from surel_plus_tpu_torch.ops import prng
from surel_plus_tpu_torch.ops.join import gather_join
from surel_plus_tpu_torch.spg.spg import SpGDevice
from surel_plus_tpu_torch.train.device import (
    adam_step,
    batch_loss,
    new_optimizer,
)


@dataclasses.dataclass
class TrainConfig:
    batch_size: int = 1024
    lr: float = 1e-3
    epochs: int = 200
    eval_steps: int = 5
    early_stop: int = -1
    grad_clip: float = 1.0
    seed: int = 0


class LinkPredictor:
    """Trains and scores `model` over a host store's sets placed on
    `device` (`spg.device(device)`: an SpG, or a ScalarSpG with
    `join_fn=gather_join_scalar`; or an SpGDevice as it is), joined by
    `join_fn(nodes, eidx, sizes, edges)`. `feature`: optional raw node
    features [n, x_dim]. The model takes the store's table in its own
    embed mode for scoring and in the "direct" mode for training, as
    `DeviceTrainer` does: the "table" mode's backward scatters every
    slot's gradient into the table's rows, and on CUDA the many slots of
    one row, the padding's row 0 above all, add up one after another
    (the values are the same either way, up to rounding). The optimizer
    is `DeviceTrainer`'s (clip by global norm, then Adam), fresh from
    `init`."""

    def __init__(self, model: torch.nn.Module, spg, config: TrainConfig,
                 join_fn: Callable = gather_join,
                 feature: Optional[np.ndarray] = None, device="cuda"):
        self.model = model
        self.config = config
        self.join_fn = join_fn
        self.device = torch.device(device)
        self.dev = spg if isinstance(spg, SpGDevice) else spg.device(
            self.device)
        self.feature = (None if feature is None else torch.as_tensor(
            np.asarray(feature), dtype=torch.float32).to(self.device))
        self.optimizer = new_optimizer(model, config)

    def init(self, key: prng.Key) -> None:
        """The weights flax's `init(key)` gives the JAX model (drawn on the
        model's device) and fresh Adam state."""
        self.model.reset_parameters(key)
        self.optimizer = new_optimizer(self.model, self.config)

    def _logits(self, edges: torch.Tensor, key: Optional[prng.Key] = None,
                **embed) -> torch.Tensor:
        joined = self.join_fn(self.dev.nodes, self.dev.eidx, self.dev.sizes,
                              edges)
        feat = self.feature[edges] if self.feature is not None else None
        return self.model(joined, feat, key=key, enc_table=self.dev.enc,
                          **embed)

    def _padded(self, edges: np.ndarray, sel: np.ndarray) -> torch.Tensor:
        """The batch of `edges` [Q, E] at `sel`, padded to the batch size
        with row 0, on the device."""
        pad = self.config.batch_size - len(sel)
        if pad:
            sel = np.concatenate([sel, np.zeros(pad, dtype=sel.dtype)])
        return torch.as_tensor(np.asarray(edges)[:, sel],
                               dtype=torch.int64).to(self.device)

    def train_epoch(self, edges: np.ndarray, labels: np.ndarray,
                    rng: np.random.Generator,
                    dropout_key: Optional[prng.Key] = None
                    ) -> Tuple[float, float]:
        """One epoch over [Q, E] host edges with [E] labels, in the order
        of `rng.permutation(E)`; a step's dropout key is `sub` of
        `dropout_key, sub = split(dropout_key)` (needed when the model
        drops out). Returns (mean loss, ROC-AUC) as floats."""
        bs = self.config.batch_size
        E = edges.shape[1]
        perm = rng.permutation(E)
        total_loss, total_n = 0.0, 0
        all_preds = np.empty(E, dtype=np.float32)
        all_labels = np.empty(E, dtype=np.float32)
        self.model.train()
        for pos in range(0, E, bs):
            sel = perm[pos:pos + bs]
            n = len(sel)
            w = np.zeros(bs, np.float32)
            w[:n] = 1.0
            bl = np.zeros(bs, np.float32)
            bl[:n] = labels[sel]
            sub = None
            if dropout_key is not None:
                dropout_key, sub = prng.split(dropout_key)
            logits = self._logits(self._padded(edges, sel), sub,
                                  embed_mode="direct")
            loss = batch_loss(logits, torch.as_tensor(bl).to(self.device),
                              torch.as_tensor(w).to(self.device))
            adam_step(self.model, self.optimizer, loss,
                      self.config.grad_clip)
            total_loss += loss.item() * n
            total_n += n
            preds = torch.sigmoid(logits.detach()).cpu().numpy()
            all_preds[pos:pos + n] = preds[:n]
            all_labels[pos:pos + n] = labels[sel]
        auc = metrics_ops.roc_auc(all_labels, all_preds)
        return total_loss / max(total_n, 1), auc

    @torch.inference_mode()
    def predict(self, edges: np.ndarray) -> np.ndarray:
        """Batched scoring of [Q, E] host edges -> sigmoid scores [E]
        (numpy float32). Leaves the model in eval mode."""
        bs = self.config.batch_size
        E = edges.shape[1]
        out = np.empty(E, dtype=np.float32)
        self.model.eval()
        for pos in range(0, E, bs):
            sel = np.arange(pos, min(pos + bs, E))
            scores = torch.sigmoid(self._logits(self._padded(edges, sel)))
            out[pos:pos + len(sel)] = scores.cpu().numpy()[:len(sel)]
        return out


def train_epoch(predictor: LinkPredictor, edges, labels, rng,
                dropout_key=None) -> Tuple[float, float]:
    return predictor.train_epoch(edges, labels, rng, dropout_key)


def evaluate(predictor: LinkPredictor, inf_edge: Dict, metric: str,
             neg_per_pos: Optional[int] = None) -> Tuple:
    """The reference's `inference` / `inference_mrr` (train.py:175-280):
    score the valid and test splits, inf_edge[split] = (pos [Q, Ep], neg
    [Q, En]) host edges, and reduce them on the host. Returns (results,
    seconds of the test split): {"Hits@K": (0, valid, test)} for K in 10,
    20, 50, 100, or (0, valid, test) for AUC and MRR (each positive's
    negatives taken En // Ep a positive, in order)."""

    def split_scores(split):
        pos_edge, neg_edge = inf_edge[split]
        return predictor.predict(pos_edge), predictor.predict(neg_edge)

    pos_v, neg_v = split_scores("valid")
    t0 = time.time()
    pos_t, neg_t = split_scores("test")
    t_inf = time.time() - t0

    if "Hits" in metric:
        results = {}
        for k in (10, 20, 50, 100):
            results[f"Hits@{k}"] = (
                0,
                metrics_ops.hits_at_k(pos_v, neg_v, k),
                metrics_ops.hits_at_k(pos_t, neg_t, k),
            )
        return results, t_inf
    if "AUC" in metric:
        lab_v = np.concatenate([np.ones(len(pos_v)), np.zeros(len(neg_v))])
        lab_t = np.concatenate([np.ones(len(pos_t)), np.zeros(len(neg_t))])
        return (0,
                metrics_ops.roc_auc(lab_v, np.concatenate([pos_v, neg_v])),
                metrics_ops.roc_auc(lab_t, np.concatenate([pos_t, neg_t])),
                ), t_inf
    k_v = len(neg_v) // max(len(pos_v), 1)
    k_t = len(neg_t) // max(len(pos_t), 1)
    return (0,
            metrics_ops.mrr(pos_v, neg_v[:len(pos_v) * k_v].reshape(-1, k_v)),
            metrics_ops.mrr(pos_t, neg_t[:len(pos_t) * k_t].reshape(-1, k_t)),
            ), t_inf
