"""Device-resident training, scoring and metrics (port of
surel_plus_tpu/train/device.py).

`DeviceTrainer` owns the model and its optimizer, over either store of
sets: an encoding-table SpGDevice (joined by `gather_join`, the model fed
the encoding table; training in the "direct" embed mode, scoring in the
model's own) or a packed-key SpGKeys (`trainer_from_keys` builds its
join). `fit` trains epoch by
epoch: each epoch shuffles the query edges with a riffle permutation
(padded ids weigh 0), then runs a Python loop of steps (join, model,
weighted BCE, backward, clip + Adam) on the sets' device, and keeps the
epoch loss and the histogram AUC on the device: nothing in the loop
waits for the device. The draws follow the JAX package's key tree: `fit`
splits its key into one key an epoch, an epoch splits its key into the
permutation's and the dropout's, and each step takes the next dropout
key (`key, sub = split(key)`); the keys live on the host and the words
come from the threefry kernel, so a key gives JAX's batch order and
dropout masks. `predict` scores query edges batch by batch, with
the tail batch padded with zero edges as in the reference.
`evaluate_device` scores the valid and test splits with a trainer and
reduces them to Hits@K, AUC or MRR on the device.

Balanced batching (paper §3.3; `partition_by_width`, `fit_balanced`,
`predict_balanced`) groups the queries by the tile width they need, the
larger of their two set sizes, into ascending width classes, and runs
each class over the stores' row tiles cut to its width: queries of small
sets stop paying the whole bucket's padding in the join and the model.
Each class is one segment of an epoch, with its own permutation; the
epoch's loss and AUC histogram are shared by the classes.
"""

from __future__ import annotations

import time
from typing import (
    TYPE_CHECKING,
    Callable,
    Dict,
    List,
    Optional,
    Sequence,
    Tuple,
    Union,
)

import numpy as np
import torch
from torch.nn import functional as F

from surel_plus_tpu_torch.ops import prng
from surel_plus_tpu_torch.ops.join import gather_join, make_keys_join
from surel_plus_tpu_torch.spg.spg import SpGDevice, SpGKeys
from surel_plus_tpu_torch.utils.profiling import span

if TYPE_CHECKING:
    from surel_plus_tpu_torch.train.loop import TrainConfig


AUC_BINS = 512


def _ordered_float_key(x: torch.Tensor) -> torch.Tensor:
    """float32 -> its bits as an unsigned 32-bit key (int64) that orders
    as the floats do, so that the exclusive upper bound is key + 1."""
    u = x.to(torch.float32).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    flip = torch.where(u >> 31 == 1, 0xFFFFFFFF, 0x80000000)
    return u ^ flip


def riffle_permutation(key: prng.Key, rows: int, cols: int,
                       rounds: int = 2, device="cpu") -> torch.Tensor:
    """Pseudorandom permutation of [0, rows*cols) as a [rows, cols] int64
    batch matrix on `device`: the JAX package's epoch shuffle. Each round
    splits `key` into (key, k1, k2), sorts every row stably by
    bits(k1, [rows, cols]) and then every column by bits(k2, ...)."""
    idx = torch.arange(rows * cols, device=device).reshape(rows, cols)
    for _ in range(rounds):
        key, k1, k2 = prng.split(key, 3)
        for k, dim in ((k1, 1), (k2, 0)):
            order = torch.sort(prng.bits(k, (rows, cols), device), dim=dim,
                               stable=True).indices
            idx = torch.gather(idx, dim, order)
    return idx


def device_auc_hist(pos_hist: torch.Tensor,
                    neg_hist: torch.Tensor) -> torch.Tensor:
    """AUC from per-bin positive / negative score histograms (midrank
    within a bin); the epoch training AUC."""
    n_pos = pos_hist.sum()
    n_neg = neg_hist.sum()
    neg_below = torch.cumsum(neg_hist, dim=0) - neg_hist
    wins = (pos_hist * (neg_below + 0.5 * neg_hist)).sum()
    return wins / torch.clamp(n_pos * n_neg, min=1.0)


def score_histogram(scores: torch.Tensor, weights: torch.Tensor,
                    bins: int) -> torch.Tensor:
    """Weighted histogram of scores in [0, 1] by broadcast comparison."""
    b = torch.clamp((scores * bins).to(torch.int32), 0, bins - 1)
    onehot = b[:, None] == torch.arange(bins, dtype=torch.int32,
                                        device=b.device)[None, :]
    return (onehot * weights[:, None]).sum(dim=0)


def device_auc(labels: torch.Tensor, scores: torch.Tensor,
               weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ROC-AUC with midrank ties (sklearn's roc_auc_score for binary
    labels); entries of weight <= 0 are left out."""
    if weights is None:
        weights = torch.ones_like(scores)
    w = weights > 0
    keys = torch.where(w, _ordered_float_key(scores), 0)
    k_sorted = torch.sort(keys).values
    n_excl = (~w).sum()
    lb = torch.searchsorted(k_sorted, keys)
    ub = torch.searchsorted(k_sorted, keys + 1)
    midrank = (lb + ub + 1).to(torch.float32) / 2.0 - n_excl
    is_pos = (labels > 0.5) & w
    is_neg = (labels <= 0.5) & w
    n_pos = is_pos.sum().to(torch.float32)
    n_neg = is_neg.sum().to(torch.float32)
    r_pos = torch.where(is_pos, midrank, 0.0).sum()
    return (r_pos - n_pos * (n_pos + 1) / 2.0) / torch.clamp(
        n_pos * n_neg, min=1.0)


def batch_loss(logits: torch.Tensor, labels: torch.Tensor,
               weights: torch.Tensor) -> torch.Tensor:
    """Weighted mean of the sigmoid BCE over max(sum of weights, 1)."""
    per = F.binary_cross_entropy_with_logits(logits, labels,
                                             reduction="none")
    return (per * weights).sum() / torch.clamp(weights.sum(), min=1.0)


@torch.no_grad()
def clip_by_global_norm_(grads: Sequence[torch.Tensor],
                         max_norm: float) -> None:
    """optax.clip_by_global_norm in place: with n the global L2 norm, each
    gradient stays as it is if n < max_norm, else becomes g / n * max_norm
    (no epsilon, unlike torch.nn.utils.clip_grad_norm_). Decided on the
    device: no host sync."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def new_optimizer(model: torch.nn.Module, config: TrainConfig
                  ) -> torch.optim.Optimizer:
    """Adam with optax's defaults (eps 1e-8 outside the square root)."""
    return torch.optim.Adam(model.parameters(), lr=config.lr,
                            betas=(0.9, 0.999), eps=1e-8)


def adam_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
              loss: torch.Tensor, grad_clip: float) -> None:
    """One update: the gradients of `loss`, clipped by their global norm
    (`clip_by_global_norm_`), then the optimizer's step."""
    with span("surel.backward"):
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
    with span("surel.optimizer"):
        clip_by_global_norm_([p.grad for p in model.parameters()
                              if p.grad is not None], grad_clip)
        optimizer.step()


def device_hits_at_k(pos: torch.Tensor, neg: torch.Tensor,
                     k: int) -> torch.Tensor:
    """Share of positives scoring strictly above the k-th best negative."""
    if neg.shape[0] >= k:
        kth = torch.sort(neg).values[-k]
    else:
        kth = torch.finfo(pos.dtype).min
    return (pos > kth).to(torch.float32).mean()


def device_mrr(pos: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """pos [n], neg [n, k]; optimistic-tie OGB ranks."""
    rank = 1 + (neg >= pos[:, None]).sum(dim=1)
    return (1.0 / rank.to(torch.float32)).mean()


class DeviceTrainer:
    """Trains and scores a Net over device-resident sets.

    sets: an SpGDevice, whose join is join(nodes, eidx, sizes, edges)
    (default `gather_join`) and whose encoding table goes to the model
    (training with embed_mode=train_embed_mode, scoring with the model's
    own; the parameters are the same either way); or an SpGKeys, whose
    join is join(nodes, khi, klo, sizes, edges) (`trainer_from_keys`
    builds it). `feature`: optional raw node features [n, x_dim] on the
    sets' device. The optimizer is optax.chain(clip_by_global_norm(
    grad_clip), adam(lr)): `clip_by_global_norm_` then torch.optim.Adam
    (eps 1e-8 outside the square root, as optax's), fresh state from
    `init`."""

    def __init__(self, model: torch.nn.Module,
                 sets: Union[SpGDevice, SpGKeys], config: TrainConfig,
                 join: Optional[Callable] = None,
                 feature: Optional[torch.Tensor] = None,
                 train_embed_mode: str = "direct"):
        self.model = model
        self.sets = sets
        self.config = config
        self.feature = feature
        if isinstance(sets, SpGDevice):
            self.rows = (sets.nodes, sets.eidx, sets.sizes)
            self.join = gather_join if join is None else join
            self.predict_kw = dict(enc_table=sets.enc)
            self.train_kw = dict(enc_table=sets.enc,
                                 embed_mode=train_embed_mode)
        else:
            if join is None:
                raise ValueError("a keys store needs its join "
                                 "(trainer_from_keys builds it)")
            self.rows = (sets.nodes, sets.khi, sets.klo, sets.sizes)
            self.join = join
            self.predict_kw = self.train_kw = {}
        self.optimizer = new_optimizer(model, config)
        self._sizes_h = None

    def init(self, key: prng.Key) -> None:
        """The weights flax's `init(key)` gives the JAX model (drawn on the
        model's device) and fresh Adam state."""
        self.model.reset_parameters(key)
        self.optimizer = new_optimizer(self.model, self.config)

    def _rows_at(self, width: Optional[int]) -> tuple:
        """The stores' row tiles cut to their first `width` slots (a width
        class's strided views), or whole if `width` is None."""
        if width is None:
            return self.rows
        return tuple(t[:, :width] if t.dim() == 2 else t for t in self.rows)

    def _batch(self, edges: torch.Tensor, rows: Optional[tuple] = None):
        with span("surel.join"):
            joined = self.join(*(self.rows if rows is None else rows),
                               edges)
        feat = self.feature[edges] if self.feature is not None else None
        return joined, feat

    def _segment(self, edges: torch.Tensor, labels: torch.Tensor,
                 perm: torch.Tensor, key: prng.Key,
                 acc: List[torch.Tensor], rows: Optional[tuple] = None
                 ) -> prng.Key:
        """The training steps over `edges` in the batches of `perm`
        [nsteps, batch_size] (ids past the edges weigh 0), the joins over
        `rows`, step by step `key, sub = split(key)` and sub the step's
        dropout key; adds each step's score histograms, weighted loss and
        weight to `acc` [pos_h, neg_h, loss_sum, w_sum] on the device.
        Returns the last `key`."""
        num_edges = edges.shape[1]
        perm = perm.to(edges.device, torch.int64)
        wmat = (perm < num_edges).to(torch.float32)
        perm = torch.clamp(perm, max=num_edges - 1)
        for idx, w in zip(perm, wmat):
            bl = labels[idx]
            key, sub = prng.split(key)
            joined, feat = self._batch(edges[:, idx], rows)
            with span("surel.forward"):
                logits = self.model(joined, feat, key=sub, **self.train_kw)
                loss = batch_loss(logits, bl, w)
            adam_step(self.model, self.optimizer, loss,
                      self.config.grad_clip)
            with span("surel.accumulate"), torch.no_grad():
                preds = torch.sigmoid(logits)
                acc[0] += score_histogram(preds, w * bl, AUC_BINS)
                acc[1] += score_histogram(preds, w * (1.0 - bl), AUC_BINS)
                acc[2] += loss * w.sum()
                acc[3] += w.sum()
        return key

    @staticmethod
    def _new_acc(device) -> List[torch.Tensor]:
        hist = torch.zeros(AUC_BINS, device=device)
        zero = torch.zeros((), device=device)
        return [hist, hist.clone(), zero, zero.clone()]

    @staticmethod
    def _epoch_result(acc: List[torch.Tensor]):
        """(mean loss, histogram AUC) of an epoch's accumulators."""
        return (acc[2] / torch.clamp(acc[3], min=1.0),
                device_auc_hist(acc[0], acc[1]))

    def train_epoch(self, edges: torch.Tensor, labels: torch.Tensor,
                    key: prng.Key, perm: Optional[torch.Tensor] = None):
        """One epoch over [Q, E] query edges with labels [E] float32, on
        the sets' device, from the epoch `key` as JAX's epoch body takes
        it: kperm, kdrop = split(key); kperm draws the batch permutation
        (`riffle_permutation`) unless `perm` [nsteps, batch_size] is
        given, kdrop the steps' dropout keys. Returns (mean loss,
        histogram AUC) as device scalars."""
        bs = self.config.batch_size
        kperm, kdrop = prng.split(key)
        if perm is None:
            perm = riffle_permutation(kperm, -(-edges.shape[1] // bs), bs,
                                      device=edges.device)
        self.model.train()
        acc = self._new_acc(edges.device)
        self._segment(edges, labels, perm, kdrop, acc)
        return self._epoch_result(acc)

    def fit(self, edges, labels, n_epochs: int, key: prng.Key,
            perms: Optional[Sequence[torch.Tensor]] = None):
        """`n_epochs` epochs of `train_epoch`, epoch e from
        split(key, n_epochs)[e] (JAX's `fit`); `perms` optionally gives
        each epoch's batch permutation. Returns (losses [n_epochs],
        aucs [n_epochs]) as device tensors."""
        dev = self.sets.nodes.device
        edges = torch.as_tensor(edges).to(dev, torch.int64)
        labels = torch.as_tensor(labels).to(dev, torch.float32)
        losses, aucs = zip(*(self.train_epoch(
            edges, labels, k, None if perms is None else perms[e])
            for e, k in enumerate(prng.split(key, n_epochs))))
        return torch.stack(losses), torch.stack(aucs)

    @torch.inference_mode()
    def predict(self, edges, width: Optional[int] = None) -> torch.Tensor:
        """Score [Q, E] query edges (numpy or tensor of SpG row ids);
        returns sigmoid scores [E] float32 on the sets' device. `width`
        cuts the row tiles to a width class (`predict_balanced`). Leaves
        the model in eval mode."""
        dev = self.sets.nodes.device
        edges = torch.as_tensor(edges).to(dev, torch.int64)
        rows = self._rows_at(width)
        bs = self.config.batch_size
        E = edges.shape[1]
        pad = (-E) % bs
        if pad:
            edges = torch.cat([edges, edges.new_zeros(edges.shape[0], pad)],
                              dim=1)
        self.model.eval()
        out = []
        for i in range(0, E + pad, bs):
            joined, feat = self._batch(edges[:, i:i + bs], rows)
            with span("surel.forward"):
                out.append(torch.sigmoid(self.model(joined, feat,
                                                    **self.predict_kw)))
        return torch.cat(out)[:E]

    # -- balanced batching (JAX device.py:282-504) -------------------------
    def partition_by_width(self, edges, classes: Sequence[int]
                           ) -> List[Tuple[int, np.ndarray]]:
        """The [Q, E] queries (numpy or tensor) by width class, on the
        host: [(width, query indices)] for each of the ascending `classes`,
        a query in the first class at least as wide as its largest set.
        The last class must be at least the stores' bucket; raises
        ValueError otherwise, or if a query's set is wider than it."""
        classes = [int(c) for c in classes]
        if classes != sorted(classes) or classes[-1] < self.rows[0].shape[1]:
            raise ValueError(f"width classes {classes} must ascend to at "
                             f"least the bucket {self.rows[0].shape[1]}")
        if self._sizes_h is None:
            self._sizes_h = self.rows[-1].cpu().numpy()
        if torch.is_tensor(edges):
            edges = edges.cpu().numpy()
        req = self._sizes_h[np.asarray(edges)].max(axis=0)       # [E]
        out, prev = [], 0
        for width in classes:
            out.append((width, np.nonzero((req > prev) & (req <= width))[0]))
            prev = width
        if req.size and prev < req.max():
            raise ValueError(f"a query's set ({int(req.max())} slots) is "
                             f"wider than the last class {prev}")
        return out

    def fit_balanced(self, edges, labels, n_epochs: int, key: prng.Key,
                     classes: Sequence[int],
                     perms: Optional[Sequence[Sequence[torch.Tensor]]] = None):
        """`n_epochs` epochs over the queries grouped by
        `partition_by_width`, epoch e from split(key, n_epochs)[e] as in
        JAX's balanced fit: each epoch runs the classes in order, each a
        segment over the row tiles cut to its width with its own batch
        permutation, `riffle_permutation(fold_in(epoch key, class))`
        unless `perms[epoch][class]` gives it; the steps' dropout keys
        run on from the epoch key through the classes. The epoch's loss
        and AUC histogram are shared across classes. Returns (losses
        [n_epochs], aucs [n_epochs]) as device tensors and the
        partition."""
        dev = self.sets.nodes.device
        groups = self.partition_by_width(edges, classes)
        edges = torch.as_tensor(edges).to(dev, torch.int64)
        labels = torch.as_tensor(labels).to(dev, torch.float32)
        bs = self.config.batch_size
        segments = []
        for ci, (width, sel) in enumerate(groups):
            if len(sel):
                idx = torch.as_tensor(sel).to(dev)
                segments.append((ci, edges[:, idx], labels[idx],
                                 self._rows_at(width)))
        losses, aucs = [], []
        for epoch, ekey in enumerate(prng.split(key, n_epochs)):
            self.model.train()
            acc = self._new_acc(dev)
            kdrop = ekey
            for ci, e_c, l_c, rows in segments:
                if perms is None:
                    perm = riffle_permutation(prng.fold_in(ekey, ci),
                                              -(-e_c.shape[1] // bs), bs,
                                              device=dev)
                else:
                    perm = perms[epoch][ci]
                kdrop = self._segment(e_c, l_c, perm, kdrop, acc, rows)
            loss, auc = self._epoch_result(acc)
            losses.append(loss)
            aucs.append(auc)
        return torch.stack(losses), torch.stack(aucs), groups

    @torch.inference_mode()
    def predict_balanced(self, edges, classes: Sequence[int]
                         ) -> torch.Tensor:
        """`predict` class by class, each over the row tiles cut to its
        width, the scores put back in the queries' order."""
        dev = self.sets.nodes.device
        groups = self.partition_by_width(edges, classes)
        edges = torch.as_tensor(edges).to(dev, torch.int64)
        out = torch.zeros(edges.shape[1], device=dev)
        for width, sel in groups:
            if len(sel):
                idx = torch.as_tensor(sel).to(dev)
                out[idx] = self.predict(edges[:, idx], width=width)
        return out


def trainer_from_keys(model, spgk: SpGKeys, config: TrainConfig,
                      feature: Optional[torch.Tensor] = None,
                      join_factory: Optional[Callable] = None,
                      train_embed_mode: str = "table") -> DeviceTrainer:
    """DeviceTrainer over a packed-key SpG: the join unpacks landing-count
    features on the fly. Fills in the model's key_layout when unset.
    `join_factory(num_walks, num_steps)` builds the join (for example
    `lambda m, s: make_keys_join(m, s, impl="pallas")`); by default it is
    `make_keys_join` asked for what the model reads on the sets' device
    (`Net.join_outputs`). `train_embed_mode` is the JAX signature's
    keyword, passed to the trainer; the keys path reads no encoding
    table, so it changes nothing there, as in JAX."""
    if getattr(model, "key_layout", False) is None:
        model.key_layout = (spgk.num_walks, spgk.num_steps)
    if join_factory is None:
        join = make_keys_join(spgk.num_walks, spgk.num_steps,
                              **model.join_outputs(spgk.nodes.device))
    else:
        join = join_factory(spgk.num_walks, spgk.num_steps)
    return DeviceTrainer(model, spgk, config, join, feature=feature,
                         train_embed_mode=train_embed_mode)


def evaluate_device(trainer: DeviceTrainer,
                    inf_edge: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
                    metric: str):
    """Score the valid and test splits with the trainer's model and reduce
    them on the device; the host reads only the final scalars.
    inf_edge[split] = (pos_edge [Q, Ep], neg_edge [Q, En]). Returns
    (results, seconds of the test split): for a "Hits" metric
    {"Hits@K": (0, valid, test)} for K in 10, 20, 50, 100; for "AUC"
    (0, valid, test); otherwise the MRR (0, valid, test), each split's
    negatives taken k a positive (k = En // Ep, in the order
    `get_pos_neg_edges` lays them out)."""

    def split_scores(split):
        pos_edge, neg_edge = inf_edge[split]
        return trainer.predict(pos_edge), trainer.predict(neg_edge)

    pos_v, neg_v = split_scores("valid")
    t0 = time.time()
    pos_t, neg_t = split_scores("test")

    if "Hits" in metric:
        results = {}
        for k in (10, 20, 50, 100):
            results[f"Hits@{k}"] = (
                0,
                float(device_hits_at_k(pos_v, neg_v, k)),
                float(device_hits_at_k(pos_t, neg_t, k)),
            )
        return results, time.time() - t0
    if "AUC" in metric:
        def auc(pos, neg):
            labels = torch.cat([torch.ones_like(pos), torch.zeros_like(neg)])
            return float(device_auc(labels, torch.cat([pos, neg])))
        return (0, auc(pos_v, neg_v), auc(pos_t, neg_t)), time.time() - t0

    def mrr(pos, neg):
        k = neg.shape[0] // max(pos.shape[0], 1)
        return float(device_mrr(pos, neg[:pos.shape[0] * k].reshape(-1, k)))
    return (0, mrr(pos_v, neg_v), mrr(pos_t, neg_t)), time.time() - t0
