"""Device-resident scoring and ranking metrics (port of the inference half
of surel_plus_tpu/train/device.py).

`DeviceTrainer.predict` scores query edges batch by batch: the join and
the model run on the sets' device, one batch per step, with the tail
batch padded with zero edges as in the reference.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from surel_plus_tpu_torch.ops.join import make_keys_join
from surel_plus_tpu_torch.spg.spg import SpGKeys
from surel_plus_tpu_torch.train.loop import TrainConfig


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
    """Scores query edges over a device-resident SpGKeys with a Net.

    join(nodes, khi, klo, sizes, edges) -> JoinedBatch; `feature`
    optional raw node features [n, x_dim] on the sets' device."""

    def __init__(self, model: torch.nn.Module, spgk: SpGKeys,
                 config: TrainConfig, join: Callable,
                 feature: Optional[torch.Tensor] = None):
        self.model = model
        self.spgk = spgk
        self.config = config
        self.join = join
        self.feature = feature

    @torch.inference_mode()
    def predict(self, edges) -> torch.Tensor:
        """Score [Q, E] query edges (numpy or tensor of SpG row ids);
        returns sigmoid scores [E] float32 on the sets' device."""
        s = self.spgk
        dev = s.nodes.device
        edges = torch.as_tensor(edges).to(dev, torch.int64)
        bs = self.config.batch_size
        E = edges.shape[1]
        pad = (-E) % bs
        if pad:
            edges = torch.cat([edges, edges.new_zeros(edges.shape[0], pad)],
                              dim=1)
        self.model.eval()
        out = []
        for i in range(0, E + pad, bs):
            be = edges[:, i:i + bs]
            joined = self.join(s.nodes, s.khi, s.klo, s.sizes, be)
            feat = self.feature[be] if self.feature is not None else None
            out.append(torch.sigmoid(self.model(joined, feat)))
        return torch.cat(out)[:E]


def trainer_from_keys(model, spgk: SpGKeys, config: TrainConfig,
                      feature: Optional[torch.Tensor] = None
                      ) -> DeviceTrainer:
    """DeviceTrainer over a packed-key SpG: the join unpacks landing-count
    features on the fly. Fills in the model's key_layout when unset, and
    asks the join for slot-aligned outputs only when the model takes its
    unfused route on the sets' device."""
    if getattr(model, "key_layout", False) is None:
        model.key_layout = (spgk.num_walks, spgk.num_steps)
    aligned = not model.fused_on(spgk.nodes.device)
    join = make_keys_join(spgk.num_walks, spgk.num_steps, aligned=aligned)
    return DeviceTrainer(model, spgk, config, join, feature=feature)
