"""The scalar-encoder trainers (port of surel_plus_tpu/train/scalar.py):
the host engine and the device engine over a ScalarSpG, whose join
(`gather_join_scalar`) pairs float structural scores instead of
encoding-table indices (the reference's encode=None branch,
train.py:39-43)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from surel_plus_tpu_torch.ops.encoders import ScalarSpG, gather_join_scalar
from surel_plus_tpu_torch.train.device import DeviceTrainer
from surel_plus_tpu_torch.train.loop import LinkPredictor, TrainConfig


class ScalarLinkPredictor(LinkPredictor):
    """`LinkPredictor` over a ScalarSpG placed on `device`."""

    def __init__(self, model, sspg: ScalarSpG, config: TrainConfig,
                 feature: Optional[np.ndarray] = None, device="cuda"):
        super().__init__(model, sspg, config, join_fn=gather_join_scalar,
                         feature=feature, device=device)


def scalar_trainer_from_spg(model, sspg: ScalarSpG, config: TrainConfig,
                            feature: Optional[torch.Tensor] = None,
                            device="cuda") -> DeviceTrainer:
    """The device engine over a ScalarSpG: `DeviceTrainer` over its
    device layout on `device` with the float-pair join (Table 5's PPR +
    Mean and SPD + Mean rows at the device engine's rates, the reference's
    main.py:181-202)."""
    return DeviceTrainer(model, sspg.device(device), config,
                         join=gather_join_scalar, feature=feature)
