"""Training configuration (port of surel_plus_tpu/train/loop.py:TrainConfig)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class TrainConfig:
    batch_size: int = 1024
    lr: float = 1e-3
    epochs: int = 200
    eval_steps: int = 5
    early_stop: int = -1
    grad_clip: float = 1.0
    seed: int = 0
