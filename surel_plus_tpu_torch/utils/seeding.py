"""Deterministic seeding (port of surel_plus_tpu/utils/seeding.py).

The host-side data prep draws from the numpy `Generator` this returns, in
the JAX package's order; torch's generators are seeded too.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def set_random_seed(seed: int) -> np.random.Generator:
    np.random.seed(seed)
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    torch.manual_seed(seed)
    return np.random.default_rng(seed)
