"""Packed-key set store (port of surel_plus_tpu/spg/spg.py:SpGKeys)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class SpGKeys:
    """Sampled sets with each slot's packed landing-count key.

    Keys are unsigned 32-bit words held as int32 bit patterns (torch has
    no full uint32 arithmetic); `ops.walk.u32` reads them back as int64.
    Key 0 is the zero encoding (an absent partner).
    """

    nodes: torch.Tensor   # int32 [n, L] ascending, pad INT32_MAX
    khi: torch.Tensor     # int32 bits [n, L]
    klo: torch.Tensor     # int32 bits [n, L]
    sizes: torch.Tensor   # int32 [n]
    num_walks: int
    num_steps: int
