"""Checkpoints: the model's parameters, the optimizer's state, the epoch,
the epoch key and the numpy generator's state (port of
surel_plus_tpu/utils/checkpoint.py).

The reference saves `{state_dict, optimizer, epoch}` on early stop and
reloads it for inference-only runs (utils.py:112-122, main.py:221-228,
249-254); the JAX package keeps an orbax directory of params, optimizer
state, epoch and PRNG key. Here one `torch.save` file at the same path
holds a dict of state dicts, tensors, numbers, strings and the numpy
generator's state dict: no module or closure is pickled, and
`load_checkpoint` reads it with `weights_only=True`.

The CLIs' state: `params` (the Net's or HONet's `state_dict`),
`opt_state` (the Adam optimizer's `state_dict`), `epoch`, `key` (the
epoch key as JAX stores it, two uint32 words, a torch.uint32 tensor
here: the next blocks' batch permutations and dropout masks, so a JAX
checkpoint's key resumes with JAX's draws) and `rng` (the numpy
generator's `bit_generator.state`: the host engine's permutations).
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch


def save_checkpoint(state: Dict[str, Any], path: str) -> str:
    """Save `state` to the file `path` (its directory is made). Returns
    the absolute path."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(state, path)
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The dict `save_checkpoint` wrote, its tensors on the CPU."""
    return torch.load(os.path.abspath(path), map_location="cpu",
                      weights_only=True)
