"""Weights from the JAX package's parameter tree.

`params_from_flax` turns a flax parameter tree of the link-prediction Net
(nested dicts of numpy arrays, with or without the top-level "params"
key) into a state_dict for `surel_plus_tpu_torch.models.Net`. flax Dense
kernels are [in, out]; torch Linear weights are [out, in].
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

# flax module -> torch module, and flax Dense name -> torch Linear name
MODULES = ("pe_embedding", "affinity_score", "feature_embedding")
DENSE = {"Dense_0": "fc0", "Dense_1": "fc1"}


def params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax Net params -> torch state_dict (float32 tensors)."""
    tree = tree.get("params", tree)
    unknown = set(tree) - set(MODULES)
    if unknown:
        raise KeyError(f"flax modules without a torch counterpart: "
                       f"{sorted(unknown)}")
    state = {}
    for mod, layers in tree.items():
        for dense, p in layers.items():
            name = f"{mod}.{DENSE[dense]}"
            state[f"{name}.weight"] = torch.as_tensor(
                np.asarray(p["kernel"], dtype=np.float32).T.copy())
            state[f"{name}.bias"] = torch.as_tensor(
                np.asarray(p["bias"], dtype=np.float32).copy())
    return state
