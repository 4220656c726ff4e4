"""Weights from the JAX package's parameter tree.

`params_from_flax` turns a flax parameter tree of the link-prediction Net
(nested dicts of numpy arrays, with or without the top-level "params"
key) into a state_dict for `surel_plus_tpu_torch.models.Net`. flax Dense
kernels are [in, out]; torch Linear weights are [out, in]. The attention
aggregator's Denses (`aggr`: Dense_0 the gate, Dense_1 the value) map to
its gate_nn and value_nn. An LSTM aggregator's tree (`aggr`: wi, wh, bh)
maps to the parameters of the same names as it is: LSTMAggregation keeps
flax's orientation.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

# flax module -> its flax Dense names -> torch Linear names
MLP_DENSE = {"Dense_0": "fc0", "Dense_1": "fc1"}
MODULES = {"pe_embedding": MLP_DENSE, "affinity_score": MLP_DENSE,
           "feature_embedding": MLP_DENSE,
           "aggr": {"Dense_0": "gate_nn", "Dense_1": "value_nn"}}
LSTM_PARAMS = ("wi", "wh", "bh")   # LSTMAggregation's, copied untransposed


def _tensor(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float32).copy())


def params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax Net params -> torch state_dict (float32 tensors)."""
    tree = tree.get("params", tree)
    unknown = set(tree) - set(MODULES)
    if unknown:
        raise KeyError(f"flax modules without a torch counterpart: "
                       f"{sorted(unknown)}")
    state = {}
    for mod, layers in tree.items():
        if mod == "aggr" and set(layers) == set(LSTM_PARAMS):
            state.update({f"aggr.{k}": _tensor(layers[k])
                          for k in LSTM_PARAMS})
            continue
        unknown = set(layers) - set(MODULES[mod])
        if unknown:
            raise KeyError(f"flax parameters of {mod} without a torch "
                           f"counterpart: {sorted(unknown)}")
        for dense, p in layers.items():
            name = f"{mod}.{MODULES[mod][dense]}"
            state[f"{name}.weight"] = _tensor(np.asarray(p["kernel"]).T)
            state[f"{name}.bias"] = _tensor(p["bias"])
    return state
