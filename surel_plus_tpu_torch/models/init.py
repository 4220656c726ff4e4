"""flax's initialisers as functions of a JAX key, so that one seed gives the
JAX package's initial weights (port of the `model.init(PRNGKey(s), ...)`
draws of surel_plus_tpu/models/).

Under `Module.init(key)`, flax gives each parameter the key
`fold_in_static(key, (*scope path, c))`: the names of the modules from
the root down to the parameter's (flax's scope path) and `c`, the count
of the parameter rngs its scope has made, this one included. Every
`param` makes one, whatever its initialiser draws: a Dense's kernel is
1 and its bias 2, the LSTM's wi 1, wh 2 and bh 3.

Each module lists its parameters as `Draw`s (`draws(path)`): the
parameter, its scope path and count, and its initialiser. `reset` draws
them; everything that needs a parameter's key or bounds (the tests, the
chip smoke) reads the same list. Each initialiser draws in flax's layout
([in, out] for a kernel), so the flat order of the draw is flax's; a
Linear's kernel is transposed into its [out, in] after the draw, as
`convert.params_from_flax` does. The words come from K8 on a CUDA device
(one launch a drawn parameter), and the transform runs on the same
device.
"""

from __future__ import annotations

from typing import Iterable, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from surel_plus_tpu_torch.ops import prng

Path = Tuple[Union[str, int], ...]

# the standard deviation of a standard normal truncated to (-2, 2)
TRUNCATED_STD = 0.87962566103423978


def xavier_normal(key: prng.Key, shape, device) -> torch.Tensor:
    """flax's `xavier_normal()` (variance_scaling(1, "fan_avg",
    "truncated_normal")) of a [fan_in, fan_out] kernel: a normal truncated
    to (-2, 2) times sqrt(2 / (fan_in + fan_out)) / TRUNCATED_STD, the
    scale rounded to float32 as JAX rounds it."""
    fan_in, fan_out = int(shape[-2]), int(shape[-1])
    variance = np.float32(1.0 / ((fan_in + fan_out) / 2))
    std = np.sqrt(variance) / np.float32(TRUNCATED_STD)
    scale = torch.full((), float(std), dtype=torch.float32, device=device)
    return prng.truncated_normal(key, -2.0, 2.0, shape, device) * scale


class Draw(NamedTuple):
    """One parameter of flax's `init`: the port's tensor, flax's scope
    `path` and rng `count` of it, and its initialiser ("xavier",
    "uniform" over (-bound, bound), or "zeros", which draws nothing but
    still takes its count). `transposed`: the port stores flax's
    [in, out] kernel as [out, in]."""
    param: torch.Tensor
    path: Path
    count: int
    init: str
    transposed: bool = False
    bound: float = 0.0

    @property
    def shape(self) -> Tuple[int, ...]:
        """The shape flax draws, in its layout."""
        shape = tuple(self.param.shape)
        return shape[::-1] if self.transposed else shape

    def key(self, root: prng.Key) -> prng.Key:
        """The parameter's key under `init(root)`."""
        return prng.fold_in_static(root, (*self.path, self.count))

    def bounds(self) -> Tuple[float, float]:
        """The bounds of the uniform the draw maps (a truncated normal's
        erf(-sqrt 2), erf(sqrt 2) for xavier)."""
        if self.init == "xavier":
            return prng.truncation(-2.0, 2.0)[:2]
        return -self.bound, self.bound

    def value(self, root: prng.Key) -> Optional[torch.Tensor]:
        """The drawn values in flax's layout on the parameter's device
        (None for zeros)."""
        device = self.param.device
        if self.init == "xavier":
            return xavier_normal(self.key(root), self.shape, device)
        if self.init == "uniform":
            return prng.uniform(self.key(root), self.shape, device,
                                *self.bounds())
        return None


def dense_draws(layer: nn.Linear, path: Path) -> List[Draw]:
    """flax's Dense at scope `path`: an xavier-normal kernel (count 1),
    stored transposed, and a zero bias (count 2)."""
    return [Draw(layer.weight, path, 1, "xavier", transposed=True),
            Draw(layer.bias, path, 2, "zeros")]


def reset(draws: Iterable[Draw], root: prng.Key) -> None:
    """Draw every parameter of `draws` as flax's `init(root)` does."""
    with torch.no_grad():
        for d in draws:
            v = d.value(root)
            if v is None:
                d.param.zero_()
            else:
                d.param.copy_(v.t() if d.transposed else v)
