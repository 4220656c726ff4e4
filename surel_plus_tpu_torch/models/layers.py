"""Shared model layers (port of surel_plus_tpu/models/layers.py: MLP2,
MergeLayer, masked_mean, AttentionAggregation, LSTMAggregation).

Parameters stay float32; `dtype` is the compute precision of the hot
layers (bfloat16 at the bench width), applied by casting at call time as
flax's `Dense(dtype=...)` does. Each module's `draws(path)` lists its
parameters as flax's `init` draws those of the JAX module at scope
`path`, and `reset_parameters(key, path)` draws them under `key`
(`models/init.py`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from surel_plus_tpu_torch.models import init
from surel_plus_tpu_torch.ops import prng
from surel_plus_tpu_torch.ops.kernels.attn_pool import fused_attn_pool
from surel_plus_tpu_torch.ops.kernels.lstm import lstm_final_hidden
from surel_plus_tpu_torch.ops.kernels.lstm_keys import (
    lstm_from_keys,
    lstm_scan_plain,
)


def _dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype):
    return nn.functional.linear(x.to(dtype), layer.weight.to(dtype),
                                layer.bias.to(dtype))


class MLP2(nn.Module):
    """Linear -> ReLU -> Linear (the reference's pe_embedding /
    feature_embedding). `hidden` and `project` expose the two halves so
    that callers can reduce between them: sums and means commute with the
    second, linear layer."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc0 = nn.Linear(in_dim, hidden_dim)
        self.fc1 = nn.Linear(hidden_dim, out_dim)
        self.dtype = dtype

    def draws(self, path: init.Path = ()) -> List[init.Draw]:
        """fc0 and fc1 as flax's Dense_0 and Dense_1 under `path`."""
        return (init.dense_draws(self.fc0, (*path, "Dense_0"))
                + init.dense_draws(self.fc1, (*path, "Dense_1")))

    def reset_parameters(self, key: prng.Key, path: init.Path = ()) -> None:
        init.reset(self.draws(path), key)

    def forward(self, x):
        return self.project(self.hidden(x))

    def hidden(self, x):
        """First layer + relu, in the compute dtype."""
        return torch.relu(_dense(x, self.fc0, self.dtype))

    def hidden_raw(self):
        """fc0's (kernel [in, hidden], bias) in flax's orientation,
        uncast: callers pick the compute dtype."""
        return self.fc0.weight.t(), self.fc0.bias

    def project(self, h):
        """Second (linear) layer, in the compute dtype."""
        return _dense(h, self.fc1, self.dtype)

    def project_raw(self):
        """fc1's (kernel [hidden, out], bias) in flax's orientation,
        uncast, for algebraic folds."""
        return self.fc1.weight.t(), self.fc1.bias


# flax's scope path of the JAX package's one nn.Dropout: the MergeLayer
# that Net and HONet both name "affinity_score" (models/net.py:251-253,
# models/honet.py:101-103), its compact Dropout_0 (models/layers.py:90),
# and the scope's dropout rng counter after its one make_rng of an apply
DROPOUT_PATH = ("affinity_score", "Dropout_0", 1)


class MergeLayer(nn.Module):
    """Two-layer scorer over concatenated endpoint embeddings. The first
    layer runs in the compute dtype, the last in float32 for a stable
    logit. In training mode, dropout after the first layer is flax's
    Dropout under the JAX package's scope path (`dropout`), so that the
    apply's dropout `key` drops what flax drops."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int = 1,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc0 = nn.Linear(in_dim, hidden_dim)
        self.fc1 = nn.Linear(hidden_dim, out_dim)
        self.dropout = dropout
        self.dtype = dtype

    def draws(self, path: init.Path = ()) -> List[init.Draw]:
        """fc0 and fc1 as flax's Dense_0 and Dense_1 under `path`."""
        return (init.dense_draws(self.fc0, (*path, "Dense_0"))
                + init.dense_draws(self.fc1, (*path, "Dense_1")))

    def reset_parameters(self, key: prng.Key, path: init.Path = ()) -> None:
        init.reset(self.draws(path), key)

    def forward(self, xs: Sequence[torch.Tensor],
                key: Optional[prng.Key] = None) -> torch.Tensor:
        x = torch.cat(list(xs), dim=-1)
        h = torch.relu(_dense(x, self.fc0, self.dtype))
        if self.training and self.dropout > 0:
            h = dropout(h, self.dropout, key)
        return self.fc1(h.to(torch.float32))


def dropout(h: torch.Tensor, rate: float,
            key: Optional[prng.Key]) -> torch.Tensor:
    """flax's nn.Dropout(rate) at the scope path DROPOUT_PATH under the
    apply's dropout key `key`: keep where bernoulli(fold_in_static(key,
    DROPOUT_PATH), 1 - rate, h.shape), kept entries divided by 1 - rate
    rounded to h's dtype (as JAX divides by a weakly typed scalar), the
    others 0. Raises, as flax does, when there is no key to draw from."""
    if rate >= 1.0:
        return torch.zeros_like(h)
    if key is None:
        raise ValueError("dropout in training mode needs a key (the JAX "
                         "package's dropout rng)")
    keep = 1.0 - rate
    mask = prng.bernoulli(prng.fold_in_static(key, DROPOUT_PATH), keep,
                          h.shape, h.device)
    # device scalars (a fill, not a host copy): a true division, no sync
    scale = torch.full((), keep, dtype=h.dtype, device=h.device)
    return torch.where(mask, h / scale, torch.zeros_like(scale))


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over the set axis (-2) honoring the mask; empty sets give 0."""
    m = mask[..., None].to(x.dtype)
    s = (x * m).sum(dim=-2)
    cnt = m.sum(dim=-2).clamp(min=1.0)
    return s / cnt


class AttentionAggregation(nn.Module):
    """Gated attention pooling (PyG AttentionalAggregation with gate_nn =
    Linear(h, 1) and fnn = Linear(h, h), reference model.py:59-62):
    softmax of a scalar gate over each set, weighted sum of the
    transformed elements. Both Linears compute in float32 whatever their
    input's dtype, as flax's Dense without a dtype promotes a bfloat16
    input against its float32 parameters."""

    def __init__(self, hidden_dim: int):
        super().__init__()
        self.gate_nn = nn.Linear(hidden_dim, 1)
        self.value_nn = nn.Linear(hidden_dim, hidden_dim)

    def draws(self, path: init.Path = ()) -> List[init.Draw]:
        """The gate and value Linears as flax's Dense_0 and Dense_1."""
        return (init.dense_draws(self.gate_nn, (*path, "Dense_0"))
                + init.dense_draws(self.value_nn, (*path, "Dense_1")))

    def reset_parameters(self, key: prng.Key, path: init.Path = ()) -> None:
        init.reset(self.draws(path), key)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x [..., L, h], mask bool [..., L] -> [..., h] float32."""
        m = mask[..., None]
        gate = _dense(x, self.gate_nn, torch.float32)          # [..., L, 1]
        gate = torch.where(m, gate, -torch.inf)
        attn = torch.where(m, torch.softmax(gate, dim=-2), 0.0)
        return (attn * _dense(x, self.value_nn, torch.float32)).sum(dim=-2)

    def folded(self, hsum: torch.Tensor, mask: torch.Tensor, w2, c2
               ) -> torch.Tensor:
        """The same pooling with the upstream projection x = hsum @ w2 + c2
        and the value Linear folded past the softmax (both are affine and
        the weights of a never-empty set sum to 1): only the scalar gate
        is computed per slot. The gate, the softmax and the pool run in
        hsum's dtype, the value Linear in float32, as the JAX package's
        `folded` does."""
        cd = hsum.dtype
        wg = self.gate_nn.weight.t()                            # [h, 1]
        gvec = w2.to(cd) @ wg.to(cd)
        gconst = c2 @ wg + self.gate_nn.bias
        m = mask[..., None]
        gate = torch.where(m, hsum @ gvec + gconst.to(cd), -torch.inf)
        attn = torch.where(m, torch.softmax(gate, dim=-2), 0.0)
        pooled = (attn * hsum).sum(dim=-2)                      # [..., h]
        return _dense(pooled @ w2.to(cd) + c2.to(cd), self.value_nn,
                      torch.float32)

    def folded_from_keys(self, kown, kcross_al, mask, u_ext, shift: int,
                         w2, c2, root_own=None, root_cross=None
                         ) -> torch.Tensor:
        """The same pooling with the upstream projection x = hsum @ w2 + c2
        and the value Linear folded past the softmax (both are affine and
        the weights of a never-empty set sum to 1), and the rest fused to
        the packed keys (`fused_attn_pool`): only the scalar gate is
        computed per slot, from gvec = w2 @ wg and gconst = c2 @ wg + bg,
        all in float32. Differentiable."""
        w2f = w2.to(torch.float32)
        wg = self.gate_nn.weight.t()                            # [h, 1]
        gvec = w2f @ wg
        gconst = c2 @ wg + self.gate_nn.bias
        pooled = fused_attn_pool(kown, kcross_al, mask, u_ext, gvec, gconst,
                                 shift, root_own=root_own,
                                 root_cross=root_cross)         # [Q, B, h]
        return _dense(pooled @ w2f + c2, self.value_nn, torch.float32)


class LSTMAggregation(nn.Module):
    """LSTM over each set's slots in order, its final hidden state the set
    embedding (PyG LSTMAggregation, reference model.py:63-65). A masked
    slot leaves the carry as it is. Gates in (i, f, g, o) order, as
    torch's nn.LSTM stacks them; the parameters keep flax's orientation
    (wi [H, 4H], wh [H, 4H], bh [4H]: nn.LSTM's weight_ih is wi.T). The
    input width is H, as in the Net (the JAX module sizes wi from its
    input, or from the fold's w2).

    Initialization: xavier-normal wi and wh with a zero bh, or with
    `torch_init` torch's nn.LSTM uniform U(-1/sqrt(H), 1/sqrt(H)) on all
    three, each from its flax key (`reset_parameters`). The JAX module's
    `unroll` and `chunk` tune its `lax.scan` and its rematerialization;
    eager PyTorch has neither, so they have no counterpart here."""

    def __init__(self, hidden_dim: int, torch_init: bool = False):
        super().__init__()
        h4 = 4 * hidden_dim
        self.hidden_dim = hidden_dim
        self.torch_init = torch_init
        self.wi = nn.Parameter(torch.empty(hidden_dim, h4))
        self.wh = nn.Parameter(torch.empty(hidden_dim, h4))
        self.bh = nn.Parameter(torch.empty(h4))

    def draws(self, path: init.Path = ()) -> List[init.Draw]:
        """wi, wh and bh as flax's params 1, 2 and 3 of the scope `path`:
        uniform with `torch_init`, else xavier and zeros."""
        if self.torch_init:
            bound = float(self.hidden_dim) ** -0.5
            return [init.Draw(p, path, c, "uniform", bound=bound)
                    for c, p in enumerate((self.wi, self.wh, self.bh), 1)]
        return [init.Draw(self.wi, path, 1, "xavier"),
                init.Draw(self.wh, path, 2, "xavier"),
                init.Draw(self.bh, path, 3, "zeros")]

    def reset_parameters(self, key: prng.Key, path: init.Path = ()) -> None:
        init.reset(self.draws(path), key)

    def forward(self, x: Optional[torch.Tensor], mask: torch.Tensor,
                fold=None, keys=None,
                dtype: Optional[torch.dtype] = None,
                fast: bool = False) -> torch.Tensor:
        """x [..., L, H], mask bool [..., L] -> [..., H] in x's dtype.

        fold=(w2, c2): x is the hidden rows before the upstream affine
        projection x @ w2 + c2, which folds into the input weights:
        wi_eff = w2 @ wi in x's dtype, bh_eff = bh + c2 @ wi in float32.

        keys=(kown, kcross_al, mask, u_ext, shift, root_own, root_cross):
        the recurrence runs from the packed keys (`lstm_from_keys`, with
        the fold), and x may be None with `dtype` the compute dtype: the
        per-slot rows are never formed.

        fast (without keys): the recurrence runs in `lstm_final_hidden`
        (float32 from the input product on; K5 and K5 bwd on the card)
        instead of the scan."""
        cd = x.dtype if x is not None else dtype
        wi_eff, bh_eff = self.wi, self.bh.to(torch.float32)
        if fold is not None:
            w2, c2 = fold
            wi_eff = w2.to(cd) @ self.wi.to(cd)
            bh_eff = bh_eff + (c2 @ self.wi.to(c2.dtype)).reshape(-1)
        if keys is not None:
            kown, kcross_al, kmask, u_ext, shift, ro, rc = keys
            hidden = lstm_from_keys(kown, kcross_al, kmask, u_ext, wi_eff,
                                    self.wh, bh_eff, shift, root_own=ro,
                                    root_cross=rc)
            return hidden.to(cd)
        *batch, ell, h = x.shape
        run = lstm_final_hidden if fast else lstm_scan_plain
        hidden = run(x.reshape(-1, ell, h), mask.reshape(-1, ell), wi_eff,
                     self.wh, bh_eff)
        return hidden.reshape(*batch, self.hidden_dim).to(cd)
