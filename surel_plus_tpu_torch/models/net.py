"""Link-prediction set encoder, mean aggregator (port of
surel_plus_tpu/models/net.py:Net over packed-key joins).

Pipeline: packed keys -> pe_embedding hidden layer -> pair sum -> masked
set mean -> pe_embedding projection -> optional raw-feature branch ->
MergeLayer scorer. The set mean is taken BEFORE the (linear) projection:
masked_mean(pe(e).sum(-2)) == pe.project(masked_mean(hsum)) + b2, since
every valid slot carries two second-layer biases.

Two routes compute the same logits:

* fused: the kernel `fused_key_hidden_sum` computes the hidden layer and
  the set sums straight from the packed keys (CUDA kernel on the card,
  its plain version on the CPU); needs the join's merged-order planes.
* unfused: the hidden layer over the join's unpacked feature pairs, as
  the JAX package's XLA path does; needs an aligned join.

`fused_hidden=None` picks the fused route on CUDA and the unfused one on
the CPU. Both routes are differentiable: the fused route's gradient for
W1 and b1 flows through the kernel's autograd Function into u_ext.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from surel_plus_tpu_torch.models.layers import MLP2, MergeLayer, masked_mean
from surel_plus_tpu_torch.ops.join import JoinedBatch
from surel_plus_tpu_torch.ops.kernels.hidden_sum import (
    NEG,
    fused_key_hidden_sum,
    u_core_rows,
)


def _torch_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


class Net(nn.Module):
    """Scores Q=2 endpoint sets per query; returns logits [B].

    input_dim: encoding columns (num_steps + 1). dtype: compute precision
    of the hot layers ("float32" or "bfloat16"); parameters stay float32.
    Weights are xavier-normal from `generator` (biases zero), made on the
    CPU and then moved to `device`, so one seed gives the same weights on
    every device. key_layout: (num_walks, num_steps) of the packed keys,
    needed by the fused route (trainer_from_keys fills it in).
    """

    def __init__(self, input_dim: int, hidden_dim: int = 96,
                 out_dim: int = 1, x_dim: int = 0, dropout: float = 0.1,
                 use_feature: bool = False, aggrs: str = "mean",
                 dtype: Union[str, torch.dtype] = "float32",
                 fused_hidden: Optional[bool] = None,
                 key_layout: Optional[Tuple[int, int]] = None,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        if aggrs != "mean":
            raise NotImplementedError(
                f"aggregator {aggrs!r} is not ported yet (mean only)")
        self.hidden_dim = hidden_dim
        self.dtype = _torch_dtype(dtype)
        self.fused_hidden = fused_hidden
        self.key_layout = key_layout
        self.use_feature = use_feature
        self.pe_embedding = MLP2(input_dim, hidden_dim, hidden_dim,
                                 self.dtype)
        width = hidden_dim
        if use_feature:
            self.feature_embedding = MLP2(x_dim, hidden_dim, hidden_dim,
                                          self.dtype)
            width += hidden_dim
        self.affinity_score = MergeLayer(2 * width, hidden_dim, out_dim,
                                         dropout, self.dtype)
        self.reset_parameters(generator)
        self.to(device)

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        """Xavier-normal weights from the CPU `generator`, zero biases."""
        for m in self.children():
            m.reset_parameters(generator)

    def fused_on(self, device: torch.device) -> bool:
        """Whether forward takes the fused route for tensors on `device`."""
        if self.fused_hidden is not None:
            return self.fused_hidden
        return torch.device(device).type == "cuda"

    def forward(self, joined: JoinedBatch,
                feature: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """joined: JoinedBatch over [2, B, L] rows; feature: optional raw
        endpoint features [2, B, x_dim]; generator: the dropout mask's
        generator in training mode. Returns logits [B] float32."""
        pe = self.pe_embedding
        cd = self.dtype
        if self.fused_on(joined.mask.device):
            if joined.kown is None or self.key_layout is None:
                raise ValueError("the fused route needs a keys join and "
                                 "key_layout")
            nw, ns = self.key_layout
            w1, b1 = pe.hidden_raw()
            # kernel compute stays fp32
            u_ext = torch.cat([
                u_core_rows(w1, nw, ns),
                torch.full((1, self.hidden_dim), NEG, dtype=torch.float32,
                           device=w1.device),
                b1.to(torch.float32)[None]], dim=0).contiguous()
            sums = fused_key_hidden_sum(
                joined.kown, joined.mask, joined.kcross, joined.kcross_mask,
                u_ext, int(nw).bit_length(), root_own=joined.kown_root,
                root_cross=joined.kcross_root)
            cnt = joined.mask.sum(dim=-1).clamp(min=1)          # [Q, B]
            mean = (sums / cnt[..., None].to(torch.float32)).to(cd)
        else:
            if joined.eidx is None:
                raise ValueError("the unfused route needs an aligned join "
                                 "(make_keys_join(..., aligned=True))")
            hsum = pe.hidden(joined.eidx).sum(dim=-2)        # [2, B, L, h]
            mean = masked_mean(hsum, joined.mask)
        b2v = pe.project(mean.new_zeros(1, self.hidden_dim))
        agg = pe.project(mean) + b2v
        return self._score(agg, feature, generator)

    def _score(self, agg: torch.Tensor, feature: Optional[torch.Tensor],
               generator: Optional[torch.Generator]) -> torch.Tensor:
        """Endpoint concat + optional raw-feature branch + MergeLayer."""
        agg = agg.to(torch.float32)
        xl, xr = agg[0], agg[1]                              # [B, h]
        if self.use_feature:
            if feature is None:
                raise ValueError("use_feature=True requires features")
            femb = self.feature_embedding(feature).to(torch.float32)
            xl = torch.cat([xl, femb[0]], dim=-1)
            xr = torch.cat([xr, femb[1]], dim=-1)
        return self.affinity_score([xl, xr], generator).squeeze(-1)
