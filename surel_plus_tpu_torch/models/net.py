"""Link-prediction set encoder, mean, attention and LSTM aggregators (port
of surel_plus_tpu/models/net.py:Net over packed-key and encoding-table
joins).

Pipeline: packed keys or encoding-table indices -> pe_embedding hidden
layer -> pair sum -> masked set aggregation -> optional raw-feature
branch -> MergeLayer scorer.

mean: the set mean is taken BEFORE the (linear) projection:
masked_mean(pe(e).sum(-2)) == pe.project(masked_mean(hsum)) + b2, since
every valid slot carries two second-layer biases.

attn: AttentionAggregation over x = pe.project(hsum) + b2 per slot. Its
fused form folds the projection and the value Linear past the softmax,
so only a scalar gate per slot remains (x = hsum @ W2 + 2 b2).

lstm: LSTMAggregation over x = pe.project(hsum) + b2 per slot. Its fused
form folds the projection into the recurrence's input weights
(wi_eff = W2 @ wi, bh_eff = bh + 2 b2 @ wi) and runs it from the keys.

Over a keys join, two routes compute the same logits:

* fused: a kernel reads the packed keys and never materializes a per-slot
  hidden row (CUDA kernels on the card, their plain versions on the CPU):
  `fused_key_hidden_sum` for mean, on the join's merged-order planes;
  `fused_attn_pool` for attn and `lstm_from_keys` for lstm, on the
  slot-aligned keys.
* unfused: the per-slot hidden rows hsum [2, B, L, h] first, then the
  aggregator over them: over a join that carries feature pairs, the
  hidden layer over the unpacked pairs and their sum, as the JAX
  package's XLA path does (the CPU default); over a join that carries
  the slot-aligned keys and no pairs (the CUDA default),
  `fused_key_hidden_slots` from the keys (K7, and K7 bwd in training,
  on the card; the JAX package's `fused_key_hidden_slots`).

Over an encoding-table join (`gather_join`: integer eidx, with
`enc_table` given to forward), the per-slot hidden rows hsum are formed
first: by `embed_mode` "table", the hidden layer over the table once and
two row gathers (the cheapest forward; its backward is a scatter-add), or
"direct", the hidden layer over the gathered encoding pairs (no scatter
in the backward; the trainer trains this way). So are they over a keys
join that carries no key planes (impl="pallas", or the general hi/lo
layout: only the feature pairs and the mask), as the JAX Net falls
through to `pe.hidden` there, and over a scalar join
(`gather_join_scalar`: float value pairs eidx [2, B, L, 2], input_dim 1,
the PPR / SPD / DEG paths), the hidden layer over each value of the pair
and their sum. Then the fused route takes `masked_mean`
for mean, `AttentionAggregation.folded` for attn and `lstm_final_hidden`
(K5, and K5 bwd in training, on the card) for lstm, the projection
folded in; the unfused route projects every slot first.

`fused_hidden=None` picks the fused route on CUDA and the unfused one on
the CPU. Every route is differentiable: the keys routes' gradients for
W1 and b1 (fused, and unfused over the aligned keys) flow through the
kernels' autograd Functions into u_ext,
and the fused lstm routes' for W2, b2 and the LSTM's weights through the
fold into wi_eff and bh_eff (and, over hsum, into hsum through K5 bwd's
dx). The JAX Net trains its fused lstm route over hsum through its scan
(net.py:219-224), with the input product in the compute dtype; here it
runs in float32 on K5 and K5 bwd, so the two agree in float32.
`join_outputs` says which keys-join outputs the route reads, so that the
join builds only those (eager PyTorch does no dead-code elimination).
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch
from torch import nn

from surel_plus_tpu_torch.models import init
from surel_plus_tpu_torch.models.layers import (
    AttentionAggregation,
    LSTMAggregation,
    MergeLayer,
    MLP2,
    masked_mean,
)
from surel_plus_tpu_torch.ops import prng
from surel_plus_tpu_torch.ops.join import JoinedBatch
from surel_plus_tpu_torch.ops.kernels.hidden_sum import (
    NEG,
    fused_key_hidden_slots,
    fused_key_hidden_sum,
    u_core_rows,
)


EMBED_MODES = ("table", "direct")


def _torch_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def key_u_ext(pe: MLP2, key_layout: Tuple[int, int]) -> torch.Tensor:
    """u_ext [ncol + 2, H] fp32 for the fused kernels from the hidden layer
    of `pe`: W1's rows in the kernels' field order, the masking row, b1."""
    nw, ns = key_layout
    w1, b1 = pe.hidden_raw()
    return torch.cat([
        u_core_rows(w1, nw, ns),
        torch.full((1, w1.shape[1]), NEG, dtype=torch.float32,
                   device=w1.device),
        b1.to(torch.float32)[None]], dim=0).contiguous()


def table_hsum(pe: MLP2, eidx: torch.Tensor,
               enc_table: Optional[torch.Tensor],
               embed_mode: str) -> torch.Tensor:
    """The pair-summed hidden rows [Q, B, L, h] of an encoding-table join's
    index pairs eidx [Q, B, L, 2]: by `embed_mode` "table", the hidden
    layer over the table once and two row gathers, or "direct", the hidden
    layer over the gathered encoding pairs."""
    if enc_table is None:
        raise ValueError("an encoding-table join needs enc_table")
    if embed_mode == "direct":
        return pe.hidden(enc_table[eidx]).sum(dim=-2)
    if embed_mode != "table":
        raise ValueError(f"unknown embed_mode {embed_mode!r}")
    htable = pe.hidden(enc_table)                            # [W+1, h]
    return htable[eidx[..., 0]] + htable[eidx[..., 1]]


class Net(nn.Module):
    """Scores Q=2 endpoint sets per query; returns logits [B].

    aggrs: "mean", "attn" or "lstm"; any other raises ValueError.
    input_dim: encoding columns (num_steps + 1). dtype: compute precision
    of the hot layers ("float32" or "bfloat16"); parameters stay float32.
    The weights are flax's `init(key)` of the JAX Net (`reset_parameters`),
    drawn on `device`; one key gives the same weights on every device.
    `key` must be given, as flax's `init` takes one: None builds without
    drawing (NaN parameters until `reset_parameters` or a trainer's
    `init` draws them).
    key_layout: (num_walks, num_steps) of the packed keys, needed by the
    fused keys route (trainer_from_keys fills it in).
    embed_mode: "table" or "direct", how an encoding-table join's hidden
    rows are formed (same parameters either way).
    """

    def __init__(self, input_dim: int, hidden_dim: int = 96,
                 out_dim: int = 1, x_dim: int = 0, dropout: float = 0.1,
                 use_feature: bool = False, aggrs: str = "mean",
                 dtype: Union[str, torch.dtype] = "float32",
                 fused_hidden: Optional[bool] = None,
                 key_layout: Optional[Tuple[int, int]] = None,
                 embed_mode: str = "table",
                 *, key: Optional[prng.Key], device="cuda"):
        super().__init__()
        if aggrs not in ("mean", "attn", "lstm"):
            raise ValueError(f"unknown aggregator {aggrs!r}")
        if embed_mode not in EMBED_MODES:
            raise ValueError(f"unknown embed_mode {embed_mode!r}")
        self.aggrs = aggrs
        self.embed_mode = embed_mode
        self.hidden_dim = hidden_dim
        self.dtype = _torch_dtype(dtype)
        self.fused_hidden = fused_hidden
        self.key_layout = key_layout
        self.use_feature = use_feature
        with torch.device("meta"):          # storage comes with `device`
            self.pe_embedding = MLP2(input_dim, hidden_dim, hidden_dim,
                                     self.dtype)
            if aggrs == "attn":
                self.aggr = AttentionAggregation(hidden_dim)
            elif aggrs == "lstm":
                self.aggr = LSTMAggregation(hidden_dim)
            width = hidden_dim
            if use_feature:
                self.feature_embedding = MLP2(x_dim, hidden_dim, hidden_dim,
                                              self.dtype)
                width += hidden_dim
            self.affinity_score = MergeLayer(2 * width, hidden_dim, out_dim,
                                             dropout, self.dtype)
        self.to_empty(device=device)
        if key is None:
            with torch.no_grad():
                for p in self.parameters():
                    p.fill_(float("nan"))
        else:
            self.reset_parameters(key)

    def draws(self) -> List[init.Draw]:
        """The JAX Net's `init(key)`: every submodule at its flax scope
        (pe_embedding, aggr, feature_embedding, affinity_score), so every
        route's parameters are the one tree flax makes."""
        return [d for name, m in self.named_children()
                for d in m.draws((name,))]

    def reset_parameters(self, key: prng.Key) -> None:
        init.reset(self.draws(), key)

    def fused_on(self, device: torch.device) -> bool:
        """Whether forward takes the fused route for tensors on `device`."""
        if self.fused_hidden is not None:
            return self.fused_hidden
        return torch.device(device).type == "cuda"

    def join_outputs(self, device: torch.device) -> dict:
        """The keyword arguments of `make_keys_join` that build what forward
        reads on `device`: the fused mean route reads only the merged-order
        planes, the fused attention and lstm routes the slot-aligned keys but
        not the unpacked feature pairs; the unfused routes the slot-aligned
        keys on CUDA (K7 forms the hidden rows from them) and the feature
        pairs on the CPU (the JAX package's XLA route). A join that cannot
        build key planes (impl="pallas", the general hi/lo layout) builds
        its feature pairs whatever these say, and forward reads those."""
        if not self.fused_on(device):
            return dict(aligned=True,
                        features=torch.device(device).type != "cuda")
        if self.aggrs in ("attn", "lstm"):
            return dict(aligned=True, features=False)
        return dict(aligned=False)

    def _u_ext(self) -> torch.Tensor:
        return key_u_ext(self.pe_embedding, self.key_layout)

    def forward(self, joined: JoinedBatch,
                feature: Optional[torch.Tensor] = None,
                key: Optional[prng.Key] = None,
                enc_table: Optional[torch.Tensor] = None,
                embed_mode: Optional[str] = None) -> torch.Tensor:
        """joined: JoinedBatch over [2, B, L] rows; feature: optional raw
        endpoint features [2, B, x_dim]; key: the apply's dropout key in
        training mode (flax's rngs={"dropout": key}); enc_table: the normalized encoding
        table [W+1, input_dim] an encoding-table join indexes; embed_mode:
        overrides the model's for this call. Returns logits [B] float32."""
        pe = self.pe_embedding
        cd = self.dtype

        def b2v(x):
            """pe's second bias once more: each valid slot carries two."""
            return pe.project(x.new_zeros(1, self.hidden_dim))

        fused = self.fused_on(joined.mask.device)
        table = joined.eidx is not None and not torch.is_floating_point(
            joined.eidx)
        if table:
            hsum = table_hsum(pe, joined.eidx, enc_table,
                              embed_mode or self.embed_mode)
        elif joined.eidx is not None and joined.eidx.dim() == 4:
            # a scalar join's value pairs [2, B, L, 2]: one input feature
            hsum = pe.hidden(joined.eidx[..., None]).sum(dim=-2)
        elif fused and joined.kown is not None:
            if self.key_layout is None:
                raise ValueError("the fused keys route needs key_layout")
            shift = int(self.key_layout[0]).bit_length()
            u_ext = self._u_ext()              # kernel compute stays fp32
            if self.aggrs in ("attn", "lstm"):
                if joined.kcross_al is None:
                    raise ValueError(f"the fused {self.aggrs} route needs "
                                     "the join's aligned keys (aligned=True)")
                # the per-slot hidden rows are never formed: the kernel
                # reads the keys, with the projection x = hsum @ W2 + 2 b2
                # folded in
                w2, bias2 = pe.project_raw()
                c2 = 2.0 * bias2.to(torch.float32)[None]
                if self.aggrs == "attn":
                    agg = self.aggr.folded_from_keys(
                        joined.kown, joined.kcross_al, joined.mask, u_ext,
                        shift, w2, c2, root_own=joined.kown_root,
                        root_cross=joined.kcross_al_root)
                else:
                    agg = self.aggr(None, joined.mask, fold=(w2, c2), keys=(
                        joined.kown, joined.kcross_al, joined.mask, u_ext,
                        shift, joined.kown_root, joined.kcross_al_root),
                        dtype=cd)
                return self._score(agg, feature, key)
            sums = fused_key_hidden_sum(
                joined.kown, joined.mask, joined.kcross, joined.kcross_mask,
                u_ext, shift, root_own=joined.kown_root,
                root_cross=joined.kcross_root)
            cnt = joined.mask.sum(dim=-1).clamp(min=1)          # [Q, B]
            mean = (sums / cnt[..., None].to(torch.float32)).to(cd)
            return self._score(pe.project(mean) + b2v(mean), feature,
                               key)
        elif joined.eidx is None and joined.kcross_al is not None:
            # the unfused routes over the aligned keys: the per-slot
            # hidden rows straight from the keys (K7, and K7 bwd in
            # training, on the card)
            if self.key_layout is None:
                raise ValueError("the keys hidden-rows route needs "
                                 "key_layout")
            hsum = fused_key_hidden_slots(
                joined.kown, joined.kcross_al, self._u_ext(),
                int(self.key_layout[0]).bit_length(), out_dtype=cd,
                root_own=joined.kown_root,
                root_cross=joined.kcross_al_root)            # [2, B, L, h]
        elif joined.eidx is None:
            raise ValueError("this route needs the join's aligned keys or "
                             "feature pairs (make_keys_join(..., "
                             "aligned=True))")
        else:
            # the unfused routes over feature pairs, and the fused ones
            # over a join without key planes
            hsum = pe.hidden(joined.eidx).sum(dim=-2)        # [2, B, L, h]
        if self.aggrs == "mean":
            mean = masked_mean(hsum, joined.mask)
            agg = pe.project(mean) + b2v(mean)
        elif fused:
            # the projection x = hsum @ W2 + 2 b2 folds past the attention
            # softmax, or into the LSTM's input weights
            w2, bias2 = pe.project_raw()
            c2 = 2.0 * bias2.to(torch.float32)[None]
            if self.aggrs == "attn":
                agg = self.aggr.folded(hsum, joined.mask, w2, c2)
            else:
                agg = self.aggr(hsum, joined.mask, fold=(w2, c2), fast=True)
        else:
            agg = self.aggr(pe.project(hsum) + b2v(hsum), joined.mask)
        return self._score(agg, feature, key)

    def _score(self, agg: torch.Tensor, feature: Optional[torch.Tensor],
               key: Optional[prng.Key]) -> torch.Tensor:
        """Endpoint concat + optional raw-feature branch + MergeLayer."""
        agg = agg.to(torch.float32)
        xl, xr = agg[0], agg[1]                              # [B, h]
        if self.use_feature:
            if feature is None:
                raise ValueError("use_feature=True requires features")
            femb = self.feature_embedding(feature).to(torch.float32)
            xl = torch.cat([xl, femb[0]], dim=-1)
            xr = torch.cat([xr, femb[1]], dim=-1)
        return self.affinity_score([xl, xr], key).squeeze(-1)
