"""Higher-order pattern model (port of surel_plus_tpu/models/honet.py:HONet,
the reference's model_horder.py:42-66).

Scores 3-node queries (u, v, w) from the four endpoint groups of a
hyperedge join (u|w, w|u, v|w, w|v; `make_keys_hjoin`, `hgather_join`):
the hidden layer over each slot's encoding pair, the pair sum, each
group's mean, the projection (the mean is taken before the linear
projection, as in `Net`), then a MergeLayer over the four groups.
float32 throughout, as the JAX module. The reference's unused LayerNorm
(`concat_norm`) is left out, as in the JAX package.

Three routes compute the same logits:

* fused, over a keys join with key planes (lo-only and lead-in-hi
  layouts): the four groups' set sums come from the packed keys without
  a per-slot hidden row (`group_set_sums`: K1, `csrc/hidden_sum.cu`, and
  K1 bwd under autograd on the card, two launches each over the cross
  plane's halves; their plain versions on the CPU);
* unfused, over a keys join's feature pairs [4, B, L, 2, ncol] (the
  general hi/lo layout always takes it);
* table, over an encoding-table join's index pairs [4, B, L, 2] with the
  table given to forward (`table_hsum`).

`fused_hidden=None` picks the fused route on CUDA and the unfused one on
the CPU; `join_outputs` says whether the keys join must build the feature
pairs (eager PyTorch does no dead-code elimination).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from surel_plus_tpu_torch.models import init
from surel_plus_tpu_torch.models.layers import MergeLayer, MLP2, masked_mean
from surel_plus_tpu_torch.models.net import key_u_ext, table_hsum
from surel_plus_tpu_torch.ops import prng
from surel_plus_tpu_torch.ops.join import JoinedBatch
from surel_plus_tpu_torch.ops.kernels.hidden_sum import fused_key_hidden_sum

def group_set_sums(joined: JoinedBatch, u_ext: torch.Tensor,
                   shift: int) -> torch.Tensor:
    """The four groups' masked sums [4, B, H] fp32 of the hidden
    activations of their own and their partner's keys, from a hyperedge
    keys join's planes; differentiable in u_ext.

    Two Q=2 launches of K1 (and of K1 bwd under autograd): groups 0-1 over
    the first half of the [B, 4L] cross plane, 2-3 over the second, the
    halves read in place as row-strided views. The sums do not depend on
    the order, so one Q=4 launch over the whole plane gives the same
    values; the halves are the route because K1 and K1 bwd take less
    device time on them (queued on an H100: 0.9282 against 1.2324 ms at
    L=301, 1.5331 against 1.5505 at L=801; K1's Q=4 instance spills). The
    fits of the two forms differed by less than their spread (PERF.md §6).
    JAX also takes the halves (honet.py:56-88), and splits slot ranges
    further (`set_sum_splits`) to fit the TPU's scoped VMEM; that memory
    model has no counterpart here."""
    half = joined.kcross.shape[-1] // 2
    rc = joined.kcross_root
    parts = []
    for g, c in ((slice(0, 2), slice(0, half)),
                 (slice(2, 4), slice(half, 2 * half))):
        parts.append(fused_key_hidden_sum(
            joined.kown[g], joined.mask[g], joined.kcross[:, c],
            joined.kcross_mask[g, :, c], u_ext, shift,
            root_own=None if rc is None else joined.kown_root[g],
            root_cross=None if rc is None else rc[:, c]))
    return torch.cat(parts)


class HONet(nn.Module):
    """Scores hyperedge queries from a hyperedge join; returns logits [B].

    input_dim: encoding columns (num_steps + 1). The weights are flax's
    `init(key)` of the JAX HONet, drawn on `device` (`key` None: NaN
    parameters, undrawn, as for Net). key_layout:
    (num_walks, num_steps) of the packed keys, needed by the fused route
    (trainer_from_keys fills it in)."""

    def __init__(self, input_dim: int, hidden_dim: int = 96,
                 out_dim: int = 1, dropout: float = 0.1,
                 fused_hidden: Optional[bool] = None,
                 key_layout: Optional[Tuple[int, int]] = None,
                 *, key: Optional[prng.Key], device="cuda"):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.fused_hidden = fused_hidden
        self.key_layout = key_layout
        with torch.device("meta"):          # storage comes with `device`
            self.pe_embedding = MLP2(input_dim, hidden_dim, hidden_dim)
            self.affinity_score = MergeLayer(4 * hidden_dim, hidden_dim,
                                             out_dim, dropout)
        self.to_empty(device=device)
        if key is None:
            with torch.no_grad():
                for p in self.parameters():
                    p.fill_(float("nan"))
        else:
            self.reset_parameters(key)

    def draws(self) -> List[init.Draw]:
        """The JAX HONet's `init(key)` (pe_embedding, affinity_score)."""
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
        """The keyword arguments of `make_keys_hjoin` that build what forward
        reads on `device`: the fused route reads the key planes only."""
        return dict(features=not self.fused_on(device))

    def _u_ext(self) -> torch.Tensor:
        return key_u_ext(self.pe_embedding, self.key_layout)

    def forward(self, joined: JoinedBatch,
                feature: Optional[torch.Tensor] = None,
                key: Optional[prng.Key] = None,
                enc_table: Optional[torch.Tensor] = None,
                embed_mode: str = "table") -> torch.Tensor:
        """joined: a hyperedge JoinedBatch ([4, B, L] groups); key: the
        apply's dropout key in training mode (flax's rngs={"dropout":
        key}); enc_table: the
        normalized encoding table [W+1, input_dim] that an encoding-table
        join indexes, embed_mode how its hidden rows are formed (the same
        values either way). HONet reads no raw node features."""
        if feature is not None:
            raise ValueError("HONet takes no raw node features")
        pe = self.pe_embedding
        table = joined.eidx is not None and not torch.is_floating_point(
            joined.eidx)
        if table:
            hsum = table_hsum(pe, joined.eidx, enc_table, embed_mode)
            mean = masked_mean(hsum, joined.mask)
        elif self.fused_on(joined.mask.device) and joined.kown is not None:
            if self.key_layout is None:
                raise ValueError("the fused route needs key_layout")
            sums = group_set_sums(joined, self._u_ext(),
                                  int(self.key_layout[0]).bit_length())
            cnt = joined.mask.sum(dim=-1).clamp(min=1)           # [4, B]
            mean = sums / cnt[..., None].to(torch.float32)
        elif joined.eidx is None:
            raise ValueError("this route needs the join's feature pairs "
                             "(make_keys_hjoin(..., features=True))")
        else:
            # feature pairs [4, B, L, 2, ncol]
            mean = masked_mean(pe.hidden(joined.eidx).sum(dim=-2),
                               joined.mask)
        # each valid slot carries two second-layer biases
        agg = pe.project(mean) + pe.project(mean.new_zeros(
            1, self.hidden_dim))                                 # [4, B, h]
        score = self.affinity_score([agg[0], agg[1], agg[2], agg[3]], key)
        return score.squeeze(-1)
