"""Plain reference of the link-prediction model over sampled sets: the
join of two sets, the set encoder with the mean or attention aggregator,
the scorer, the weighted loss, global-norm clipping and Adam, in float32
PyTorch with TF32 off, computed in blocks of queries so that it fits.

Semantics (SUREL+'s LP set encoder, reference model.py): a query (u, v)
reads the sets S_u and S_v. A slot of S_u holds node x with its landing
encoding e_u(x) = [x is u, c_1 / M, ..., c_S' / M] and its partner's
e_v(x) (all zero where x is not in S_v); both go through the first
layer, relu(e W1^T + b1), and the slot's row is W2 (h_u + h_v) + 2 b2,
the two branches' second layer summed. The aggregator, found by its name in
`perfbench/reference/aggr/<name>.py` (`shapes`, `pool`), pools the rows
of the set's valid slots. The scorer concatenates both endpoints' embeddings and
takes relu(M0 z + m0), dropout, then M1 . + m1: the logit. Weights are
a dict keyed as the program's module names, Linear layouts [out, in].
"""

from __future__ import annotations

import contextlib
import importlib
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch.nn import functional as F

from perfbench.reference import draws
from perfbench.reference.sampler import key_layout

Weights = Dict[str, torch.Tensor]

# flax's scope path of the scorer's dropout in the program's model
DROPOUT_PATH = ("affinity_score", "Dropout_0", 1)


@contextlib.contextmanager
def full_fp32():
    """float32 matrix products without TF32, as the reference computes."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def encodings(khi: torch.Tensor, klo: torch.Tensor, num_walks: int,
              num_steps: int) -> torch.Tensor:
    """Packed keys (int32 bit patterns) -> float32 [..., S' + 1]."""
    shift, starts, lead = key_layout(num_walks, num_steps)
    key = ((khi.to(torch.int64) & 0xFFFFFFFF) << 32) | (
        klo.to(torch.int64) & 0xFFFFFFFF)
    cols = [((key >> lead) & 1).to(torch.float32)]
    for j in range(1, num_steps + 1):
        cols.append(((key >> starts[j]) & ((1 << shift) - 1)).to(
            torch.float32) / num_walks)
    return torch.stack(cols, dim=-1)


def join(a: Tuple[torch.Tensor, ...], b: Tuple[torch.Tensor, ...]
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """For rows a = (nodes, khi, klo, sizes) and partner rows b: a's mask
    [n, L], and the partner's key words (hi, lo) at each of a's slots,
    0 where b's set lacks the node."""
    an, ahi, alo, asz = a
    bn, bhi, blo, bsz = b
    width = an.shape[1]
    slot = torch.arange(width, device=an.device)
    mask = slot[None, :] < asz[:, None].to(torch.int64)
    pos = torch.searchsorted(bn.contiguous(), an.contiguous())
    posc = pos.clamp(max=width - 1)
    hit = (mask & (pos < bsz[:, None].to(torch.int64))
           & (bn.gather(1, posc) == an))
    zero = torch.zeros_like(alo)
    return (mask, torch.where(hit, bhi.gather(1, posc), zero),
            torch.where(hit, blo.gather(1, posc), zero))


def aggregator(name: str):
    """The aggregator's module, `perfbench/reference/aggr/<name>.py`."""
    if not name.isidentifier():
        raise ValueError(f"no aggregator {name!r}")
    return importlib.import_module(f"perfbench.reference.aggr.{name}")


def _linear(x, w: Weights, name: str):
    return F.linear(x, w[name + ".weight"], w[name + ".bias"])


def embed(rows_a, rows_b, w: Weights, aggr: str, num_walks: int,
          num_steps: int) -> torch.Tensor:
    """The set embedding [n, h] of each row of a, joined with b."""
    mask, chi, clo = join(rows_a, rows_b)
    e_own = encodings(rows_a[1], rows_a[2], num_walks, num_steps)
    e_cross = encodings(chi, clo, num_walks, num_steps)
    h = (torch.relu(_linear(e_own, w, "pe_embedding.fc0"))
         + torch.relu(_linear(e_cross, w, "pe_embedding.fc0")))
    x = (F.linear(h, w["pe_embedding.fc1.weight"])
         + 2.0 * w["pe_embedding.fc1.bias"])                 # [n, L, h]
    return aggregator(aggr).pool(x, mask, w)


def logits(rows_u, rows_v, w: Weights, aggr: str, num_walks: int,
           num_steps: int, keep: Optional[torch.Tensor] = None,
           rate: float = 0.0) -> torch.Tensor:
    """Logits [n] of the queries (u, v); `keep` [n, h] the dropout's kept
    entries (training), kept entries divided by 1 - rate."""
    z = torch.cat([embed(rows_u, rows_v, w, aggr, num_walks, num_steps),
                   embed(rows_v, rows_u, w, aggr, num_walks, num_steps)],
                  dim=-1)
    hid = torch.relu(_linear(z, w, "affinity_score.fc0"))
    if keep is not None:
        scale = torch.tensor(1.0 - rate, dtype=torch.float32,
                             device=hid.device)
        hid = torch.where(keep, hid / scale, 0.0)
    return _linear(hid, w, "affinity_score.fc1")[:, 0]


def blocks(n: int, width: int, hidden: int) -> Iterator[slice]:
    """Query blocks whose [2, b, width, hidden] planes take about 1 GB."""
    step = max(1, int(1e9 // (8 * width * hidden)))
    for lo in range(0, n, step):
        yield slice(lo, min(n, lo + step))


def dropout_keep(step_key: draws.Key, rate: float, shape, device
                 ) -> torch.Tensor:
    """The kept entries of the scorer's dropout under a step's key."""
    return draws.bernoulli(draws.fold_names(step_key, DROPOUT_PATH),
                           1.0 - rate, shape, device)


class Adam:
    """Adam (eps outside the square root) after clipping the gradients by
    their global norm (left as they are below `clip`)."""

    def __init__(self, w: Weights, lr: float, clip: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.clip, self.betas, self.eps = lr, clip, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in w.items()}
        self.v = {k: torch.zeros_like(v) for k, v in w.items()}
        self.t = 0

    def step(self, w: Weights, g: Weights) -> Weights:
        """The clipped gradients; `w` updated in place."""
        norm = torch.sqrt(sum((x * x).sum() for x in g.values()))
        if float(norm) >= self.clip:
            g = {k: x / norm * self.clip for k, x in g.items()}
        self.t += 1
        b1, b2 = self.betas
        for k in w:
            self.m[k] = b1 * self.m[k] + (1 - b1) * g[k]
            self.v[k] = b2 * self.v[k] + (1 - b2) * g[k] * g[k]
            mhat = self.m[k] / (1 - b1 ** self.t)
            vhat = self.v[k] / (1 - b2 ** self.t)
            w[k] -= self.lr * mhat / (torch.sqrt(vhat) + self.eps)
        return g


def train_step(rows_of, edges: torch.Tensor, labels: torch.Tensor,
               weights: torch.Tensor, w: Weights, opt: Adam, aggr: str,
               num_walks: int, num_steps: int, keep: torch.Tensor,
               rate: float) -> Tuple[float, Weights]:
    """One step over the batch `edges` [2, B] whose rows weigh `weights`
    [B] (0 or 1): the BCE loss summed with those weights over the larger
    of their sum and 1, the clipped gradients, and `w` updated.
    `rows_of(ids)` gives the set rows (nodes, khi, klo, sizes) of node
    ids."""
    width = rows_of(edges[0, :1])[0].shape[1]
    hidden = w["pe_embedding.fc0.weight"].shape[0]
    params = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    n = edges.shape[1]
    denom = max(float(weights.sum()), 1.0)
    total = 0.0
    for sl in blocks(n, width, hidden):
        lg = logits(rows_of(edges[0, sl]), rows_of(edges[1, sl]), params,
                    aggr, num_walks, num_steps, keep[sl], rate)
        loss = (F.binary_cross_entropy_with_logits(
            lg, labels[sl], reduction="none") * weights[sl]).sum() / denom
        loss.backward()
        total += float(loss.detach())
    grads = {k: p.grad.detach() for k, p in params.items()}
    return total, opt.step(w, grads)


@torch.no_grad()
def scores(rows_of, edges: torch.Tensor, w: Weights, aggr: str,
           num_walks: int, num_steps: int) -> torch.Tensor:
    """sigmoid of the logits of the queries `edges` [2, n], no dropout."""
    width = rows_of(edges[0, :1])[0].shape[1]
    hidden = w["pe_embedding.fc0.weight"].shape[0]
    out: List[torch.Tensor] = []
    for sl in blocks(edges.shape[1], width, hidden):
        out.append(torch.sigmoid(logits(
            rows_of(edges[0, sl]), rows_of(edges[1, sl]), w, aggr,
            num_walks, num_steps)))
    return torch.cat(out)

