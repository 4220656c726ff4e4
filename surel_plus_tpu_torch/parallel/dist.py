"""Multi-device training and scoring over torch.distributed: data-parallel
batches x a row-sharded set store (port of surel_plus_tpu/parallel/
dist.py).

The mesh is (data, graph) (`parallel/mesh.py`):

* 'data': query batches sharded by contiguous column blocks; gradients
  and the loss averaged over it (classic data parallelism).
* 'graph': the set store's rows sharded by contiguous ranges; each rank
  keeps rows [g*rps, (g+1)*rps) on its device. A batch gather of any
  rows is an owner-masked local gather and a sum over 'graph'
  (`dist_gather_rows`; exactly one owner a row and zeros elsewhere, so
  the sum of the int32 bit patterns, keys included, is exact), or an
  all-to-all of the requests' answers (`dist_gather_rows_a2a`).
* The parameters and the Adam state are replicated: every rank applies
  the same averaged gradients to its own copy, so the copies stay equal.

The steps and the scorer run the single-device modules on the gathered
rows: the keys joins (`join_gathered_keys`, `join_gathered_hkeys`, K2's
merge on the card), then `Net` or `HONet` on this rank's column block
(their fused routes run K1 and K1 bwd, K3 and K3 bwd, or K4 and K4 bwd
on the card), the weighted BCE (`batch_loss`), the backward, the data
axis' mean, `clip_by_global_norm_` and Adam (train/device.py). Where JAX
scans the scorer's batches inside one program, the scorer here is a
Python loop over the rank's column block and an all_gather over 'data'.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Optional, Union

import numpy as np
import torch

from surel_plus_tpu_torch.ops import prng
from surel_plus_tpu_torch.ops import walk as walk_ops
from surel_plus_tpu_torch.ops.join import (
    JoinedBatch,
    _cross_lookup_bidir_multi,
    join_gathered_hkeys,
    join_gathered_keys,
)
from surel_plus_tpu_torch.ops.sampler import (
    device_graph,
    walk_tables_for,
)
from surel_plus_tpu_torch.ops.walk import INT32_MAX
from surel_plus_tpu_torch.parallel.mesh import Axis, Mesh, make_mesh
from surel_plus_tpu_torch.spg.spg import SpG, SpGKeys
from surel_plus_tpu_torch.train.device import (
    batch_loss,
    clip_by_global_norm_,
    device_auc,
    device_hits_at_k,
    device_mrr,
)

__all__ = [
    "DistributedKeysHTrainStep", "DistributedKeysScorer",
    "DistributedKeysTrainStep", "DistributedTrainStep", "LocalSpGKeys",
    "ShardedSpG", "ShardedSpGKeys", "dist_gather_rows",
    "dist_gather_rows_a2a", "evaluate_distributed", "make_mesh",
    "sample_gsets_sharded", "shard_spg", "shard_spg_keys",
]


def _pad_rows(arr: torch.Tensor, rows: int) -> torch.Tensor:
    """`arr` with zero rows appended up to `rows`."""
    if arr.shape[0] == rows:
        return arr
    pad = arr.new_zeros((rows - arr.shape[0],) + tuple(arr.shape[1:]))
    return torch.cat([arr, pad])


def _column_block(x, mesh: Mesh, device) -> torch.Tensor:
    """This data rank's contiguous block of the last dimension of `x`
    (numpy or tensor; JAX's P(None, "data") / P("data")), on `device`."""
    x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
    dp, d = mesh.shape["data"], mesh.data_index
    n = x.shape[-1]
    if n % dp:
        raise ValueError(f"{n} columns do not split over {dp} data ranks")
    per = n // dp
    return x[..., d * per:(d + 1) * per].to(device).contiguous()


# ---------------------------------------------------------------- row stores
@dataclasses.dataclass
class ShardedSpG:
    """An encoding-table store padded to a multiple of the graph axis and
    sharded by rows: this rank's rows [g*rps, (g+1)*rps) on its device,
    the normalized encoding table replicated."""

    nodes: torch.Tensor   # int32 [rps, L]
    eidx: torch.Tensor    # int32 [rps, L]
    sizes: torch.Tensor   # int32 [rps]
    enc: torch.Tensor     # float32 [U+1, ncol], every rank
    rows_per_shard: int
    num_rows: int


def shard_spg(spg: SpG, mesh: Mesh) -> ShardedSpG:
    """This rank's rows of a host SpG (zero rows pad the last shard)."""
    gp, g = mesh.shape["graph"], mesh.graph_index
    rps = -(-spg.num_rows // gp)
    dev = mesh.device

    def rows(a):
        t = torch.as_tensor(np.ascontiguousarray(a[g * rps:(g + 1) * rps]))
        return _pad_rows(t, rps).to(dev)

    return ShardedSpG(nodes=rows(spg.nodes), eidx=rows(spg.eidx),
                      sizes=rows(spg.sizes),
                      enc=torch.as_tensor(spg.enc_normalized()).to(dev),
                      rows_per_shard=rps, num_rows=spg.num_rows)


@dataclasses.dataclass
class LocalSpGKeys:
    """A world-sharded sampler's output on one rank: `sets` holds rows
    [start, start + len) of a store of `num_rows` rows (world rank r's
    seed block, per = ceil(num_rows / world) seeds a rank)."""

    sets: SpGKeys
    start: int
    num_rows: int


@dataclasses.dataclass
class ShardedSpGKeys:
    """A packed-key store padded to a multiple of the graph axis and
    sharded by rows: this rank's rows [g*rps, (g+1)*rps) on its device
    (the production multi-device layout: no table to replicate, the join
    unpacks features on the fly). The four arrays lie side by side in one
    int32 tensor `rows` [rps, 3L + 1] (nodes, hi, lo, size), so a batch's
    rows come back in one gather and one sum over 'graph'; `nodes`,
    `khi`, `klo` and `sizes` are views of it."""

    rows: torch.Tensor
    rows_per_shard: int
    num_rows: int
    num_walks: int
    num_steps: int

    @property
    def width(self) -> int:
        return (self.rows.shape[1] - 1) // 3

    @property
    def nodes(self) -> torch.Tensor:
        return self.rows[:, :self.width]

    @property
    def khi(self) -> torch.Tensor:
        return self.rows[:, self.width:2 * self.width]

    @property
    def klo(self) -> torch.Tensor:
        return self.rows[:, 2 * self.width:3 * self.width]

    @property
    def sizes(self) -> torch.Tensor:
        return self.rows[:, 3 * self.width]


def _pack_rows(s: SpGKeys) -> torch.Tensor:
    """A store's rows as one int32 tensor [n, 3L + 1] (nodes, hi, lo,
    size), so one exchange moves all four."""
    return torch.cat([s.nodes, s.khi, s.klo, s.sizes[:, None]], dim=1)


def _exchange_to_owners(local: LocalSpGKeys, mesh: Mesh, rps: int
                        ) -> torch.Tensor:
    """Move a world-sharded store's rows to their graph shards with one
    all_to_all over uneven splits: rank (d, g) receives rows
    [g*rps, (g+1)*rps) of every source whose block meets them, in source
    order. Every rank computes every split from (num_rows, per, rps), so
    no rank gathers the whole store. Returns the packed rows [<= rps, .]."""
    world = mesh.axis("world")
    n, w, gp = local.num_rows, world.size, mesh.shape["graph"]
    per = -(-n // w)

    def overlap(src: int, dst: int) -> int:
        g = dst % gp
        lo = max(src * per, g * rps)
        hi = min((src + 1) * per, (g + 1) * rps, n)
        return max(hi - lo, 0)

    me = mesh.rank
    packed = _pack_rows(local.sets)
    send = [overlap(me, dst) for dst in range(w)]
    recv = [overlap(src, me) for src in range(w)]
    # the rows for rank dst are its shard's slice of this block, in order
    parts = []
    for dst in range(w):
        if send[dst]:
            lo = max(me * per, (dst % gp) * rps) - local.start
            parts.append(packed[lo:lo + send[dst]])
    out = packed[:0] if not parts else torch.cat(parts)
    return world.all_to_all_v(out, send, recv)


def shard_spg_keys(spgk: Union[SpGKeys, LocalSpGKeys],
                   mesh: Mesh) -> ShardedSpGKeys:
    """This rank's rows of a packed-key store: sliced from a whole SpGKeys,
    or moved from a world-sharded sampler's output (`LocalSpGKeys`) by
    `_exchange_to_owners`. Zero rows pad the last shard, as JAX pads."""
    gp, g = mesh.shape["graph"], mesh.graph_index
    dev = mesh.device
    if isinstance(spgk, LocalSpGKeys):
        n, layout = spgk.num_rows, spgk.sets
        rps = -(-n // gp)
        packed = _pad_rows(_exchange_to_owners(spgk, mesh, rps), rps)
    else:
        n, layout = spgk.nodes.shape[0], spgk
        rps = -(-n // gp)
        packed = _pad_rows(_pack_rows(spgk)[g * rps:(g + 1) * rps], rps)
    return ShardedSpGKeys(
        rows=packed.to(dev).contiguous(), rows_per_shard=rps, num_rows=n,
        num_walks=layout.num_walks, num_steps=layout.num_steps)


# --------------------------------------------------------------- row gathers
def _owned_rows(local: torch.Tensor, row_ids: torch.Tensor, shard: int,
                rows_per_shard: int) -> torch.Tensor:
    """local[row_ids - shard * rps] where this shard owns the row, else
    zeros."""
    lid = row_ids.to(torch.int64) - shard * rows_per_shard
    owned = (lid >= 0) & (lid < rows_per_shard)
    got = local[lid.clamp(0, rows_per_shard - 1)]
    mask = owned.reshape(owned.shape + (1,) * (got.dim() - owned.dim()))
    return torch.where(mask, got, torch.zeros_like(got))


def dist_gather_rows(local: torch.Tensor, row_ids: torch.Tensor,
                     rows_per_shard: int, axis: Axis) -> torch.Tensor:
    """Global rows `row_ids` of an array row-sharded over `axis`: each
    rank zeroes the rows it does not own and a sum over the axis rebuilds
    every row (one owner a row). Simple and latency-optimal for small
    axes; `dist_gather_rows_a2a` moves fewer bytes on larger ones."""
    return axis.psum(_owned_rows(local, row_ids, axis.index,
                                 rows_per_shard))


def dist_gather_rows_a2a(local: torch.Tensor, row_ids: torch.Tensor,
                         rows_per_shard: int, axis: Axis) -> torch.Tensor:
    """All-to-all row gather: every rank sends its whole id list to every
    peer (ids are 4 bytes against rows of hundreds), each peer answers
    with its owner-masked rows, one all_to_all returns the answers and
    their sum over peers is the rows (one owner a row). Each gathered row
    crosses the interconnect once."""
    flat = row_ids.reshape(-1)
    all_reqs = axis.all_gather(flat)                       # [G, R]
    answers = _owned_rows(local, all_reqs, axis.index, rows_per_shard)
    rows = axis.all_to_all(answers).sum(dim=0, dtype=local.dtype)
    return rows.reshape(tuple(row_ids.shape) + tuple(local.shape[1:]))


def _gather_keys_rows(sspg: ShardedSpGKeys, edges: torch.Tensor,
                      axis: Axis):
    """The endpoints' rows [Q, B, L] of a sharded keys store (nodes, hi,
    lo, and sizes [Q, B]: one gather of the packed rows), with the
    INT32_MAX padding past each set's size restored (the owner's sum
    carries it, but the sentinel is rebuilt from the sizes as JAX does)."""
    ell = sspg.width
    got = dist_gather_rows(sspg.rows, edges, sspg.rows_per_shard, axis)
    rn, rh, rl = (got[..., i * ell:(i + 1) * ell].contiguous()
                  for i in range(3))
    rs = got[..., 3 * ell].contiguous()
    slot = torch.arange(ell, device=rn.device)
    valid = slot[None, None, :] < rs[..., None]
    rn = torch.where(valid, rn, torch.full_like(rn, INT32_MAX))
    return rn, rh, rl, rs


# -------------------------------------------------------------------- steps
def _apply_mean_update(model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer, loss: torch.Tensor,
                       data: Axis, grad_clip: Optional[float]) -> None:
    """The backward of this rank's loss, the gradients' mean over the data
    axis (one all_reduce over all of them flattened), the global-norm clip
    and the optimizer's step: every rank applies the same update."""
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    params = [p for p in model.parameters() if p.requires_grad]
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in params]
    flat = data.pmean(torch.cat([g.reshape(-1) for g in grads]))
    off = 0
    for p, g in zip(params, grads):
        p.grad = flat[off:off + g.numel()].view_as(g)
        off += g.numel()
    if grad_clip is not None:
        clip_by_global_norm_([p.grad for p in params], grad_clip)
    optimizer.step()


class _Step:
    """A distributed train step: this rank's column block of the batch,
    the model's logits on it (`_logits`, the subclass's gathers and
    join), the weighted BCE, the data axis' mean of the gradients, clip,
    Adam. The dropout masks come from the step's `key` (JAX's `rng`
    argument, the same on every rank), drawn over this rank's column
    block, as JAX's replicated key draws them inside its shard_map."""

    def __init__(self, model, optimizer, mesh: Mesh,
                 grad_clip: Optional[float]):
        self.model = model
        self.optimizer = optimizer
        self.mesh = mesh
        self.grad_clip = grad_clip

    def _logits(self, edges: torch.Tensor,
                key: Optional[prng.Key]) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, edges, labels, weights,
                 key: Optional[prng.Key] = None) -> torch.Tensor:
        """One step on [Q, B] global query row ids with labels and
        weights [B] (B a multiple of the data axis; each data rank takes
        its contiguous column block) and the dropout `key` (needed when
        the model drops out). Returns the loss averaged over the data
        axis, a device scalar (no host sync)."""
        mesh, dev = self.mesh, self.mesh.device
        be = _column_block(edges, mesh, dev).to(torch.int64)
        bl = _column_block(labels, mesh, dev).to(torch.float32)
        bw = _column_block(weights, mesh, dev).to(torch.float32)
        self.model.train()
        loss = batch_loss(self._logits(be, key), bl, bw)
        _apply_mean_update(self.model, self.optimizer, loss,
                           mesh.axis("data"), self.grad_clip)
        return mesh.axis("data").pmean(loss.detach().clone())


class _KeysStep(_Step):
    """The link and hyperedge keys steps: the batch's rows gathered over
    'graph', joined by `join`."""

    def __init__(self, model, optimizer, mesh: Mesh, sspg: ShardedSpGKeys,
                 join: Callable, grad_clip: Optional[float]):
        super().__init__(model, optimizer, mesh, grad_clip)
        self.sspg = sspg
        self._join = functools.partial(
            join, num_walks=sspg.num_walks, num_steps=sspg.num_steps,
            **model.join_outputs(mesh.device))

    def _logits(self, edges: torch.Tensor,
                key: Optional[prng.Key]) -> torch.Tensor:
        rows = _gather_keys_rows(self.sspg, edges, self.mesh.axis("graph"))
        return self.model(self._join(*rows), None, key=key)


class DistributedKeysTrainStep(_KeysStep):
    """(data x graph)-sharded train step of a `Net` over a row-sharded
    packed-key store: the query rows rebuilt by owner-masked sums over
    'graph', joined locally (`join_gathered_keys`: the merge join and the
    key planes the model's route reads), batches data-parallel, gradients
    averaged over 'data'. `optimizer` is the model's Adam
    (`train.device.new_optimizer`); `grad_clip` clips by global norm
    before it (None: no clip), as optax.chain(clip_by_global_norm,
    adam)."""

    def __init__(self, model, optimizer, mesh: Mesh, sspg: ShardedSpGKeys,
                 grad_clip: Optional[float] = None):
        super().__init__(model, optimizer, mesh, sspg, join_gathered_keys,
                         grad_clip)


class DistributedKeysHTrainStep(_KeysStep):
    """The hyperedge (3-endpoint) variant: the same row gathers feed
    `join_gathered_hkeys` (the groups u|w, w|u, v|w, w|v) and a `HONet`;
    edges are [3, B]."""

    def __init__(self, model, optimizer, mesh: Mesh, sspg: ShardedSpGKeys,
                 grad_clip: Optional[float] = None):
        super().__init__(model, optimizer, mesh, sspg, join_gathered_hkeys,
                         grad_clip)


class DistributedKeysScorer:
    """(data x graph)-sharded inference over a row-sharded packed-key
    store, the eval mirror of DistributedKeysTrainStep: query rows rebuilt
    over 'graph', joined locally, scored data-parallel; the scores come
    back replicated in global column order.

    join_gathered: (rows_nodes, rows_hi, rows_lo, rows_sizes, num_walks,
    num_steps, **model.join_outputs(device)) -> JoinedBatch over the
    gathered rows; by default the link join `join_gathered_keys`. Pass
    `join_gathered_hkeys` with a HONet to score hyperedges."""

    def __init__(self, model, mesh: Mesh, sspg: ShardedSpGKeys,
                 batch_size: int = 4096,
                 join_gathered: Optional[Callable] = None):
        self.model = model
        self.mesh = mesh
        self.sspg = sspg
        dp = mesh.shape["data"]
        self.batch_size = -(-batch_size // dp) * dp
        self._join = functools.partial(
            join_gathered or join_gathered_keys,
            num_walks=sspg.num_walks, num_steps=sspg.num_steps,
            **model.join_outputs(mesh.device))

    @torch.no_grad()
    def __call__(self, edges) -> torch.Tensor:
        """Scores [E] (sigmoid, float32, on this rank's device, the same
        on every rank) of [Q, E] query row ids, E padded with zero ids to
        whole batches. Each data rank scores its contiguous column block
        batch by batch, then one all_gather over 'data' puts the blocks
        in order (shard-major is ascending global column)."""
        mesh, dev = self.mesh, self.mesh.device
        edges = torch.as_tensor(
            np.asarray(edges) if not torch.is_tensor(edges) else edges
        ).to(torch.int64)
        E = edges.shape[1]
        bs = self.batch_size
        pad = (-E) % bs
        if pad:
            edges = torch.cat([edges, edges.new_zeros(edges.shape[0], pad)],
                              dim=1)
        block = _column_block(edges, mesh, dev)
        bsl = bs // mesh.shape["data"]
        self.model.eval()
        out = []
        for i in range(0, block.shape[1], bsl):
            rows = _gather_keys_rows(self.sspg, block[:, i:i + bsl],
                                     mesh.axis("graph"))
            out.append(torch.sigmoid(self.model(self._join(*rows))))
        scores = torch.cat(out).to(torch.float32)
        return mesh.axis("data").all_gather(scores).reshape(-1)[:E]


def evaluate_distributed(scorer: DistributedKeysScorer, inf_edge,
                         metric: str):
    """`train.device.evaluate_device` over a sharded scorer: the same
    results (reference train.py:175-280) from the replicated score
    vectors. inf_edge[split] = (pos_edge [Q, Ep], neg_edge [Q, En]).
    Returns (results, seconds of the test split)."""

    def split_scores(split):
        pos_edge, neg_edge = inf_edge[split]
        return scorer(pos_edge), scorer(neg_edge)

    pos_v, neg_v = split_scores("valid")
    t0 = time.time()
    pos_t, neg_t = split_scores("test")

    if "Hits" in metric:
        results = {}
        for k in (10, 20, 50, 100):
            results[f"Hits@{k}"] = (
                0,
                float(device_hits_at_k(pos_v, neg_v, k)),
                float(device_hits_at_k(pos_t, neg_t, k)),
            )
        return results, time.time() - t0
    if "AUC" in metric:
        def auc(pos, neg):
            labels = torch.cat([torch.ones_like(pos), torch.zeros_like(neg)])
            return float(device_auc(labels, torch.cat([pos, neg])))
        return (0, auc(pos_v, neg_v), auc(pos_t, neg_t)), time.time() - t0

    def mrr(pos, neg):
        k = neg.shape[0] // max(pos.shape[0], 1)
        return float(device_mrr(pos, neg[:pos.shape[0] * k].reshape(-1, k)))
    return (0, mrr(pos_v, neg_v), mrr(pos_t, neg_t)), time.time() - t0


class DistributedTrainStep(_Step):
    """(data x graph)-sharded train step of a `Net` over a row-sharded
    encoding-table store (`ShardedSpG`): the rows of nodes, table indices
    and sizes rebuilt over 'graph', joined by `_join_rows` (one merge of
    the two rows, K2 on the card, as `gather_join`), the model fed the
    replicated table. Called as the keys step, with [2, B] row ids."""

    def __init__(self, model, optimizer, mesh: Mesh, sspg: ShardedSpG,
                 grad_clip: Optional[float] = None):
        super().__init__(model, optimizer, mesh, grad_clip)
        self.sspg = sspg

    @staticmethod
    def _join_rows(rows_nodes, rows_eidx, rows_sizes) -> JoinedBatch:
        """The table join over gathered [2, B, L] rows: the padding
        sentinel rebuilt from the sizes, then both directions' partner
        indices from one merge (JAX's `_join_rows`: the same values)."""
        slot = torch.arange(rows_nodes.shape[-1], device=rows_nodes.device)
        valid = slot[None, None, :] < rows_sizes[..., None]
        rows_nodes = torch.where(valid, rows_nodes,
                                 torch.full_like(rows_nodes, INT32_MAX))
        eu = torch.where(valid[0], rows_eidx[0], 0)
        ev = torch.where(valid[1], rows_eidx[1], 0)
        (cross_u,), (cross_v,) = _cross_lookup_bidir_multi(
            rows_nodes[0], rows_nodes[1], (eu,), (ev,), aligned=True)
        eidx = torch.stack([torch.stack([eu, cross_u], dim=-1),
                            torch.stack([ev, cross_v], dim=-1)])
        return JoinedBatch(eidx=eidx, mask=valid, sizes=rows_sizes)

    def _logits(self, edges: torch.Tensor,
                key: Optional[prng.Key]) -> torch.Tensor:
        sspg, graph = self.sspg, self.mesh.axis("graph")
        rps = sspg.rows_per_shard
        joined = self._join_rows(
            dist_gather_rows(sspg.nodes, edges, rps, graph),
            dist_gather_rows(sspg.eidx, edges, rps, graph),
            dist_gather_rows(sspg.sizes, edges, rps, graph))
        return self.model(joined, None, key=key, enc_table=sspg.enc)


# ----------------------------------------------------------------- sampling
def sample_gsets_sharded(graph, seeds: np.ndarray, num_walks: int,
                         num_steps: int, mesh: Mesh, seed: int = 111413,
                         bucket: Optional[int] = None) -> LocalSpGKeys:
    """Seed-parallel sampling: seeds sharded over the world (rank r walks
    seeds [r*per, (r+1)*per), the last block padded with seed 0), the CSR
    replicated: `walk.sample_block` over the rank's seed block with the
    key `fold_in(prng_key(seed), rank)` and the shared native shuffle of
    `seed`, the JAX package's `sample_gsets_sharded` rank for rank.
    Returns the rank's rows below len(seeds) (`shard_spg_keys` takes
    them)."""
    dev, rank = mesh.device, mesh.rank
    seeds = np.asarray(seeds, dtype=np.int32)
    n = len(seeds)
    if bucket is None:
        bucket = num_walks * num_steps + 1
    per = -(-n // mesh.world_size)
    block = np.zeros(per, np.int32)
    mine = seeds[rank * per:(rank + 1) * per]
    block[:len(mine)] = mine
    indptr, _ = device_graph(graph, dev)
    etab, stab = walk_tables_for(graph, seed, dev)
    nodes, sizes, hi, lo = walk_ops.sample_block(
        indptr, etab, stab, torch.as_tensor(block).to(dev),
        num_walks=num_walks, num_steps=num_steps, bucket=bucket,
        key=prng.fold_in(prng.prng_key(seed), rank))
    keep = len(mine)
    return LocalSpGKeys(
        sets=SpGKeys(nodes=nodes[:keep], khi=hi[:keep], klo=lo[:keep],
                     sizes=sizes[:keep], num_walks=num_walks,
                     num_steps=num_steps),
        start=rank * per, num_rows=n)
