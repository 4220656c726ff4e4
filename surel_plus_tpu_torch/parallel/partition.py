"""Edge-partitioned graphs and frontier-exchange sampling over
torch.distributed (port of surel_plus_tpu/parallel/partition.py).

* The CSR is partitioned by contiguous node ranges: shard g owns rows
  [g*rps, (g+1)*rps). Rank g holds only its shard (indptr rebased to the
  shard's start, indices and shuffled indices padded to the largest
  shard's edge count), so graph memory divides by the shard count.
* Walks cross shards through an owner-computed frontier exchange, with
  two transports that give the same walks:
    - `_probe_step` (default): every rank sees every request
      (all_gather), answers those it owns, and one all_to_all returns
      the answers; the sum over owners (one a node) is the answer.
    - `_route_step`: capacity-routed: requests sorted by owner into a
      [G, C] buffer (C = ceil(slack * R / G)), one all_to_all each way.
      When a destination overflows C on any rank (a world-wide vote,
      read on the host), the whole step takes the probe instead.
  The walk state stays on the seed's rank; only int32 ids, uint32 draws
  (as int32 bits) and answers cross.
* The random bits of the steps after the first hop are the JAX
  package's: step t's are `bits(split(prng_key(seed), S' - 1)[t],
  [n_pad, M])`, and rank r draws only its rows [r*per, (r+1)*per) of
  that draw, through the counter offset (`walk.walk_bits(..., row0)`).
  So the sets equal `walk.sample_block` over the whole padded seed block
  with the key `prng_key(seed)`, and JAX's partitioned sets, whatever
  the shard count. The first hop
  reads the native per-row shuffle (`shuffled_indices_for`), the JAX
  package's. Every sampler also takes given `bits` [S' - 1, n_pad, M]
  (values in [0, 2^32)), so that a test can feed it JAX's.
* Set building (dedup, landing counts, key packing) is local to each seed
  (`walk.build_sets_packed_block`).

For graphs that fit one device, the seed-parallel replicated sampler
(`dist.sample_gsets_sharded`) needs no communication; this is the
capacity path. `sample_gsets_grouped` partitions the graph over groups of
`group_size` ranks and splits the seeds over the groups.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from surel_plus_tpu_torch.graph.csr import CSRGraph
from surel_plus_tpu_torch.ops import prng
from surel_plus_tpu_torch.ops import walk as walk_ops
from surel_plus_tpu_torch.parallel.dist import LocalSpGKeys
from surel_plus_tpu_torch.parallel.mesh import (
    Axis,
    Mesh,
    check_backend,
    default_backend,
    rank_device,
)
from surel_plus_tpu_torch.spg.spg import SpGKeys

log = logging.getLogger(__name__)

# the process group's timeout: a collective that waits longer raises
GROUP_TIMEOUT_S = 120


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int, backend: Optional[str] = None,
                     device="cuda") -> torch.device:
    """Join process `process_id` of `num_processes` (one rank a process,
    all on this host) to the group at `coordinator_address` ("host:port";
    the rendezvous is tcp://). The backend defaults to NCCL on the card
    and gloo on the CPU; NCCL for more processes than cards raises
    ValueError first. Returns the rank's device."""
    backend = backend or default_backend(device)
    check_backend(backend, device, num_processes)
    dev = rank_device(device, process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    addr = coordinator_address
    if "://" not in addr:
        addr = f"tcp://{addr}"
    dist.init_process_group(
        backend, init_method=addr, world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    log.info("torch.distributed: rank %d/%d, backend %s, device %s",
             dist.get_rank(), dist.get_world_size(), backend, dev)
    return dev


@dataclasses.dataclass
class PartitionedCSR:
    """Row-range partitioned CSR, stacked [G, ...] on the host; shard g's
    rows go to the rank that owns them.

    indptr:   int32 [G, rps+1], rebased to each shard's start.
    indices:  int32 [G, Emax], global neighbour ids, zero-padded.
    shuffled: int32 [G, Emax], the per-row shuffle of indices (the first
              hop's without-replacement source), same padding.
    etab/stab: int32 [G, Emax, 3] optional edge tables: row j of shard g
              is (nbr, nbr_edge_base, nbr_deg) for nbr = indices[g, j]
              (resp. shuffled[g, j]), nbr_edge_base the offset of nbr's
              row inside its owner's edge arrays; one row gather answers
              a step (`_probe_step_rows`). `edge_tables=False` drops them.
    """

    indptr: np.ndarray
    indices: np.ndarray
    shuffled: np.ndarray
    rows_per_shard: int
    num_nodes: int
    num_shards: int
    etab: Optional[np.ndarray] = None
    stab: Optional[np.ndarray] = None

    @property
    def num_edges(self) -> int:
        return int(self.indptr[:, -1].sum())


def partition_csr(graph: CSRGraph, n_shards: int, seed: int = 111413,
                  edge_tables: bool = True) -> PartitionedCSR:
    """Split a CSR graph into `n_shards` contiguous row ranges. The
    per-row shuffle is `shuffled_indices_for(graph, seed)` (the native
    shuffle), so partitioned walks reproduce single-device walks exactly.
    With `edge_tables`, also the [G, Emax, 3] edge tables."""
    from surel_plus_tpu_torch.ops.sampler import shuffled_indices_for

    N = graph.num_nodes
    rps = (N + n_shards - 1) // n_shards
    shuffled_global = shuffled_indices_for(graph, seed, "cpu").numpy()

    emax = 0
    for g in range(n_shards):
        a, b = min(g * rps, N), min((g + 1) * rps, N)
        emax = max(emax, int(graph.indptr[b] - graph.indptr[a]))

    indptr = np.zeros((n_shards, rps + 1), np.int32)
    indices = np.zeros((n_shards, emax), np.int32)
    shuffled = np.zeros((n_shards, emax), np.int32)
    gptr = graph.indptr.astype(np.int64)
    if edge_tables:
        # each node's (edge base inside its owner's shard, degree)
        shard_base = gptr[np.minimum(
            np.arange(n_shards, dtype=np.int64) * rps, N)]
        node_owner = np.arange(N, dtype=np.int64) // rps
        node_ebase = (gptr[:-1] - shard_base[node_owner]).astype(np.int32)
        node_deg = (gptr[1:] - gptr[:-1]).astype(np.int32)
        etab = np.zeros((n_shards, emax, 3), np.int32)
        stab = np.zeros((n_shards, emax, 3), np.int32)
    else:
        etab = stab = None
    for g in range(n_shards):
        a, b = min(g * rps, N), min((g + 1) * rps, N)
        base = int(graph.indptr[a])
        nnz = int(graph.indptr[b]) - base
        local = gptr[a:b + 1] - base
        indptr[g, :b - a + 1] = local
        indptr[g, b - a + 1:] = local[-1]  # padded rows: degree 0
        indices[g, :nnz] = graph.indices[base:base + nnz]
        shuffled[g, :nnz] = shuffled_global[base:base + nnz]
        if edge_tables:
            for tab, col in ((etab, indices[g, :nnz]),
                             (stab, shuffled[g, :nnz])):
                tab[g, :nnz, 0] = col
                tab[g, :nnz, 1] = node_ebase[col]
                tab[g, :nnz, 2] = node_deg[col]
    return PartitionedCSR(indptr=indptr, indices=indices, shuffled=shuffled,
                          rows_per_shard=rps, num_nodes=N,
                          num_shards=n_shards, etab=etab, stab=stab)


# ------------------------------------------------------------ the exchanges
def _clamp(idx: torch.Tensor, size: int) -> torch.Tensor:
    """Gather indices clamped into [0, size), as XLA clamps them (the
    values read at clamped indices are masked by the caller)."""
    return idx.clamp(0, max(size - 1, 0))


def _answer_picks(lindptr, table, nodes, aux, shard: int, rps: int):
    """The owner's answers to bare-pick requests (global node id, uint32
    draw as int32 bits): the (draw % deg)-th entry of the node's row of
    `table`, the node itself where it has no edge, 0 where another shard
    owns the node. int32, the requests' shape."""
    lid = nodes.to(torch.int64) - shard * rps
    owned = (lid >= 0) & (lid < rps)
    safe = lid.clamp(0, rps - 1)
    start = lindptr[safe]
    deg = lindptr[safe + 1] - start
    pick = walk_ops.u32(aux) % deg.clamp(min=1)
    ans = table[_clamp(start + pick, table.shape[0])]
    ans = torch.where(deg > 0, ans, nodes.to(ans.dtype))
    return torch.where(owned, ans, torch.zeros_like(ans)), owned


def _probe_step(lindptr, table, nodes, aux, axis: Axis, rps: int):
    """Owner-computed neighbour pick for a frontier of walkers: nodes/aux
    [B, M] (global id, draw); every rank receives every request, answers
    those it owns from its shard and masks the rest to 0; one all_to_all
    returns the answer blocks and their sum (one owner a node) is every
    answer. Returns int32 [B, M]."""
    all_nodes = axis.all_gather(nodes)                      # [G, B, M]
    all_aux = axis.all_gather(aux)
    ans, _ = _answer_picks(lindptr, table, all_nodes, all_aux, axis.index,
                           rps)
    return axis.all_to_all(ans).sum(dim=0, dtype=torch.int32)


def _capacity_plan(dest: torch.Tensor, G: int, capacity_slack: float):
    """The capacity routing's plan for requests [B, M] bound for shards
    `dest`: each row's requests stable-sorted by destination (`order`),
    each sorted request's slot dest * cap + rank in the [G, cap] send
    buffer (its rank among all requests for its destination, rows in
    order), whether it fits (`ok`) and whether any destination
    overflows cap."""
    B, M = dest.shape
    cap = int(np.ceil(capacity_slack * B * M / G))
    sdest, order = torch.sort(dest, dim=1, stable=True)
    targets = torch.arange(G + 1, device=dest.device).expand(B, G + 1)
    bounds = walk_ops.rows_searchsorted(sdest, targets)     # [B, G+1]
    cnt = bounds[:, 1:] - bounds[:, :-1]                    # [B, G]
    row_pref = torch.cumsum(cnt, dim=0) - cnt               # excl over rows
    span_start = torch.gather(bounds, 1, sdest)
    rpref = torch.gather(row_pref, 1, sdest)
    pos = torch.arange(M, device=dest.device).expand(B, M)
    rank = rpref + (pos - span_start)
    slot = sdest * cap + rank
    ok = rank < cap
    overflow = bool((cnt.sum(dim=0) > cap).any())
    return cap, order, slot, ok, overflow


def _vote(overflow: bool, axis: Axis, device) -> bool:
    """Whether any rank of the axis overflowed (a sum over the axis, read
    on the host: every rank takes the same branch)."""
    flag = torch.tensor([int(overflow)], dtype=torch.int32, device=device)
    return bool(axis.psum(flag).item() > 0)


def _scatter_send(vals: torch.Tensor, slot, ok, G: int, cap: int):
    """The [G, cap] send buffer of sorted request values `vals` [B, M, ...]
    at their slots (slots that do not fit are dropped)."""
    buf = vals.new_zeros((G * cap,) + tuple(vals.shape[2:]))
    buf[slot[ok]] = vals[ok]
    return buf.reshape((G, cap) + tuple(vals.shape[2:]))


def _route_step(lindptr, table, nodes, aux, axis: Axis, rps: int,
                capacity_slack: float = 1.25):
    """Capacity-routed neighbour pick, the scalable alternative to
    `_probe_step`: each request travels only to its owner (row-sorted by
    destination, ranked, placed in a [G, C] buffer; one all_to_all out,
    the owner answers C slots a peer, one all_to_all back, the requester
    reads its answers by slot and puts them back in column order). When
    any rank's destination overflows C the whole step takes the probe;
    the results are the same either way."""
    G = axis.size
    B, M = nodes.shape
    dest = (nodes.to(torch.int64) // rps)
    cap, order, slot, ok, overflow = _capacity_plan(dest, G, capacity_slack)
    if _vote(overflow, axis, nodes.device):
        return _probe_step(lindptr, table, nodes, aux, axis, rps)
    snode = torch.gather(nodes, 1, order)
    saux = torch.gather(aux, 1, order)
    rq_node = axis.all_to_all(_scatter_send(snode, slot, ok, G, cap))
    rq_aux = axis.all_to_all(_scatter_send(saux, slot, ok, G, cap))
    lid = (rq_node.to(torch.int64) - axis.index * rps).clamp(0, rps - 1)
    start = lindptr[lid]
    deg = lindptr[lid + 1] - start
    pick = walk_ops.u32(rq_aux) % deg.clamp(min=1)
    ans = table[_clamp(start + pick, table.shape[0])]
    ans = torch.where(deg > 0, ans, rq_node.to(ans.dtype)).to(torch.int32)
    back = axis.all_to_all(ans).reshape(-1)
    got = back[torch.where(ok, slot, 0)]
    # un-sort: answers back to their original columns
    return torch.empty_like(got).scatter_(1, order, got)


def _seed_info_probe(lindptr, sd, axis: Axis, rps: int):
    """One [B]-shaped exchange fetching each seed's (edge_base, degree)
    from its owner: the entry state of the edge-table walk."""
    all_sd = axis.all_gather(sd)                            # [G, B]
    lid = all_sd.to(torch.int64) - axis.index * rps
    owned = (lid >= 0) & (lid < rps)
    safe = lid.clamp(0, rps - 1)
    start = lindptr[safe]
    vals = torch.stack([start, lindptr[safe + 1] - start], dim=-1)
    vals = torch.where(owned[..., None], vals, 0).to(torch.int32)
    out = axis.all_to_all(vals).sum(dim=0, dtype=torch.int32)  # [B, 2]
    return out[..., 0], out[..., 1]


def _table_rows(table3, owner, eidx, shard: int):
    """The owner's [.., 3] edge-table rows for requests (owning shard,
    edge index), zeros where another shard owns the request."""
    rows = table3[_clamp(eidx.to(torch.int64), table3.shape[0])]
    return torch.where((owner == shard)[..., None], rows,
                       torch.zeros_like(rows))


def _probe_step_rows(table3, owner, eidx, axis: Axis):
    """Owner-computed edge-table lookup for a frontier: owner/eidx [B, M]
    (owning shard, edge index into its [Emax, 3] table); the owner answers
    with the whole (nbr, nbr_edge_base, nbr_deg) row, one row gather a
    request. Returns int32 [B, M, 3]."""
    all_owner = axis.all_gather(owner)                      # [G, B, M]
    all_eidx = axis.all_gather(eidx)
    rows = _table_rows(table3, all_owner, all_eidx, axis.index)
    return axis.all_to_all(rows).sum(dim=0, dtype=torch.int32)


def _route_step_rows(table3, owner, eidx, axis: Axis,
                     capacity_slack: float = 1.25):
    """Capacity-routed `_probe_step_rows`: requests travel only to their
    owner ([G, C] buffers, one all_to_all each way), the answer is the
    [3]-row; the whole step takes the probe when any rank overflows."""
    G = axis.size
    cap, order, slot, ok, overflow = _capacity_plan(
        owner.to(torch.int64), G, capacity_slack)
    if _vote(overflow, axis, owner.device):
        return _probe_step_rows(table3, owner, eidx, axis)
    seidx = torch.gather(eidx, 1, order)
    rq = axis.all_to_all(_scatter_send(seidx, slot, ok, G, cap))
    rows = table3[_clamp(rq.to(torch.int64), table3.shape[0])]  # [G, C, 3]
    back = axis.all_to_all(rows.to(torch.int32)).reshape(-1, 3)
    got = back[torch.where(ok, slot, 0)]                        # [B, M, 3]
    return torch.empty_like(got).scatter_(
        1, order[..., None].expand_as(got), got)


# ---------------------------------------------------------------- the walks
def _walk_bare_exchange(lindptr, lindices, lshuffled, sd, bits, axis,
                        step_fn, M: int, S: int):
    """Frontier-exchange walk answering bare neighbour picks: the first
    hop the m-th shuffled neighbour (without replacement), later hops
    bits[t] % deg. `bits` [S - 1, per, M] is this rank's slice. Returns
    int32 [per, M, S]."""
    per = sd.shape[0]
    m = torch.arange(M, dtype=torch.int32, device=sd.device)
    cur = step_fn(lindptr, lshuffled, sd[:, None].expand(per, M).contiguous(),
                  m.expand(per, M).contiguous(), axis)
    walks = [cur]
    for t in range(S - 1):
        cur = step_fn(lindptr, lindices, cur, walk_ops.to_bits(bits[t]), axis)
        walks.append(cur)
    return torch.stack(walks, dim=-1)


def _walk_tables_exchange(lindptr, letab, lstab, sd, bits, axis, rows_fn,
                          rps: int, M: int, S: int):
    """Frontier-exchange walk over the [Emax, 3] edge tables: walkers
    carry (cur, edge_base, deg), picks are drawn on the requester's side,
    and the owner answers each request with one row (the partitioned
    mirror of `walk.walk_block_tables`, exact with it and with the bare
    exchange)."""
    per = sd.shape[0]
    sstart, sdeg = _seed_info_probe(lindptr, sd, axis, rps)
    m = torch.arange(M, dtype=torch.int32, device=sd.device)
    offs = m[None, :] % sdeg[:, None].clamp(min=1)
    owner0 = (sd // rps)[:, None].expand(per, M).contiguous()
    rows0 = rows_fn(lstab, owner0, (sstart[:, None] + offs).contiguous(),
                    axis)
    live0 = sdeg[:, None] > 0
    cur = torch.where(live0, rows0[..., 0], sd[:, None])
    walks = [cur]
    if S > 1:
        ebase = rows0[..., 1]
        deg = torch.where(live0, rows0[..., 2], 0)
        for t in range(S - 1):
            pick = (bits[t] % deg.to(torch.int64).clamp(min=1)).to(
                torch.int32)
            rows = rows_fn(letab, (cur // rps).contiguous(),
                           (ebase + pick).contiguous(), axis)
            live = deg > 0
            cur = torch.where(live, rows[..., 0], cur)
            ebase = torch.where(live, rows[..., 1], ebase)
            deg = torch.where(live, rows[..., 2], deg)
            walks.append(cur)
    return torch.stack(walks, dim=-1)


def _shard_tensors(pcsr: PartitionedCSR, shard: int, device):
    """Shard `shard`'s arrays on `device`: indptr int64, and either the
    edge tables (etab, stab) or (indices, shuffled), int32."""
    t = lambda a: torch.as_tensor(a[shard]).to(device)
    lindptr = t(pcsr.indptr).to(torch.int64)
    if pcsr.etab is not None:
        return lindptr, t(pcsr.etab), t(pcsr.stab)
    return lindptr, t(pcsr.indices), t(pcsr.shuffled)


def _step_fns(routing: str, rps: int, capacity_slack: float):
    """(step_fn, rows_fn) of a routing: "probe" or "capacity"."""
    if routing == "capacity":
        def step_fn(lp, tb, nd, au, ax):
            return _route_step(lp, tb, nd, au, ax, rps, capacity_slack)

        def rows_fn(tb, ow, ei, ax):
            return _route_step_rows(tb, ow, ei, ax, capacity_slack)
    elif routing == "probe":
        def step_fn(lp, tb, nd, au, ax):
            return _probe_step(lp, tb, nd, au, ax, rps)

        def rows_fn(tb, ow, ei, ax):
            return _probe_step_rows(tb, ow, ei, ax)
    else:
        raise ValueError(f"unknown routing {routing!r}")
    return step_fn, rows_fn


def _sample_exchange(pcsr: PartitionedCSR, seeds: np.ndarray,
                     num_walks: int, num_steps: int, mesh: Mesh,
                     axis: Axis, seed: int, bucket: Optional[int],
                     routing: str, capacity_slack: float,
                     bits: Optional[torch.Tensor]) -> LocalSpGKeys:
    """The partitioned samplers' body: world rank r walks seeds
    [r*per, (r+1)*per) over shard axis.index of `pcsr`, exchanging over
    `axis`, with bits rows [r*per, (r+1)*per) of the global draw."""
    dev, r, world = mesh.device, mesh.rank, mesh.world_size
    seeds = np.asarray(seeds, dtype=np.int32)
    n = len(seeds)
    M, S = num_walks, num_steps
    if bucket is None:
        bucket = M * S + 1
    per = -(-n // world)
    n_pad = per * world
    seeds_pad = np.zeros(n_pad, np.int32)
    seeds_pad[:n] = seeds
    if bits is None:
        bits = walk_ops.walk_bits(prng.prng_key(seed), per, M, S, dev,
                                  row0=r * per)
    elif tuple(bits.shape) != (max(S - 1, 0), n_pad, M):
        raise ValueError(f"bits has shape {tuple(bits.shape)}, expected "
                         f"{(max(S - 1, 0), n_pad, M)}")
    else:
        bits = bits[:, r * per:(r + 1) * per].to(dev, torch.int64)
    sd = torch.as_tensor(seeds_pad[r * per:(r + 1) * per]).to(dev)
    rps = pcsr.rows_per_shard
    step_fn, rows_fn = _step_fns(routing, rps, capacity_slack)
    lindptr, a, b = _shard_tensors(pcsr, axis.index, dev)
    if pcsr.etab is not None:
        wmat = _walk_tables_exchange(lindptr, a, b, sd, bits, axis, rows_fn,
                                     rps, M, S)
    else:
        wmat = _walk_bare_exchange(lindptr, a, b, sd, bits, axis, step_fn,
                                   M, S)
    nodes, sizes, hi, lo = walk_ops.build_sets_packed_block(
        sd, wmat.to(torch.int64), M, S, bucket)
    keep = max(min(per, n - r * per), 0)
    return LocalSpGKeys(
        sets=SpGKeys(nodes=nodes[:keep], khi=hi[:keep], klo=lo[:keep],
                     sizes=sizes[:keep], num_walks=M, num_steps=S),
        start=r * per, num_rows=n)


def sample_gsets_partitioned(
    pcsr: PartitionedCSR,
    seeds: np.ndarray,
    num_walks: int,
    num_steps: int,
    mesh: Mesh,
    seed: int = 111413,
    bucket: Optional[int] = None,
    routing: str = "probe",
    capacity_slack: float = 1.25,
    bits: Optional[torch.Tensor] = None,
) -> LocalSpGKeys:
    """Set sampling over a graph partitioned over every rank (shard r on
    world rank r). Seeds are sharded over the world; each rank walks its
    seeds, fetching neighbour picks from the shards' owners through the
    frontier exchange (`routing` "probe" or "capacity"). Returns this
    rank's rows (`shard_spg_keys` moves them to their graph shards).

    Equal to `walk.sample_block(..., key=prng_key(seed))` over the whole
    padded seed block (each rank drawing its rows of the global draw), as
    the JAX package's `sample_gsets_partitioned` is, or walked from the
    given `bits` [S' - 1, n_pad, M]."""
    if pcsr.num_shards != mesh.world_size:
        raise ValueError(f"{pcsr.num_shards} shards for a world of "
                         f"{mesh.world_size} ranks")
    return _sample_exchange(pcsr, seeds, num_walks, num_steps, mesh,
                            mesh.axis("world"), seed, bucket, routing,
                            capacity_slack, bits)


def sample_gsets_grouped(
    graph: CSRGraph,
    seeds: np.ndarray,
    num_walks: int,
    num_steps: int,
    mesh: Mesh,
    group_size: int,
    seed: int = 111413,
    bucket: Optional[int] = None,
    routing: str = "probe",
    capacity_slack: float = 1.25,
    bits: Optional[torch.Tensor] = None,
) -> LocalSpGKeys:
    """Replica-group sampling: the graph partitioned over each group of
    `group_size` consecutive ranks (one replica a group), the seeds split
    over all ranks in world order; the frontier exchange stays inside the
    group. group_size 1 is the replicated seed-parallel path, the world
    the fully partitioned one. Returns this rank's rows, equal to
    `sample_gsets_partitioned`'s."""
    axis = mesh.grouped(group_size)
    pcsr = partition_csr(graph, group_size, seed=seed)
    return _sample_exchange(pcsr, seeds, num_walks, num_steps, mesh, axis,
                            seed, bucket, routing, capacity_slack, bits)
