"""SpJoin over sampled sets (port of surel_plus_tpu/ops/join.py: the keys
joins and the encoding-table joins, for link queries (Q=2: `make_keys_join`,
`gather_join`) and 3-node hyperedge queries (`make_keys_hjoin`,
`hgather_join`)).

For a query (u, v) every node x of S_u is paired with its key w.r.t. u
and its key w.r.t. v (0 when x is not in S_v), and symmetrically for
S_v. Rows are node-sorted, so both directions come out of ONE merge of
the two rows (`_cross_lookup_bidir_multi`).

Eager PyTorch runs whatever it is given, where XLA drops dead code: the
slot-aligned outputs (the un-sort sort and the aligned cross keys) are
built only when the caller asks for them (`aligned=True`), and the
unpacked feature pairs only when it also asks for `features`. The fused
mean route reads only the merged-order planes, the fused attention route
the aligned keys, the unfused routes the feature pairs
(`Net.join_outputs`).

Two joins carry no key planes, as in the JAX package: impl="pallas" (the
cross lookup of both key words in both directions, one launch of K6,
`ops/kernels/cross_lookup.py`) and
the general hi/lo key layout (count fields in the hi word, e.g. M=1000,
S'=4), whose merge carries both words. They build the feature pairs and
the mask, whatever `aligned` and `features` say.

A hyperedge (u, v, w) joins into four endpoint groups, u|w, w|u, v|w and
w|v (each set's own keys paired with the partner's), which are the two
directions of two merges, (u, w) and (v, w).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from surel_plus_tpu_torch.ops.kernels.cross_lookup import cross_lookup_pair
from surel_plus_tpu_torch.ops.merge_net import merge_pairs
from surel_plus_tpu_torch.ops.walk import (
    INT32_MAX,
    enc_field_layout,
    to_bits,
    u32,
)


class JoinedBatch(NamedTuple):
    """Join output for a batch of B queries with Q endpoints each.

    eidx:  keys joins: float32 [Q, B, L, 2, ncol] unpacked feature pairs:
           [..., 0, :] the anchor side's encoding, [..., 1, :] the
           partner's (zeros if absent); None unless the join was asked for
           aligned outputs with features, or carries no key planes.
           `gather_join`: int32 [Q, B, L, 2] encoding-table indices,
           [..., 0] the anchor side's, [..., 1] the partner's (0, the zero
           row, if absent).
    mask:  bool  [Q, B, L] validity of each set slot.
    sizes: int32 [Q, B] true set sizes.
    kown:  int32 bits [Q, B, L] of the packed lo keys, slot order; this
           and the planes below are None where the join carries no key
           planes (impl="pallas", the general hi/lo layout).
    kcross: int32 bits [B, 2L], ONE shared plane in merged order holding
           every endpoint's partner keys at disjoint positions, selected
           per endpoint by kcross_mask [Q, B, 2L] (the hyperedge join's:
           [B, 4L], its two merges side by side, and [4, B, 4L]).
    kcross_al: int32 bits [Q, B, L] slot-aligned partner lo keys
           (aligned joins only).
    *_root: int32 0/1 root-indicator planes, same shapes as the key
           planes, for the lead-in-hi layout only (the root bit is the
           hi word's bit 0; a slot is the root iff its node is the seed).
    """

    eidx: Optional[torch.Tensor]
    mask: torch.Tensor
    sizes: torch.Tensor
    kown: Optional[torch.Tensor] = None
    kcross: Optional[torch.Tensor] = None
    kcross_mask: Optional[torch.Tensor] = None
    kcross_al: Optional[torch.Tensor] = None
    kown_root: Optional[torch.Tensor] = None
    kcross_root: Optional[torch.Tensor] = None
    kcross_al_root: Optional[torch.Tensor] = None


def _cross_lookup_bidir_multi(nodes_u, nodes_v, pays_u, pays_v,
                              want_sorted: bool = False,
                              aligned: bool = True):
    """BOTH cross directions of N payloads from ONE merge.

    Keys are node << 1 | tag (v copies tag 0, u copies tag 1), so a node
    present on both sides sorts as [v copy, u copy]: each u slot reads its
    match from its LEFT neighbor, each v slot from its RIGHT one. One
    payload rides the merge itself; several (the general layout's hi and
    lo words, JAX's lax.sort branch) are gathered through the slot index
    [v block | u block] that rides it instead.

    Returns (cross_u, cross_v), each an N-tuple of int32 [B, L]: for every
    u slot the v payloads of the same node (0 if absent), and vice versa;
    N Nones each when `aligned` is False. With `want_sorted` it also returns
    the merged-order planes (su_cross, su_mask, sv_cross, sv_mask, snode,
    stag), the cross planes N-tuples, each [B, 2L].
    """
    B, L = nodes_u.shape
    nv = nodes_v.to(torch.int64)
    nu = nodes_u.to(torch.int64)
    if len(pays_u) == 1:
        spk, sp = merge_pairs(to_bits(nv << 1), pays_v[0],
                              to_bits((nu << 1) | 1), pays_u[0])
        sps = (sp,)
    else:
        pos = torch.arange(2 * L, dtype=torch.int32, device=nodes_u.device)
        pos = pos.expand(B, 2 * L)
        spk, sp = merge_pairs(to_bits(nv << 1), pos[:, :L].contiguous(),
                              to_bits((nu << 1) | 1), pos[:, L:].contiguous())
        sp = sp.to(torch.int64)
        sps = tuple(torch.gather(torch.cat([pv, pu], dim=1), 1, sp)
                    for pu, pv in zip(pays_u, pays_v))
    spk = u32(spk)
    snode = spk >> 1
    st = spk & 1
    zero = torch.zeros_like(sps[0][:, :1])
    # u slot (tag 1) matches when its left neighbor is the v copy
    hit_u = torch.zeros_like(snode, dtype=torch.bool)
    hit_u[:, 1:] = ((snode[:, 1:] == snode[:, :-1]) & (st[:, 1:] == 1)
                    & (st[:, :-1] == 0) & (snode[:, 1:] != INT32_MAX))
    cu = tuple(torch.where(hit_u, torch.cat([zero, p[:, :-1]], dim=1), 0)
               for p in sps)
    # v slot (tag 0) matches when its right neighbor is the u copy
    hit_v = torch.zeros_like(hit_u)
    hit_v[:, :-1] = ((snode[:, :-1] == snode[:, 1:]) & (st[:, :-1] == 0)
                     & (st[:, 1:] == 1) & (snode[:, :-1] != INT32_MAX))
    cv = tuple(torch.where(hit_v, torch.cat([p[:, 1:], zero], dim=1), 0)
               for p in sps)
    none = (None,) * len(sps)
    out = (none, none)
    if aligned:
        # un-sort: the original [v block | u block] layout is (tag, node)
        # ascending, rebuilt from the merged keys
        order = torch.sort((st << 31) | snode, dim=1, stable=True).indices
        out = (tuple(torch.gather(c, 1, order)[:, L:] for c in cu),
               tuple(torch.gather(c, 1, order)[:, :L] for c in cv))
    if not want_sorted:
        return out
    pad = snode != INT32_MAX
    return out + (cu, (st == 1) & pad, cv, (st == 0) & pad, snode, st)


def gather_join(nodes: torch.Tensor, eidx: torch.Tensor,
                sizes: torch.Tensor, edges: torch.Tensor) -> JoinedBatch:
    """Join encoding-table sets (SpGDevice rows) for query edges [2, B] of
    row ids: block 0 pairs (Z_u[x], Z_v[x]) for x in S_u, block 1 pairs
    (Z_v[x], Z_u[x]) for x in S_v. Both directions come out of one merge
    of the two node rows with the table indices as its payload, and the
    output does not depend on the key layout."""
    if edges.shape[0] != 2:
        raise ValueError("gather_join handles Q=2; use hgather_join for "
                         "higher-order queries")
    # a contiguous index gathers contiguous rows, which the merge takes
    edges = edges.to(torch.int64).contiguous()
    rows_nodes, rows_eidx = nodes[edges], eidx[edges]          # [2, B, L]
    eu, ev = rows_eidx[0], rows_eidx[1]
    (cross_u,), (cross_v,) = _cross_lookup_bidir_multi(
        rows_nodes[0], rows_nodes[1], (eu,), (ev,), aligned=True)
    pairs = torch.stack([torch.stack([eu, cross_u], dim=-1),
                         torch.stack([ev, cross_v], dim=-1)])
    return JoinedBatch(eidx=pairs, mask=rows_nodes != INT32_MAX,
                       sizes=sizes[edges])


def unpack_key_features(khi: torch.Tensor, klo: torch.Tensor,
                        num_walks: int, num_steps: int) -> torch.Tensor:
    """Packed keys (int32 bits) -> normalized float32 features
    [..., num_steps+1] (counts / num_walks)."""
    shift, starts, lead_bit = enc_field_layout(num_walks, num_steps)
    mask = (1 << shift) - 1
    hi, lo = u32(khi), u32(klo)

    def field(start_bit):
        if start_bit < 32:
            return (lo >> start_bit) & mask
        return (hi >> (start_bit - 32)) & mask

    if lead_bit < 32:
        root = (lo >> lead_bit) & 1
    else:
        root = (hi >> (lead_bit - 32)) & 1
    cols = [root * num_walks] + [field(starts[j])
                                 for j in range(1, num_steps + 1)]
    feats = torch.stack(cols, dim=-1).to(torch.float32)
    return feats / num_walks


def make_keys_join(num_walks: int, num_steps: int, impl: str = "merge",
                   aligned: bool = True, features: bool = True):
    """Join function over SpGKeys rows: join(nodes, khi, klo, sizes, edges)
    with edges [2, B] row indices."""

    def join(nodes, khi, klo, sizes, edges):
        # a contiguous index gathers contiguous rows, which the kernels take
        edges = edges.to(torch.int64).contiguous()
        return join_gathered_keys(nodes[edges], khi[edges], klo[edges],
                                  sizes[edges], num_walks, num_steps,
                                  impl=impl, aligned=aligned,
                                  features=features)

    return join


def join_gathered_keys(rows_nodes, rows_hi, rows_lo, rows_sizes,
                       num_walks: int, num_steps: int, impl: str = "merge",
                       aligned: bool = True,
                       features: bool = True) -> JoinedBatch:
    """Keys join over pre-gathered rows ([2, B, L] each). `aligned` adds
    the slot-aligned cross keys (and their root planes), `features` with
    it the unpacked feature pairs.

    impl "merge": one merge of the two rows (K2) in the lo-only layout
    (every field and the root bit in the lo word) and the lead-in-hi
    layout (fields fill the lo word, the root bit is the hi word's bit 0),
    with the key planes the fused routes read; in the general hi/lo layout
    the merge carries both words and the join gives the feature pairs
    only. impl "pallas": the cross lookup of both words in both directions
    (one launch of K6 over the node-sorted rows), for any layout, the
    feature pairs only (JAX join.py:329-336, :366).
    """
    if impl not in ("merge", "pallas"):
        raise ValueError(f"unknown join impl {impl!r}")
    if rows_nodes.shape[0] != 2:
        raise ValueError("the keys join handles Q=2; use make_keys_hjoin "
                         "for hyperedge queries")
    lead_bit = enc_field_layout(num_walks, num_steps)[2]
    lo_only = lead_bit < 32
    lead_hi = lead_bit == 32
    nu, nv = rows_nodes[0], rows_nodes[1]
    mask = rows_nodes != INT32_MAX
    if impl == "pallas" or not (lo_only or lead_hi):
        if impl == "pallas":
            (cross_hi_u, cross_lo_u, cross_hi_v,
             cross_lo_v) = cross_lookup_pair(nu, nv, rows_hi[0], rows_lo[0],
                                             rows_hi[1], rows_lo[1])
        else:
            ((cross_hi_u, cross_lo_u),
             (cross_hi_v, cross_lo_v)) = _cross_lookup_bidir_multi(
                nu, nv, (rows_hi[0], rows_lo[0]), (rows_hi[1], rows_lo[1]))
        feats = _feature_pairs(rows_hi, rows_lo,
                               torch.stack([cross_hi_u, cross_hi_v]),
                               torch.stack([cross_lo_u, cross_lo_v]),
                               num_walks, num_steps)
        return JoinedBatch(eidx=feats, mask=mask, sizes=rows_sizes)
    ((cross_lo_u,), (cross_lo_v,), (scu,), su_mask, (scv,), sv_mask,
     snode, stag) = _cross_lookup_bidir_multi(
        nu, nv, (rows_lo[0],), (rows_lo[1],), want_sorted=True,
        aligned=aligned)
    kown_root = kcross_root = None
    if lead_hi:
        # the root indicator follows from node ids: a slot is the root iff
        # its node is the set's seed, a partner iff it is the other seed
        rbit_u = rows_hi[0] & 1
        rbit_v = rows_hi[1] & 1
        u_b = torch.where(rbit_u > 0, nu, -1).amax(dim=1)
        v_b = torch.where(rbit_v > 0, nv, -1).amax(dim=1)
        kown_root = torch.stack([rbit_u, rbit_v])
        kcross_root = (((stag == 1) & (snode == v_b[:, None]))
                       | ((stag == 0) & (snode == u_b[:, None]))
                       ).to(torch.int32)
    kown = torch.stack([rows_lo[0], rows_lo[1]])
    # disjoint (tag-separated) positions: the sum is a select
    kcross = scu + scv
    kcross_mask = torch.stack([su_mask, sv_mask])
    feats = kcross_al = kcross_al_root = None
    if aligned:
        kcross_al = torch.stack([cross_lo_u, cross_lo_v])
        if lead_hi:
            kcross_al_root = torch.stack([
                ((nu == v_b[:, None]) & (nu != INT32_MAX)),
                ((nv == u_b[:, None]) & (nv != INT32_MAX))]).to(torch.int32)
            cross_hi = kcross_al_root
        else:
            cross_hi = torch.zeros_like(kcross_al)
        if features:
            feats = _feature_pairs(rows_hi, rows_lo, cross_hi, kcross_al,
                                   num_walks, num_steps)
    return JoinedBatch(eidx=feats, mask=mask, sizes=rows_sizes, kown=kown,
                       kcross=kcross, kcross_mask=kcross_mask,
                       kcross_al=kcross_al, kown_root=kown_root,
                       kcross_root=kcross_root,
                       kcross_al_root=kcross_al_root)


def _feature_pairs(rows_hi, rows_lo, cross_hi, cross_lo, num_walks: int,
                   num_steps: int) -> torch.Tensor:
    """The unpacked feature pairs [Q, B, L, 2, C]: each slot's own key and
    its partner's ([Q, B, L] words each)."""
    return unpack_key_features(torch.stack([rows_hi, cross_hi], dim=-1),
                               torch.stack([rows_lo, cross_lo], dim=-1),
                               num_walks, num_steps)


# A hyperedge (u, v, w), rows 0, 1, 2: the two merges (u, w) and (v, w),
# whose two directions each are the four groups u|w, w|u, v|w, w|v, and
# the row each group's own slots come from.
HPAIRS = ((0, 2), (1, 2))
HGROUPS = (0, 2, 1, 2)


def _groups(x: torch.Tensor) -> torch.Tensor:
    """[3, ...] rows -> [4, ...] in group order (a stack, not an index
    list, which would be copied to the device and waited for)."""
    return torch.stack([x[a] for a in HGROUPS])


def make_keys_hjoin(num_walks: int, num_steps: int, features: bool = True):
    """Join function over SpGKeys rows for hyperedges: join(nodes, khi,
    klo, sizes, hedges) with hedges [3, B] row indices (JAX
    make_keys_hjoin). `features=False` leaves out the feature pairs (and
    the un-sort they need) where the model reads only the key planes."""

    def join(nodes, khi, klo, sizes, hedges):
        if hedges.shape[0] != 3:
            raise ValueError("expects [3, B] hyperedges")
        # a contiguous index gathers contiguous rows, which the kernels take
        hedges = hedges.to(torch.int64).contiguous()
        return join_gathered_hkeys(nodes[hedges], khi[hedges], klo[hedges],
                                   sizes[hedges], num_walks, num_steps,
                                   features=features)

    return join


def join_gathered_hkeys(rn, rh, rl, rs, num_walks: int, num_steps: int,
                        features: bool = True) -> JoinedBatch:
    """Hyperedge keys join over pre-gathered rows ([3, B, L] each, rows u,
    v, w): the groups u|w, w|u, v|w, w|v from one merge of (u, w) and one
    of (v, w) (JAX join.py:392-466). mask [4, B, L] and sizes [4, B] are
    the groups' own rows'; `features` adds the feature pairs eidx
    [4, B, L, 2, C].

    In the lo-only and lead-in-hi layouts it also gives the fused route's
    planes: kown [4, B, L] (the groups' own lo keys), ONE cross plane
    kcross [B, 4L] holding the two merges' merged-order planes side by
    side, kcross_mask [4, B, 4L] (each group selects its partner's keys in
    its own merge's half only), and in the lead-in-hi layout the root
    planes kown_root [4, B, L] and kcross_root [B, 4L]. In the general
    hi/lo layout both words ride the merges and only the feature pairs
    come out, whatever `features` says."""
    if rn.shape[0] != 3:
        raise ValueError("the hyperedge join takes [3, B, L] rows")
    lead_bit = enc_field_layout(num_walks, num_steps)[2]
    lo_only = lead_bit < 32
    lead_hi = lead_bit == 32
    mask = _groups(rn != INT32_MAX)
    sizes = _groups(rs)
    cross_hi, cross_lo = [], []
    if not (lo_only or lead_hi):
        for a, b in HPAIRS:
            (ca_h, ca_l), (cb_h, cb_l) = _cross_lookup_bidir_multi(
                rn[a], rn[b], (rh[a], rl[a]), (rh[b], rl[b]))
            cross_hi += [ca_h, cb_h]
            cross_lo += [ca_l, cb_l]
        feats = _feature_pairs(_groups(rh), _groups(rl),
                               torch.stack(cross_hi), torch.stack(cross_lo),
                               num_walks, num_steps)
        return JoinedBatch(eidx=feats, mask=mask, sizes=sizes)
    _, b, ell = rn.shape
    dev = rn.device
    kcross = torch.empty(b, 4 * ell, dtype=torch.int32, device=dev)
    kcross_mask = torch.zeros(4, b, 4 * ell, dtype=torch.bool, device=dev)
    kcross_root = kown_root = None
    own_roots = []
    if lead_hi:
        kcross_root = torch.empty_like(kcross)
    for i, (a, b_) in enumerate(HPAIRS):
        half = slice(2 * ell * i, 2 * ell * (i + 1))
        ((ca_l,), (cb_l,), (sca,), sa_mask, (scb,), sb_mask, snode,
         stag) = _cross_lookup_bidir_multi(rn[a], rn[b_], (rl[a],),
                                           (rl[b_],), want_sorted=True,
                                           aligned=features)
        # disjoint (tag-separated) positions: the sum is a select
        torch.add(sca, scb, out=kcross[:, half])
        kcross_mask[2 * i, :, half] = sa_mask
        kcross_mask[2 * i + 1, :, half] = sb_mask
        if lead_hi:
            # the root indicator follows from node ids (join_gathered_keys)
            rb_a, rb_b = rh[a] & 1, rh[b_] & 1
            a_id = torch.where(rb_a > 0, rn[a], -1).amax(dim=1)[:, None]
            b_id = torch.where(rb_b > 0, rn[b_], -1).amax(dim=1)[:, None]
            kcross_root[:, half] = (((stag == 1) & (snode == b_id))
                                    | ((stag == 0) & (snode == a_id)))
            own_roots += [rb_a, rb_b]
            if features:
                cross_hi += [((rn[a] == b_id) & (rn[a] != INT32_MAX)),
                             ((rn[b_] == a_id) & (rn[b_] != INT32_MAX))]
        elif features:
            cross_hi += [torch.zeros_like(ca_l), torch.zeros_like(cb_l)]
        cross_lo += [ca_l, cb_l]
    if lead_hi:
        kown_root = torch.stack(own_roots)
    feats = None
    if features:
        feats = _feature_pairs(_groups(rh), _groups(rl),
                               torch.stack(cross_hi).to(torch.int32),
                               torch.stack(cross_lo), num_walks, num_steps)
    return JoinedBatch(eidx=feats, mask=mask, sizes=sizes, kown=_groups(rl),
                       kcross=kcross, kcross_mask=kcross_mask,
                       kown_root=kown_root, kcross_root=kcross_root)


def hgather_join(nodes: torch.Tensor, eidx: torch.Tensor,
                 sizes: torch.Tensor, hedges: torch.Tensor) -> JoinedBatch:
    """Join encoding-table sets (SpGDevice rows) for hyperedges [3, B] of
    row ids (u, v, w): the groups u|w, w|u, v|w, w|v, each pairing a set's
    own table indices with the partner's (0, the zero row, if absent),
    eidx [4, B, L, 2] (JAX join.py:482-512, `hgather` of the reference).
    JAX looks each group up in one direction; here one merge of (u, w) and
    one of (v, w) give both directions each, the same values."""
    if hedges.shape[0] != 3:
        raise ValueError("hgather_join expects [3, B] hyperedges")
    hedges = hedges.to(torch.int64).contiguous()
    rn, re = nodes[hedges], eidx[hedges]                     # [3, B, L]
    blocks = []
    for a, b in HPAIRS:
        (ca,), (cb,) = _cross_lookup_bidir_multi(rn[a], rn[b], (re[a],),
                                                 (re[b],), aligned=True)
        blocks += [torch.stack([re[a], ca], dim=-1),
                   torch.stack([re[b], cb], dim=-1)]
    return JoinedBatch(eidx=torch.stack(blocks), mask=_groups(rn != INT32_MAX),
                       sizes=_groups(sizes[hedges]))
