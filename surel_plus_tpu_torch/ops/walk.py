"""Walk-based node-set sampling with packed landing-count keys
(port of surel_plus_tpu/ops/walk.py: the edge-table walk, the packed
set builder and the host unpacking of deduplicated keys).

The random bits come from the JAX package's key tree (`ops/prng.py`):
`walk_bits` draws step t's words as `bits(split(key, S-1)[t], [B, M])`,
the JAX walk's `jax.random.bits` of its step keys, so the same block key
walks the same walks. `walk_block_tables` walks from given bits.

Unsigned 32-bit words (keys, random bits) are held in int64 tensors with
values in [0, 2^32) while they are computed, and stored as int32 bit
patterns (`to_bits` / `u32`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from surel_plus_tpu_torch.ops import prng
from surel_plus_tpu_torch.ops.kernels.threefry import threefry_bits
from surel_plus_tpu_torch.utils.profiling import span

INT32_MAX = int(np.iinfo(np.int32).max)
U32 = 0xFFFFFFFF


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns (or int64 words) -> int64 values in [0, 2^32)."""
    return x.to(torch.int64) & U32


def to_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same bits."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def enc_field_layout(num_walks: int, num_steps: int):
    """Bit layout of the packed landing-count key: (shift, starts, lead_bit).

    Columns 1..S hold SHIFT bits each, column S at the bottom, with a root
    (LEAD) bit above them; field starts are padded so that no field
    straddles the 32-bit word boundary, which lets the key live in a
    (hi, lo) word pair and makes a segment's key the modular sum of its
    visits' field contributions.
    """
    shift = int(num_walks).bit_length()
    starts = {}
    bit = 0
    for j in range(num_steps, 0, -1):
        if bit < 32 < bit + shift:
            bit = 32  # pad past the word boundary
        starts[j] = bit
        bit += shift
    if bit < 32 < bit + 1:
        bit = 32
    lead_bit = bit
    total = lead_bit + 1
    if total > 62:  # reserve top bits for the dedup sentinel
        raise ValueError(
            f"encoding key needs {total} bits > 62 "
            f"(num_walks={num_walks}, num_steps={num_steps})")
    return shift, starts, lead_bit


def unpack_encodings(packed: np.ndarray, num_walks: int,
                     num_steps: int) -> np.ndarray:
    """Invert the bit-pack: uint64 keys -> int32 [n, num_steps+1] counts
    (column 0 is num_walks for the root, else 0)."""
    shift, starts, lead_bit = enc_field_layout(num_walks, num_steps)
    mask = np.uint64((1 << shift) - 1)
    ncol = num_steps + 1
    out = np.zeros((len(packed), ncol), dtype=np.int32)
    root = (packed >> np.uint64(lead_bit)) & np.uint64(1)
    out[:, 0] = root.astype(np.int32) * num_walks
    for j in range(1, ncol):
        out[:, j] = ((packed >> np.uint64(starts[j])) & mask).astype(
            np.int32)
    return out


def shuffle_csr_rows(row_ids: torch.Tensor, indices: torch.Tensor,
                     rand: torch.Tensor) -> torch.Tensor:
    """Permute CSR `indices` within each row by one stable sort of
    (row id, random key): `rand` holds one 32-bit key an entry (values in
    [0, 2^32), as `walk_bits` draws them), and `row_ids` is each entry's
    row (np.repeat(arange(N), degrees)). Afterwards out[indptr[u] + j] is
    the j-th element of a uniform random permutation of u's row; with
    the JAX package's keys (jax.random.bits of its key) the result is
    its `shuffle_csr_rows`' exactly."""
    key = (row_ids.to(torch.int64) << 32) | u32(rand)
    order = torch.sort(key, stable=True).indices
    return indices[order]


# edges a step of the table build gathers: its transient beyond the tables
TABLE_CHUNK = 1 << 23


def build_walk_tables(indptr: torch.Tensor, indices: torch.Tensor,
                      shuffled_indices: torch.Tensor):
    """Edge tables for the one-gather-per-step walk, int32 [E, 3] (the JAX
    package's words):

    etab[j] = (indices[j],  start[indices[j]],  deg[indices[j]])
    stab[j] = (shuffled[j], start[shuffled[j]], deg[shuffled[j]])

    Both are written in place, TABLE_CHUNK edges at a time, so that the
    build needs the two tables, the [N, 2] (start, deg) rows and one
    chunk's gather.
    """
    start_deg = torch.stack([indptr[:-1], indptr[1:] - indptr[:-1]],
                            dim=-1).to(torch.int32)
    etab = torch.empty(indices.shape[0], 3, dtype=torch.int32,
                       device=indices.device)
    stab = torch.empty_like(etab)
    chunk = TABLE_CHUNK
    for lo in range(0, indices.shape[0], chunk):
        for tab, col in ((etab, indices), (stab, shuffled_indices)):
            ids = col[lo:lo + chunk]
            tab[lo:lo + chunk, 0] = ids
            tab[lo:lo + chunk, 1:] = start_deg[ids]
    return etab, stab


# folded into a block key for the with-replacement first hop's draw
FIRST_HOP_FOLD = 0x5EED


def walk_bits(key: prng.Key, num_seeds: int, num_walks: int,
              num_steps: int, device, row0: int = 0) -> torch.Tensor:
    """The 32-bit draws of the steps after the first hop: int64
    [num_steps - 1, num_seeds, num_walks] with values in [0, 2^32) on
    `device`, step t's the rows row0 .. row0 + num_seeds - 1 of
    `bits(split(key, num_steps - 1)[t], [*, num_walks])` (one launch of
    K8 a step on a CUDA device)."""
    out = torch.empty(max(num_steps - 1, 0), num_seeds, num_walks,
                      dtype=torch.int64, device=device)
    if num_steps > 1:
        for t, k in enumerate(prng.split(key, num_steps - 1)):
            threefry_bits(*k, row0 * num_walks, out[t])
    return out


def walk_block_tables(indptr: torch.Tensor, etab: torch.Tensor,
                      stab: torch.Tensor, seeds: torch.Tensor,
                      num_walks: int, num_steps: int,
                      bits: torch.Tensor) -> torch.Tensor:
    """Run `num_walks` walks of `num_steps` steps from each seed.

    The first hop takes the (m % deg)-th entry of the seed's shuffled row
    (without replacement, round robin when deg <= num_walks); later hops
    pick `bits[t] % deg` uniformly. Walkers on a degree-0 node stay.
    Returns int64 [B, num_walks, num_steps] node ids.
    """
    last = etab.shape[0] - 1
    seeds = seeds.to(torch.int64)
    start = indptr[seeds]
    deg = indptr[seeds + 1] - start
    m = torch.arange(num_walks, device=seeds.device)
    offs = m[None, :] % deg[:, None].clamp(min=1)
    # gather indices are clamped like XLA's: a degree-0 row's slot may sit
    # one past the end, and its value is discarded below
    row0 = stab[(start[:, None] + offs).clamp(max=last)]
    live0 = deg[:, None] > 0
    w0 = torch.where(live0, row0[..., 0], seeds[:, None])
    if num_steps == 1:
        return w0[:, :, None]

    # stuck walkers (deg-0 seed) carry d=0 and stay in place forever
    st = row0[..., 1]
    d = torch.where(live0, row0[..., 2], 0)
    cur = w0
    out = [w0]
    for t in range(num_steps - 1):
        pick = bits[t] % d.clamp(min=1)
        rowt = etab[(st + pick).clamp(max=last)]
        live = d > 0
        cur = torch.where(live, rowt[..., 0], cur)
        st = torch.where(live, rowt[..., 1], st)
        d = torch.where(live, rowt[..., 2], d)
        out.append(cur)
    return torch.stack(out, dim=-1)


def build_sets_packed_block(seeds: torch.Tensor, walks: torch.Tensor,
                            num_walks: int, num_steps: int, bucket: int
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor, torch.Tensor]:
    """Dedup each seed's visits into a sorted set and pack every slot's
    landing counts into a (hi, lo) key pair.

    Per-visit field contributions (1 << start_bit[col]) are prefix-summed
    along the node-sorted visit list; each set slot's key is the
    difference of the prefix sums at its segment's bounds. When a set has
    more than `bucket` distinct nodes, the smallest ids are kept and the
    rest of the counts dropped.

    Returns (nodes int32 [B, bucket] pad INT32_MAX, sizes int32 [B],
    hi, lo int32 bits [B, bucket]).
    """
    block = seeds.shape[0]
    dev = seeds.device
    visits = 1 + num_walks * num_steps
    _, starts, lead_bit = enc_field_layout(num_walks, num_steps)
    use_hi = lead_bit >= 32
    seeds = seeds.to(torch.int64)

    nodes = torch.cat([seeds[:, None],
                       walks.reshape(block, num_walks * num_steps)], dim=1)
    # sort visits by node, ties by visit position: (node, vpos) packed
    # into one int64 key sorts like a stable sort by node
    vbits = max((visits - 1).bit_length(), 1)
    vpos0 = torch.arange(visits, device=dev)
    spacked = torch.sort((nodes << vbits) | vpos0[None, :], dim=1).values
    snodes = spacked >> vbits
    svpos = spacked & ((1 << vbits) - 1)

    # position 0 is the root (col 0); positions 1.. are the flattened
    # [num_walks, num_steps] walk matrix -> col = (p-1) % S + 1
    scols = torch.where(svpos == 0, 0, (svpos - 1) % num_steps + 1)
    s_lo = torch.zeros_like(snodes)
    s_hi = torch.zeros_like(snodes) if use_hi else None
    for j in range(1, num_steps + 1):
        if starts[j] < 32:
            s_lo = torch.where(scols == j, 1 << starts[j], s_lo)
        else:
            s_hi = torch.where(scols == j, 1 << (starts[j] - 32), s_hi)

    first = torch.ones_like(snodes, dtype=torch.bool)
    first[:, 1:] = snodes[:, 1:] != snodes[:, :-1]
    n_uniq = first.sum(dim=1)
    sizes = n_uniq.clamp(max=bucket)

    # exclusive prefix sums of the contributions, modulo 2^32 like the
    # reference's uint32 cumsum (exact per segment: fields never overflow)
    pre_lo = torch.cumsum(s_lo, dim=1) & U32
    excl_lo = (pre_lo - s_lo) & U32
    if use_hi:
        pre_hi = torch.cumsum(s_hi, dim=1) & U32
        excl_hi = (pre_hi - s_hi) & U32

    # compaction: segment starts to the front in node order, carrying
    # each start's exclusive prefix
    key2 = torch.where(first, snodes, INT32_MAX)
    k2, order = torch.sort(key2, dim=1, stable=True)
    p_lo = torch.gather(excl_lo, 1, order)
    p_hi = torch.gather(excl_hi, 1, order) if use_hi else None
    if visits < bucket:
        padw = bucket - visits
        k2 = torch.cat([k2, k2.new_full((block, padw), INT32_MAX)], dim=1)
        p_lo = torch.cat([p_lo, p_lo.new_zeros(block, padw)], dim=1)
        if use_hi:
            p_hi = torch.cat([p_hi, p_hi.new_zeros(block, padw)], dim=1)
    # next-start prefixes taken BEFORE truncation: a truncated row's last
    # kept slot ends where the first dropped segment starts
    if p_lo.shape[1] > bucket:
        next_lo = p_lo[:, 1:bucket + 1]
        next_hi = p_hi[:, 1:bucket + 1] if use_hi else None
    else:
        next_lo = torch.cat([p_lo[:, 1:], pre_lo[:, -1:]], dim=1)
        next_hi = (torch.cat([p_hi[:, 1:], pre_hi[:, -1:]], dim=1)
                   if use_hi else None)
    nodes_out = k2[:, :bucket]
    p_lo = p_lo[:, :bucket]

    slots = torch.arange(bucket, device=dev)
    valid = slots[None, :] < sizes[:, None]
    nodes_out = torch.where(valid, nodes_out, INT32_MAX)

    # the last real slot of an untruncated row ends at the visit total
    is_last_untrunc = ((slots[None, :] == sizes[:, None] - 1)
                       & (n_uniq <= bucket)[:, None])
    next_lo = torch.where(is_last_untrunc, pre_lo[:, -1:], next_lo)
    lo_keys = torch.where(valid, (next_lo - p_lo) & U32, 0)

    is_root = (nodes_out == seeds[:, None]).to(torch.int64)
    if use_hi:
        p_hi = p_hi[:, :bucket]
        next_hi = torch.where(is_last_untrunc, pre_hi[:, -1:], next_hi)
        hi_keys = torch.where(valid, (next_hi - p_hi) & U32, 0)
        hi_keys = hi_keys | (is_root << (lead_bit - 32))
        hi_keys = torch.where(valid, hi_keys, 0)
    else:
        hi_keys = torch.zeros_like(lo_keys)
    if lead_bit < 32:
        lo_keys = lo_keys | (is_root << lead_bit)
    lo_keys = torch.where(valid, lo_keys, 0)
    return (nodes_out.to(torch.int32), sizes.to(torch.int32),
            to_bits(hi_keys), to_bits(lo_keys))


def sample_block(indptr: torch.Tensor, etab: torch.Tensor,
                 stab: torch.Tensor, seeds: torch.Tensor, *,
                 num_walks: int, num_steps: int, bucket: int,
                 key: prng.Key):
    """Per-block pipeline: walk bits from the block `key` -> walks ->
    sets -> packed keys (the JAX package's `sample_block` over the
    edge tables).

    Returns (nodes [B, bucket], sizes [B], hi [B, bucket], lo [B, bucket]).
    """
    with span("surel.sample.walk"):
        bits = walk_bits(key, seeds.shape[0], num_walks, num_steps,
                         seeds.device)
        walks = walk_block_tables(indptr, etab, stab, seeds, num_walks,
                                  num_steps, bits)
    with span("surel.sample.sets"):
        return build_sets_packed_block(seeds, walks, num_walks, num_steps,
                                       bucket)


# ------------------------------------------------------------ the legacy walk
# The SUREL-v1 surface (ops/legacy.py): walks over the CSR arrays without
# the edge tables, optionally with a with-replacement first hop, and the
# landing counts as [B, bucket, S+1] count rows rather than packed keys.

def rows_searchsorted(a: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Row-wise lower bound: the first index where a[b, i] >= t[b, j].

    a: [B, N] rows sorted ascending; t: [B, T] -> int64 [B, T] in [0, N].
    """
    return torch.searchsorted(a.contiguous(), t.to(a.dtype).contiguous())


def walk_block(indptr: torch.Tensor, indices: torch.Tensor,
               shuffled_indices: torch.Tensor, seeds: torch.Tensor,
               num_walks: int, num_steps: int, key: prng.Key,
               replacement: bool = False) -> torch.Tensor:
    """Run `num_walks` walks of `num_steps` steps from each seed, reading
    the CSR arrays at every step (the JAX package's `_walk_block`).

    With `replacement` the first hop takes bits(fold_in(key, 0x5eed),
    [B, M])[b, m] % deg (uniform: the SUREL-v1 `random_walk`), else the
    (m % deg)-th entry of the seed's shuffled row (without replacement).
    Later hops pick `walk_bits(key)[t] % deg`. Walkers on a degree-0 node
    stay.
    Returns int64 [B, num_walks, num_steps] node ids.
    """
    last = indices.shape[0] - 1
    seeds = seeds.to(torch.int64)
    start = indptr[seeds]
    deg = indptr[seeds + 1] - start
    bits = walk_bits(key, seeds.shape[0], num_walks, num_steps,
                     seeds.device)
    if replacement:
        first_bits = prng.bits(prng.fold_in(key, FIRST_HOP_FOLD),
                               (seeds.shape[0], num_walks), seeds.device)
        offs = first_bits % deg[:, None].clamp(min=1)
        row = indices
    else:
        m = torch.arange(num_walks, device=seeds.device)
        offs = m[None, :] % deg[:, None].clamp(min=1)
        row = shuffled_indices
    # gather indices clamped like XLA's: a degree-0 row's slot may sit one
    # past the end, and its value is discarded
    w0 = row[(start[:, None] + offs).clamp(max=last)]
    cur = torch.where(deg[:, None] > 0, w0, seeds[:, None])
    out = [cur]
    for t in range(num_steps - 1):
        st = indptr[cur]
        d = indptr[cur + 1] - st
        nxt = indices[(st + bits[t] % d.clamp(min=1)).clamp(max=last)]
        cur = torch.where(d > 0, nxt, cur)
        out.append(cur)
    return torch.stack(out, dim=-1)


def build_sets_block(seeds: torch.Tensor, walks: torch.Tensor,
                     num_walks: int, num_steps: int, bucket: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dedup each seed's visits and count its landings by step.

    walks: [B, M, S] (no root column). Returns
      nodes:  int64 [B, bucket] the distinct visited nodes ascending,
              padded with INT32_MAX;
      counts: int64 [B, bucket, S+1] landing counts a step, column 0
              num_walks at the root's slot and 0 elsewhere;
      sizes:  int64 [B] set sizes (at least 1: the root).
    A set of more than `bucket` nodes keeps the `bucket` smallest ids.
    """
    block = seeds.shape[0]
    dev = seeds.device
    ncol = num_steps + 1
    visits = 1 + num_walks * num_steps
    seeds = seeds.to(torch.int64)
    nodes = torch.cat([seeds[:, None],
                       walks.reshape(block, -1).to(torch.int64)], dim=1)
    cols = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                      torch.arange(1, ncol, device=dev).repeat(num_walks)])
    # visits sorted by (node, column) in one int64 key
    skey = torch.sort(nodes * ncol + cols[None, :], dim=1).values
    snodes, scols = skey // ncol, skey % ncol

    first = torch.ones_like(snodes, dtype=torch.bool)
    first[:, 1:] = snodes[:, 1:] != snodes[:, :-1]
    compact = torch.cumsum(first, dim=1) - 1
    sizes = (compact[:, -1] + 1).clamp(max=bucket)

    # slot s's node sits at the first visit of compact value s
    slots = torch.arange(bucket, device=dev)
    pos = rows_searchsorted(compact, slots.expand(block, bucket))
    nodes_out = torch.gather(snodes, 1, pos.clamp(max=visits - 1))
    valid = slots[None, :] < sizes[:, None]
    nodes_out = torch.where(valid, nodes_out, INT32_MAX)

    # the visits of (slot, column) d lie between the lower bounds of d and
    # d + 1 in the sorted dense keys; slots past the bucket fall outside
    dkey = compact * ncol + scols
    targets = torch.arange(bucket * ncol + 1, device=dev)
    bounds = rows_searchsorted(dkey, targets.expand(block, -1))
    counts = (bounds[:, 1:] - bounds[:, :-1]).reshape(block, bucket, ncol)

    # the root's one column-0 visit weighs num_walks (subg_acc.c:751)
    root_slot = rows_searchsorted(nodes_out, seeds[:, None])[:, 0]
    counts[:, :, 0] += (num_walks - 1) * (slots[None, :]
                                          == root_slot[:, None])
    return nodes_out, counts, sizes


def walk_block_with_rpe(indptr: torch.Tensor, indices: torch.Tensor,
                        shuffled_indices: torch.Tensor, seeds: torch.Tensor,
                        key: prng.Key, *, num_walks: int, num_steps: int,
                        bucket: int, replacement: bool = True):
    """The SUREL-v1 surface (the C `walk_sampler` and `rpe_encoder`,
    subg_acc.c:316-389, 249-314): raw walks from the block `key` and each
    seed's relative positional encoding. Returns (walks [B, M, S+1] with
    the root at position 0, nodes [B, bucket], counts [B, bucket, S+1],
    sizes [B])."""
    steps = walk_block(indptr, indices, shuffled_indices, seeds, num_walks,
                       num_steps, key, replacement)
    root = seeds.to(torch.int64)[:, None, None].expand(*steps.shape[:2], 1)
    nodes, counts, sizes = build_sets_block(seeds, steps, num_walks,
                                            num_steps, bucket)
    return torch.cat([root, steps], dim=-1), nodes, counts, sizes
