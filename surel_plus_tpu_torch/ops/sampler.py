"""Set sampling (port of surel_plus_tpu/ops/sampler.py): the packed-key
store, and the encoding-table stores with the global encoding dedup.

Every sampler walks on a torch device with `walk.sample_block`, over
the seeds in blocks of `block_size`, and draws from the JAX package's key
tree: root = `prng_key(seed)`, block b's key `fold_in(root, b + 1)`. So
the same seed gives the JAX package's sets bit for bit, and the table
samplers' nodes and sizes equal the keys sampler's. JAX pads the last
block to `block_size` seeds; a draw depends only on its flat index, so
the real rows' draws are a prefix of the padded block's, and the port
walks the real rows alone. The dedup turns each valid slot's
packed key into a 1-based index of a sorted table of the unique keys'
encodings: on the device (`sample_gsets_device`) by one `torch.unique`
over the valid slots' 64-bit keys, on the host (`sample_gsets`) by
`np.unique`. The JAX package's 2-D merge tree of row sorts
(`_dedup_device_tree`) exists because a TPU sorts 1-D arrays serially; a
CUDA sort does not, and the one sort gives the same table and indices.

Conventions follow the reference CLI: `num_steps` is the walk step count
S'; the encoding has S'+1 columns.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np
import torch

from surel_plus_tpu_torch.graph.csr import CSRGraph, check_int32_edges
from surel_plus_tpu_torch.graph.native import shuffle_rows_native
from surel_plus_tpu_torch.ops import prng
from surel_plus_tpu_torch.ops import walk as walk_ops
from surel_plus_tpu_torch.ops.join import unpack_key_features
from surel_plus_tpu_torch.spg.spg import SpG, SpGDevice, SpGKeys

log = logging.getLogger(__name__)

DEFAULT_BLOCK = 65536


def _cache(graph: CSRGraph) -> dict:
    """Per-graph cache of device arrays, kept on the (frozen) graph object
    itself so it lives exactly as long as the graph."""
    cache = getattr(graph, "_device_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(graph, "_device_cache", cache)
    return cache


def device_graph(graph: CSRGraph, device):
    """(indptr, indices) int32 on `device` (`CSRGraph.to`), uploaded once
    per graph."""
    device = torch.device(device)
    cache = _cache(graph)
    key = ("csr", str(device))
    if key not in cache:
        cache[key] = graph.to(device)
    return cache[key]


def shuffled_indices_for(graph: CSRGraph, seed: int, device):
    """Per-row random permutation of the CSR indices, computed on the host
    by the native per-row Fisher-Yates shuffle (`native.shuffle_rows_native`,
    the JAX package's first-hop source: the same rows for the same seed)
    and uploaded as int32 once per (graph, seed, device)."""
    device = torch.device(device)
    cache = _cache(graph)
    key = ("shuffle", seed, str(device))
    if key not in cache:
        check_int32_edges(graph.num_edges)
        cache[key] = torch.from_numpy(shuffle_rows_native(graph, seed)).to(
            device)
    return cache[key]


def walk_tables_for(graph: CSRGraph, seed: int, device):
    """Edge-table pair (`walk.build_walk_tables`, int32 [E, 3] each),
    cached per (graph, shuffle seed, device)."""
    device = torch.device(device)
    cache = _cache(graph)
    key = ("walk_tables", seed, str(device))
    if key not in cache:
        indptr, indices = device_graph(graph, device)
        shuffled = shuffled_indices_for(graph, seed, device)
        cache[key] = walk_ops.build_walk_tables(indptr, indices, shuffled)
    return cache[key]


def cached_graph_bytes(graph: CSRGraph, device) -> dict:
    """Device bytes of `graph`'s cached tensors on `device`: by kind, "csr"
    (indptr and indices), "indptr" (its share of "csr"), "shuffle" and
    "walk_tables" (summed over the cached shuffle seeds); their "total";
    and "per_edge", the bytes a directed edge beside indptr."""
    out = {"csr": 0, "indptr": 0, "shuffle": 0, "walk_tables": 0}
    for key, val in _cache(graph).items():
        if key[-1] != str(torch.device(device)):
            continue
        tensors = val if isinstance(val, tuple) else (val,)
        out[key[0]] += sum(t.numel() * t.element_size() for t in tensors)
        if key[0] == "csr":
            out["indptr"] += tensors[0].numel() * tensors[0].element_size()
    out["total"] = out["csr"] + out["shuffle"] + out["walk_tables"]
    out["per_edge"] = (out["total"] - out["indptr"]) / max(graph.num_edges,
                                                           1)
    return out


def sample_gsets_device_keys(
    graph: CSRGraph,
    seeds: np.ndarray,
    num_walks: int,
    num_steps: int,
    seed: int = 111413,
    bucket: Optional[int] = None,
    block_size: int = DEFAULT_BLOCK,
    shuffle_seed: Optional[int] = None,
    device="cuda",
) -> SpGKeys:
    """Sample one set per seed and store each slot's packed landing-count
    key. Seeds run in blocks of `block_size`, block b's walk bits drawn
    from `fold_in(prng_key(seed), b + 1)`; the first-hop row shuffle is
    the native shuffle with `shuffle_seed` (default: `seed`). The JAX
    package's sets from the same arguments, bit for bit.

    Returns SpGKeys(nodes, khi, klo, sizes) on `device`.
    """
    if graph.num_edges == 0:
        raise ValueError("sampling needs a graph with at least one edge")
    device = torch.device(device)
    seeds = torch.as_tensor(np.asarray(seeds, dtype=np.int64)).to(device)
    n = seeds.shape[0]
    if bucket is None:
        bucket = num_walks * num_steps + 1
    walk_ops.enc_field_layout(num_walks, num_steps)  # validate bit budget

    t0 = time.time()
    indptr, _ = device_graph(graph, device)
    sseed = seed if shuffle_seed is None else shuffle_seed
    etab, stab = walk_tables_for(graph, sseed, device)
    root = prng.prng_key(seed)

    parts = [walk_ops.sample_block(
        indptr, etab, stab, seeds[lo:lo + block_size],
        num_walks=num_walks, num_steps=num_steps, bucket=bucket,
        key=prng.fold_in(root, b + 1))
        for b, lo in enumerate(range(0, n, block_size))]
    nodes, sizes, hi, lo = (torch.cat(x) for x in zip(*parts))
    log.info("sample_gsets_device_keys: n=%d bucket=%d dispatched %.2fs",
             n, bucket, time.time() - t0)
    return SpGKeys(nodes=nodes, khi=hi, klo=lo, sizes=sizes,
                   num_walks=num_walks, num_steps=num_steps)


def table_width(u: int, n: int, bucket: int, enc_width: int = 4096) -> int:
    """Rows (less the zero row) of the device encoding table for u unique
    encodings among n sets of `bucket` slots: the JAX package's widening
    outcome, the first of min(max(enc_width, bucket), n * bucket) * 4^k
    (capped at n * bucket) that holds u. Its merge tree overflows exactly
    when u exceeds the width."""
    hard_cap = n * bucket
    width = min(max(enc_width, bucket), hard_cap)
    while u > width:
        width = min(width * 4, hard_cap)
    return width


def _unpack_enc_device(uniq: torch.Tensor, width: int, num_walks: int,
                       num_steps: int) -> torch.Tensor:
    """The normalized encoding table [width + 1, num_steps + 1] float32 of
    the sorted unique keys `uniq` (int64 hi << 32 | lo): the zero row, one
    row per key (column 0 = root * num_walks, then the step counts, all
    divided by num_walks), zero rows past the unique count."""
    enc = torch.zeros(width + 1, num_steps + 1, dtype=torch.float32,
                      device=uniq.device)
    enc[1:uniq.shape[0] + 1] = unpack_key_features(
        walk_ops.to_bits(uniq >> 32), walk_ops.to_bits(uniq & walk_ops.U32),
        num_walks, num_steps)
    return enc


def dedup_device(sizes: torch.Tensor, khi: torch.Tensor, klo: torch.Tensor,
                 num_walks: int, num_steps: int, enc_width: int = 4096,
                 max_enc_width: int = 1 << 16):
    """Global encoding dedup on the sets' device: (eidx int32 [n, L], enc
    float32 [width + 1, ncol], u). Only the valid slots' keys are sorted
    (key hi << 32 | lo as int64: under 2^62 by `enc_field_layout`, so the
    signed order is the unsigned one), so no sentinel enters the table; a
    padded slot gets index 0. Reads the unique count on the host, as the
    JAX package does."""
    n, bucket = khi.shape
    valid = (torch.arange(bucket, device=khi.device)[None, :]
             < sizes[:, None])
    keys = (walk_ops.u32(khi) << 32) | walk_ops.u32(klo)
    uniq, inverse = torch.unique(keys[valid], return_inverse=True)
    eidx = torch.zeros(n, bucket, dtype=torch.int32, device=khi.device)
    eidx[valid] = (inverse + 1).to(torch.int32)
    u = int(uniq.shape[0])
    width = table_width(u, n, bucket, enc_width)
    if width > max_enc_width:
        log.warning("dedup: %d unique encodings need a table of %d rows, "
                    "above max_enc_width %d (compression ratio < %.1f)", u,
                    width, max_enc_width, n * bucket / max(width, 1))
    return eidx, _unpack_enc_device(uniq, width, num_walks, num_steps), u


def sample_gsets_device(
    graph: CSRGraph,
    seeds: np.ndarray,
    num_walks: int,
    num_steps: int,
    seed: int = 111413,
    bucket: Optional[int] = None,
    block_size: int = DEFAULT_BLOCK,
    shuffle_seed: Optional[int] = None,
    enc_width: int = 4096,
    max_enc_width: int = 1 << 16,
    device="cuda",
):
    """Device-resident sampling with the global encoding dedup: the sets
    and the normalized encoding table stay on `device` (the host reads
    one scalar, the unique count). The walks are `sample_gsets_device_keys`'
    with the same arguments; `dedup_device` sizes the table as the JAX
    package's widening loop (`enc_width`, x4 on overflow; `max_enc_width`
    only warns). Returns (SpGDevice, u)."""
    t0 = time.time()
    spgk = sample_gsets_device_keys(
        graph, seeds, num_walks, num_steps, seed=seed, bucket=bucket,
        block_size=block_size, shuffle_seed=shuffle_seed, device=device)
    eidx, enc, u = dedup_device(spgk.sizes, spgk.khi, spgk.klo, num_walks,
                                num_steps, enc_width, max_enc_width)
    log.info("sample_gsets_device: n=%d enc_unique=%d width=%d dT=%.2fs",
             spgk.nodes.shape[0], u, enc.shape[0] - 1, time.time() - t0)
    return SpGDevice(nodes=spgk.nodes, eidx=eidx, sizes=spgk.sizes,
                     enc=enc), u


def sample_gsets(
    graph: CSRGraph,
    seeds: np.ndarray,
    num_walks: int,
    num_steps: int,
    seed: int = 111413,
    bucket: Optional[int] = None,
    block_size: int = DEFAULT_BLOCK,
    shuffle_seed: Optional[int] = None,
    device="cuda",
) -> SpG:
    """Sample node sets and landing-count encodings for `seeds` into a host
    SpG: the walks on `device` (as `sample_gsets_device_keys`), the global
    dedup in numpy (np.unique over the valid slots' 64-bit keys, then a
    searchsorted remap; sorted-key order, a relabeling of the reference's
    first-occurrence order, subg_acc.c:957-978)."""
    spgk = sample_gsets_device_keys(
        graph, seeds, num_walks, num_steps, seed=seed, bucket=bucket,
        block_size=block_size, shuffle_seed=shuffle_seed, device=device)
    nodes, sizes, hi, lo = (t.cpu().numpy() for t in (
        spgk.nodes, spgk.sizes, spgk.khi, spgk.klo))
    bucket = nodes.shape[1]
    packed = ((hi.view(np.uint32).astype(np.uint64) << np.uint64(32))
              | lo.view(np.uint32).astype(np.uint64))
    valid = np.arange(bucket, dtype=np.int32)[None, :] < sizes[:, None]
    flat = packed[valid]
    uniq = np.unique(flat)
    eidx = np.zeros(nodes.shape, dtype=np.int32)
    eidx[valid] = np.searchsorted(uniq, flat).astype(np.int32) + 1
    enc = np.concatenate([
        np.zeros((1, num_steps + 1), dtype=np.int32),
        walk_ops.unpack_encodings(uniq, num_walks, num_steps)])
    log.info("sample_gsets: #total %d; #enc_unique %d", int(sizes.sum()),
             len(uniq))
    return SpG(nodes=nodes, eidx=eidx, sizes=sizes, enc=enc,
               seeds=np.asarray(seeds, dtype=np.int32), num_walks=num_walks,
               num_steps=num_steps)


def subg_matrix_device_keys(graph: CSRGraph, seeds: np.ndarray,
                            num_walks: int = 200, num_steps: int = 4,
                            seed: int = 111413,
                            bucket: Optional[int] = None,
                            block_size: int = DEFAULT_BLOCK,
                            device="cuda") -> SpGKeys:
    """CLI-convention wrapper over sample_gsets_device_keys: walks have
    `num_steps - 1` steps."""
    return sample_gsets_device_keys(graph, seeds, num_walks, num_steps - 1,
                                    seed=seed, bucket=bucket,
                                    block_size=block_size, device=device)


def subg_matrix_device(graph: CSRGraph, seeds: np.ndarray,
                       num_walks: int = 200, num_steps: int = 4,
                       seed: int = 111413, bucket: Optional[int] = None,
                       block_size: int = DEFAULT_BLOCK, device="cuda"):
    """CLI-convention wrapper over sample_gsets_device: walks have
    `num_steps - 1` steps, encodings `num_steps` columns."""
    return sample_gsets_device(graph, seeds, num_walks, num_steps - 1,
                               seed=seed, bucket=bucket,
                               block_size=block_size, device=device)


def subg_matrix(graph: CSRGraph, seeds: np.ndarray, num_walks: int = 200,
                num_steps: int = 4, seed: int = 111413,
                bucket: Optional[int] = None,
                block_size: int = DEFAULT_BLOCK, device="cuda") -> SpG:
    """CLI-convention wrapper over sample_gsets (random_walks.py:74-82)."""
    return sample_gsets(graph, seeds, num_walks, num_steps - 1, seed=seed,
                        bucket=bucket, block_size=block_size, device=device)
