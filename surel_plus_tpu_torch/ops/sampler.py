"""Device-resident set sampling over packed keys (port of the keys path of
surel_plus_tpu/ops/sampler.py).

Conventions follow the reference CLI: `num_steps` is the walk step count
S'; the encoding has S'+1 columns.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np
import torch

from surel_plus_tpu_torch.graph.csr import CSRGraph
from surel_plus_tpu_torch.ops import walk as walk_ops
from surel_plus_tpu_torch.spg.spg import SpGKeys

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
    """(indptr, indices) int64 on `device`, uploaded once per graph."""
    device = torch.device(device)
    cache = _cache(graph)
    key = ("csr", str(device))
    if key not in cache:
        cache[key] = graph.to(device)
    return cache[key]


def shuffled_indices_for(graph: CSRGraph, seed: int, device):
    """Per-row random permutation of the CSR indices, computed on the host
    (np.lexsort over (row, rand)) and uploaded once per (graph, seed)."""
    device = torch.device(device)
    cache = _cache(graph)
    key = ("shuffle", seed, str(device))
    if key not in cache:
        rng = np.random.default_rng(seed)
        row_ids = np.repeat(np.arange(graph.num_nodes, dtype=np.int64),
                            graph.degrees().astype(np.int64))
        order = np.lexsort((rng.random(graph.num_edges), row_ids))
        shuffled = graph.indices[order]
        cache[key] = torch.as_tensor(shuffled, dtype=torch.int64).to(device)
    return cache[key]


def walk_tables_for(graph: CSRGraph, seed: int, device):
    """Edge-table pair (`walk.build_walk_tables`), cached per
    (graph, shuffle seed, device)."""
    device = torch.device(device)
    cache = _cache(graph)
    key = ("walk_tables", seed, str(device))
    if key not in cache:
        indptr, indices = device_graph(graph, device)
        shuffled = shuffled_indices_for(graph, seed, device)
        cache[key] = walk_ops.build_walk_tables(indptr, indices, shuffled)
    return cache[key]


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
    key. Walk bits come from a `torch.Generator` on `device` seeded with
    `seed`; the first-hop row shuffle from numpy with `shuffle_seed`
    (default: `seed`). Seeds run in blocks of `block_size`.

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
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    parts = [walk_ops.sample_block(
        indptr, etab, stab, seeds[lo:lo + block_size],
        num_walks=num_walks, num_steps=num_steps, bucket=bucket,
        generator=gen) for lo in range(0, n, block_size)]
    nodes, sizes, hi, lo = (torch.cat(x) for x in zip(*parts))
    log.info("sample_gsets_device_keys: n=%d bucket=%d dispatched %.2fs",
             n, bucket, time.time() - t0)
    return SpGKeys(nodes=nodes, khi=hi, klo=lo, sizes=sizes,
                   num_walks=num_walks, num_steps=num_steps)
