"""The SUREL-v1 legacy API (port of surel_plus_tpu/ops/legacy.py).

The reference's C extension exports four functions beyond the SUREL+ set
sampler; two drive the legacy walk pipeline, two are exposed but unused
(SURVEY.md §2.1):

  walk_sampler  (subg_acc.c:316-389)  raw walks + each seed's RPE
  rpe_encoder   (subg_acc.c:249-314)  folded into walk_sampler's outputs
  rw_matrix     (random_walks.py:56-71) the sets' matrix of deduplicated
                                        RPE rows
  np_sampling   (random_walks.py:35-45) walk_sampler over seed batches
  batch_sampler (subg_acc.c:391-507)  the union node set of a query batch
  walk_join     (subg_acc.c:509-647)  each query's walk-slot index pairs

The walks and the sets run on a torch device (`walk.walk_block_with_rpe`,
the walk bits from the JAX package's key tree: block b of `walk_sampler`
walks from `fold_in(prng_key(seed), b + 1)`, `batch_sampler` from
`fold_in(prng_key(seed), 1)`, so a seed gives JAX's walks), as does
`walk_join` (row sorts, a cumsum and a row-wise search). The host keeps
what the JAX package keeps there: the dedup of count rows and the scipy
matrix of `rw_matrix`, and the union of `batch_sampler`.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np
import torch

from surel_plus_tpu_torch.graph.csr import CSRGraph
from surel_plus_tpu_torch.ops import prng
from surel_plus_tpu_torch.ops import walk as walk_ops
from surel_plus_tpu_torch.ops.sampler import (
    device_graph,
    shuffled_indices_for,
)

log = logging.getLogger(__name__)


def gen_batch(iterable, n: int = 1, keep: bool = False):
    """Batch iterator (the reference's random_walks.py:25-32: `keep` keeps
    the last, partial batch)."""
    length = len(iterable)
    stop = length if keep else length - n
    for ndx in range(0, stop, n):
        yield iterable[ndx:min(ndx + n, length)]


def walk_sampler(graph: CSRGraph, seeds: np.ndarray, num_walks: int = 100,
                 num_steps: int = 3, replacement: bool = True,
                 seed: int = 111413, bucket: Optional[int] = None,
                 block_size: int = 65536, device="cuda"):
    """Raw random walks with relative positional encodings.

    Returns (walks [n, num_walks*(num_steps+1)] int32, the root at each
    walk's position 0, and (nodes [n, L], counts [n, L, S+1], sizes [n])
    int32, the padded RPE arrays), on the host. `replacement=False` takes
    the without-replacement first hop (the C `random_walk_wo`,
    subg_acc.c:183-247). Seeds run in blocks of `block_size`.
    """
    seeds = np.asarray(seeds, dtype=np.int32)
    n = len(seeds)
    if bucket is None:
        bucket = num_walks * num_steps + 1
    indptr, indices = device_graph(graph, device)
    shuffled = (indices if replacement
                else shuffled_indices_for(graph, seed, device))
    root = prng.prng_key(seed)
    seeds_dev = torch.as_tensor(seeds, dtype=torch.int64).to(indptr.device)

    parts = [walk_ops.walk_block_with_rpe(
        indptr, indices, shuffled, seeds_dev[lo:lo + block_size],
        prng.fold_in(root, b + 1), num_walks=num_walks,
        num_steps=num_steps, bucket=bucket, replacement=replacement)
        for b, lo in enumerate(range(0, n, block_size))]
    walks, nodes, counts, sizes = (
        torch.cat(x).to(torch.int32).cpu().numpy() for x in zip(*parts))
    return walks.reshape(n, -1), (nodes, counts, sizes)


def np_sampling(graph: CSRGraph, seeds: np.ndarray, bsize: int,
                num_walks: int = 200, num_steps: int = 4,
                seed: int = 111413, device="cuda"):
    """walk_sampler over batches of `bsize` seeds (random_walks.py:35-45):
    the sets' nodes and their count rows, concatenated over seeds, and the
    set sizes."""
    _, (nodes, counts, sizes) = walk_sampler(
        graph, seeds, num_walks=num_walks, num_steps=num_steps,
        replacement=True, seed=seed, block_size=bsize, device=device)
    valid = np.arange(nodes.shape[1])[None, :] < sizes[:, None]
    return nodes[valid], counts[valid], sizes


def rw_matrix(graph: CSRGraph, seeds: np.ndarray, num_walks: int = 200,
              num_steps: int = 4, seed: int = 111413,
              reduced: bool = True, device="cuda"):
    """The legacy sets' matrix (random_walks.py:56-71): walks with
    replacement at the first hop, count rows deduplicated whole (the
    fastremap radix projection), 1-based values, a zero row prepended.
    The CLI convention: num_steps=S means walks of S-1 steps. Returns
    (z scipy CSR [N, N], freqs [R+1, S])."""
    import scipy.sparse as sp

    keys, freqs, sizes = np_sampling(graph, seeds, bsize=65536,
                                     num_walks=num_walks,
                                     num_steps=num_steps - 1, seed=seed,
                                     device=device)
    gsize = graph.num_nodes
    if reduced:
        # a count is at most num_walks, so the (num_walks+1)-radix
        # projection of a row is an exact key
        proj = np.array([(num_walks + 1) ** i
                         for i in reversed(range(num_steps))],
                        dtype=np.int64)
        idy = freqs.astype(np.int64) @ proj
        uniq, inv = np.unique(idy, return_inverse=True)
        # each key's first row (the JAX package's minimum starts from 0,
        # so its table repeats row 0 for every key)
        first = np.full(len(uniq), len(idy), dtype=np.int64)
        np.minimum.at(first, inv, np.arange(len(idy)))
        freqs = freqs[first]
        idy = inv.astype(np.int64)
    else:
        idy = np.arange(len(freqs), dtype=np.int64)
    rows = np.repeat(seeds, sizes.astype(np.int64))
    z = sp.csr_matrix((idy + 1, (rows, keys)), shape=(gsize, gsize))
    freqs = np.concatenate([np.zeros((1, num_steps), freqs.dtype), freqs])
    return z, freqs


def batch_sampler(graph: CSRGraph, query_nodes: np.ndarray,
                  num_walks: int = 100, num_steps: int = 3,
                  seed: int = 111413, thld: Optional[int] = None,
                  device="cuda"):
    """The union node set of a query batch under a budget (the C
    batch_sampler, subg_acc.c:391-507): walks from every seed (without
    replacement at the first hop), one deduplicated union cut to `thld`
    nodes (by default num_walks*num_steps+1 a seed). Returns (the union
    ascending, the walks [n, M, S]) on the host."""
    query_nodes = np.asarray(query_nodes, dtype=np.int32)
    if thld is None:
        thld = (num_walks * num_steps + 1) * len(query_nodes)
    indptr, indices = device_graph(graph, device)
    shuffled = shuffled_indices_for(graph, seed, device)
    q = torch.as_tensor(query_nodes, dtype=torch.int64).to(indptr.device)
    walks = walk_ops.walk_block(indptr, indices, shuffled, q, num_walks,
                                num_steps, prng.fold_in(prng.prng_key(seed),
                                                        1))
    walks = walks.to(torch.int32).cpu().numpy()
    union = np.unique(np.concatenate([query_nodes, walks.ravel()]))
    if len(union) > thld:
        log.warning("batch_sampler: union %d exceeds budget %d; truncating",
                    len(union), thld)
        union = union[:thld]
    return union, walks


def walk_join_device(walks: torch.Tensor, queries: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """walk_join on the device: row sorts, the dedup rank by a cumsum and
    a row-wise search.

    walks [n, W]; queries [2, B] row ids -> (left, right) int64 [B, W]:
    each walk slot's 1-based index into the partner's distinct nodes
    (0 = absent), in the walk-slot order."""
    sw = torch.sort(walks, dim=1).values
    first = torch.ones_like(sw, dtype=torch.bool)
    first[:, 1:] = sw[:, 1:] != sw[:, :-1]
    rank = torch.cumsum(first, dim=1)

    def side(qa, qb):
        wa, swb = walks[qa], sw[qb]
        cpos = walk_ops.rows_searchsorted(swb, wa).clamp(
            max=swb.shape[1] - 1)
        hit = torch.gather(swb, 1, cpos) == wa
        return torch.where(hit, torch.gather(rank[qb], 1, cpos), 0)

    return side(queries[0], queries[1]), side(queries[1], queries[0])


def walk_join(walks: np.ndarray, seeds: np.ndarray, queries: np.ndarray,
              device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """The SUREL-v1 online join (the C walk_join, subg_acc.c:509-647): for
    each query (u, v), map every node slot of u's walks to its index in
    v's distinct nodes (0 if absent), and v's to u's.

    walks: [n, M*(S+1)] raw walks of `seeds`; queries: [2, B] row ids of
    them. Returns (left [B, W], right [B, W]) int32 on the host."""
    w = torch.as_tensor(np.asarray(walks), dtype=torch.int64).to(device)
    q = torch.as_tensor(np.asarray(queries), dtype=torch.int64).to(device)
    left, right = walk_join_device(w, q)
    return (left.to(torch.int32).cpu().numpy(),
            right.to(torch.int32).cpu().numpy())
