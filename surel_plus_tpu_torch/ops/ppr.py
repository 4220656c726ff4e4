"""Top-k personalized PageRank sets (port of surel_plus_tpu/ops/ppr.py).

`ppr_topk` runs the Andersen push on the host: `csrc/ppr_host.cpp` (C++
and OpenMP, parallel over seeds), built with the host compiler at first
use into the package's `_build/` and loaded with ctypes. A failed build
raises with the compiler's output. `ppr_push_plain` is the same push as
a Python loop, the plain version the tests hold the library to.
`topk_ppr_matrix` gives the reference's sparse [len(idx), N] matrix of
the top-k scores with its 'row' / 'sym' / 'col' degree normalizations
(pprgo.py:83-111), from the host push or the device power iteration
(`ops/ppr_device.py`).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from surel_plus_tpu_torch.ops.kernels.build import (
    BUILD_DIR,
    CSRC,
    host_library as build_host_library,
)

SOURCE = CSRC / "ppr_host.cpp"

_LIB = None


def host_library() -> ctypes.CDLL:
    """The push library, built on first use (`build.host_library`); raises
    RuntimeError with the compiler's output if the build fails."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build_host_library(SOURCE, BUILD_DIR)))
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.ppr_topk.restype = None
    lib.ppr_topk.argtypes = [
        i32p, i32p, ctypes.c_int32, i32p, ctypes.c_int32, ctypes.c_float,
        ctypes.c_float, ctypes.c_int32, ctypes.c_int32, i32p,
        ctypes.POINTER(ctypes.c_float), i32p]
    lib.ppr_num_threads.restype = ctypes.c_int32
    lib.ppr_num_threads.argtypes = []
    _LIB = lib
    return lib


def num_threads() -> int:
    """The threads the host push runs on when not told (OpenMP's count)."""
    return int(host_library().ppr_num_threads())


def ppr_push_plain(indptr, indices, seeds, alpha, eps, topk):
    """The push of `ppr_topk` as a per-seed Python loop over dicts (the
    JAX package's `_ppr_push_numpy`): slow, for tests and toy graphs."""
    deg = np.diff(indptr)
    out_nodes = np.zeros((len(seeds), topk), np.int32)
    out_scores = np.zeros((len(seeds), topk), np.float32)
    out_count = np.zeros(len(seeds), np.int32)
    for s, seed in enumerate(seeds):
        p = {}
        r = {int(seed): alpha}
        frontier = [int(seed)]
        while frontier:
            u = frontier.pop()
            res = r.get(u, 0.0)
            if res == 0.0:
                continue
            p[u] = p.get(u, 0.0) + res
            r[u] = 0.0
            du = deg[u]
            if du == 0:
                continue
            push = (1 - alpha) * res / du
            for v in indices[indptr[u]:indptr[u + 1]]:
                v = int(v)
                r[v] = r.get(v, 0.0) + push
                if r[v] >= alpha * eps * deg[v] and v not in frontier:
                    frontier.append(v)
        items = sorted(p.items(), key=lambda kv: -kv[1])[:topk]
        out_count[s] = len(items)
        for i, (v, val) in enumerate(items):
            out_nodes[s, i] = v
            out_scores[s, i] = val
    return out_nodes, out_scores, out_count


def ppr_topk(indptr: np.ndarray, indices: np.ndarray, seeds: np.ndarray,
             alpha: float, eps: float, topk: int, nthreads: int = -1
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The host push for each seed: (nodes [S, topk] int32, scores
    [S, topk] float32 descending, counts [S] int32); `nthreads` <= 0
    runs on OpenMP's default count."""
    indptr = np.ascontiguousarray(indptr, np.int32)
    indices = np.ascontiguousarray(indices, np.int32)
    seeds = np.ascontiguousarray(seeds, np.int32)
    lib = host_library()
    n = len(indptr) - 1
    out_nodes = np.zeros((len(seeds), topk), np.int32)
    out_scores = np.zeros((len(seeds), topk), np.float32)
    out_count = np.zeros(len(seeds), np.int32)
    i32p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    f32p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    lib.ppr_topk(i32p(indptr), i32p(indices), n, i32p(seeds),
                 len(seeds), alpha, eps, topk, nthreads,
                 i32p(out_nodes), f32p(out_scores), i32p(out_count))
    return out_nodes, out_scores, out_count


def topk_ppr_matrix(graph, alpha: float, eps: float, idx: np.ndarray,
                    topk: int, normalization: str = "row",
                    nthreads: int = -1, method: str = "host",
                    device="cuda"):
    """scipy.sparse.csr_matrix [len(idx), N] of the top-k PPR scores of
    each seed in `idx` (pprgo.py:83-111), normalized by degree: 'row'
    (as pushed), 'sym' (d_seed^1/2 s / d_node^1/2) or 'col'
    (d_seed s / d_node). method "host": the push (`ppr_topk`); "device":
    the truncated power iteration on `device` (`ppr_topk_device`)."""
    import scipy.sparse as sp

    if method == "device":
        from surel_plus_tpu_torch.ops.ppr_device import ppr_topk_device

        nodes, scores, counts = ppr_topk_device(
            graph.indptr, graph.indices, np.asarray(idx, np.int32),
            alpha, eps, topk, device=device)
    elif method == "host":
        nodes, scores, counts = ppr_topk(graph.indptr, graph.indices,
                                         np.asarray(idx, np.int32), alpha,
                                         eps, topk, nthreads)
    else:
        raise ValueError(f"unknown PPR method {method!r}")
    n = graph.num_nodes
    rows = np.repeat(np.arange(len(idx)), counts)
    valid = np.arange(topk)[None, :] < counts[:, None]
    cols = nodes[valid]
    vals = scores[valid].astype(np.float64)

    deg = np.asarray(graph.to_scipy().sum(1)).ravel()
    if normalization == "sym":
        deg_sqrt = np.sqrt(np.maximum(deg, 1e-12))
        vals = deg_sqrt[np.asarray(idx)[rows]] * vals / deg_sqrt[cols]
    elif normalization == "col":
        vals = deg[np.asarray(idx)[rows]] * vals / np.maximum(deg[cols],
                                                              1e-12)
    elif normalization != "row":
        raise ValueError(f"Unknown PPR normalization: {normalization}")
    return sp.csr_matrix((vals, (rows, cols)), shape=(len(idx), n))
