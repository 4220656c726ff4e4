"""Native (C++/OpenMP) graph ingest (port of surel_plus_tpu/graph/native.py
over `csrc/graphkit.cpp`, a copy of the JAX package's
`native/graphkit.cpp`): the O(E) counting-sort CSR builds and the per-row
Fisher-Yates shuffle.

The library builds with g++ at first use into the package's `_build/`
(`ops/kernels/build.py:host_library`) and is loaded with ctypes. A failed
build raises with the compiler's output; there is no numpy fallback. The
shuffle is deterministic C++: row i draws from one `std::mt19937_64`
seeded `seed * 0x9E3779B97F4A7C15 + i`, so it equals the JAX package's
row for row (its sampler takes this shuffle wherever g++ is present).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from surel_plus_tpu_torch.graph.csr import CSRGraph
from surel_plus_tpu_torch.ops.kernels.build import (
    BUILD_DIR,
    CSRC,
    host_library,
)

SOURCE = CSRC / "graphkit.cpp"

_LIB = None

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F32P = ctypes.POINTER(ctypes.c_float)


def native_lib() -> ctypes.CDLL:
    """The graphkit library, built on first use; raises RuntimeError with
    the compiler's output if the build fails."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(host_library(SOURCE, BUILD_DIR)))
    lib.build_csr.restype = ctypes.c_int64
    lib.build_csr.argtypes = [
        _I32P, _I32P, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, _I64P, _I32P]
    lib.build_csr_w.restype = ctypes.c_int64
    lib.build_csr_w.argtypes = [
        _I32P, _I32P, _F32P, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, _I64P, _I32P,
        _F32P]
    lib.shuffle_rows.restype = None
    lib.shuffle_rows.argtypes = [_I64P, _I32P, ctypes.c_int32,
                                 ctypes.c_uint64, _I32P]
    _LIB = lib
    return lib


def _p32(a: np.ndarray):
    return a.ctypes.data_as(_I32P)


def _p64(a: np.ndarray):
    return a.ctypes.data_as(_I64P)


def _endpoints(edges: np.ndarray, num_nodes: Optional[int]):
    """(src, dst) int32 contiguous columns of [E, 2] edges and the node
    count; raises ValueError where the int32 arrays cannot hold them."""
    edges = np.asarray(edges)
    if edges.ndim != 2 or edges.shape[1] != 2:
        raise ValueError(f"edges must be [E, 2], got {edges.shape}")
    if len(edges) and (edges.min() < 0 or edges.max() >= 2**31 - 1):
        raise ValueError("node ids must lie in [0, 2^31 - 1)")
    edges = np.ascontiguousarray(edges, np.int32)
    if num_nodes is None:
        num_nodes = int(edges.max()) + 1 if len(edges) else 0
    return (np.ascontiguousarray(edges[:, 0]),
            np.ascontiguousarray(edges[:, 1]), num_nodes)


def _capacity(num_edges: int, symmetrize: bool) -> int:
    cap = num_edges * (2 if symmetrize else 1)
    if cap >= 2**31:
        # indptr is stored as int32: more entries would overflow it
        raise ValueError(f"{cap} CSR entries do not fit int32 offsets")
    return cap


def build_csr_native(edges: np.ndarray, num_nodes: Optional[int] = None,
                     symmetrize: bool = True,
                     drop_self_loops: bool = True) -> CSRGraph:
    """O(E) parallel CSR build of [E, 2] edges: duplicates kept, rows
    sorted ascending, no weights."""
    src, dst, num_nodes = _endpoints(edges, num_nodes)
    cap = _capacity(len(src), symmetrize)
    indptr = np.zeros(num_nodes + 1, np.int64)
    indices = np.zeros(cap, np.int32)
    total = native_lib().build_csr(
        _p32(src), _p32(dst), len(src), num_nodes, int(symmetrize),
        int(drop_self_loops), _p64(indptr), _p32(indices))
    return CSRGraph(indptr=indptr.astype(np.int32),
                    indices=indices[:total].copy())


def build_csr_weighted_native(
        edges: np.ndarray, weights: Optional[np.ndarray] = None,
        num_nodes: Optional[int] = None, symmetrize: bool = True,
        coalesce: bool = True, drop_self_loops: bool = True) -> CSRGraph:
    """O(E) parallel weighted CSR build with duplicate coalescing: the
    semantics of `csr_from_edges`' numpy path (the weights of duplicate
    entries summed, rows ascending; unit weights when none are given)."""
    src, dst, num_nodes = _endpoints(edges, num_nodes)
    if weights is None:
        wptr = _F32P()
    else:
        weights = np.ascontiguousarray(weights, np.float32)
        wptr = weights.ctypes.data_as(_F32P)
    cap = _capacity(len(src), symmetrize)
    indptr = np.zeros(num_nodes + 1, np.int64)
    indices = np.zeros(cap, np.int32)
    wout = np.zeros(cap, np.float32)
    total = native_lib().build_csr_w(
        _p32(src), _p32(dst), wptr, len(src), num_nodes, int(symmetrize),
        int(drop_self_loops), int(coalesce), _p64(indptr), _p32(indices),
        wout.ctypes.data_as(_F32P))
    return CSRGraph(indptr=indptr.astype(np.int32),
                    indices=indices[:total].copy(),
                    data=wout[:total].copy())


def shuffle_rows_native(graph: CSRGraph, seed: int) -> np.ndarray:
    """Per-row uniform shuffle of the CSR indices (int32 [E]): row i is a
    Fisher-Yates permutation of i's neighbours from `std::mt19937_64`
    seeded `seed * 0x9E3779B97F4A7C15 + i` (mod 2^64)."""
    indptr64 = np.ascontiguousarray(graph.indptr, np.int64)
    indices = np.ascontiguousarray(graph.indices, np.int32)
    out = np.empty_like(indices)
    native_lib().shuffle_rows(_p64(indptr64), _p32(indices),
                              graph.num_nodes, np.uint64(seed), _p32(out))
    return out
