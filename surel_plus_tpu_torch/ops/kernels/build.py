"""Build the package's CUDA kernels with nvcc and bind them with ctypes.

Each `csrc/<name>.cu` compiles on first use into a shared library with a
plain C interface, for `sm_90a` (Hopper), under `_build/` in the package
(listed in .gitignore). The library's file name carries a hash of its
source and of the shared headers (`csrc/*.cuh`), so an edited source
builds anew. `build_all` starts one nvcc per source, all at once.

The host libraries (`csrc/*.cpp`: the PPR push, the graph ingest) build
the same way with g++ (`host_library`).

Every C entry point takes its pointers and the CUDA stream as
`c_void_p`, its sizes as `c_int`, and returns `cudaGetLastError()`; a
`CudaKernel` raises when that is not 0 and counts its launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
# the JAX package adds -march=native to its host builds; left out here, so
# that a library built on one host runs on another
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-fopenmp", "-std=c++17"]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc_path() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the CUDA kernels")
    return found


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source and of every
    shared header in csrc/."""
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_all(names: Sequence[str]) -> Dict[str, str]:
    """Compile every listed source that has no current library, one nvcc
    process per source, started together. Returns nvcc's output (the
    ptxas register and spill report) by name; raises if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def host_library(src: Path, build_dir: Path = BUILD_DIR) -> Path:
    """The g++ build of the C++ source `src` (a plain C interface) in
    `build_dir`, named by a hash of its source and flags, built on first
    use; raises RuntimeError with the compiler's output if the build
    fails."""
    digest = hashlib.sha1(src.read_bytes() + " ".join(CXX_FLAGS).encode())
    so = build_dir / f"lib{src.stem}-{digest.hexdigest()[:12]}.so"
    if so.exists():
        return so
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(src), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as exc:
        raise RuntimeError(f"cannot run the host compiler to build {src}: "
                           f"{exc}") from exc
    if proc.returncode != 0:
        raise RuntimeError(f"building {src} failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


class CudaKernel:
    """One C entry point of one CUDA source, loaded on first launch.

    `launches` counts the launches that returned no error.
    """

    def __init__(self, source: str, symbol: str, argtypes: List):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def _load(self):
        build_all([self.source])
        fn = getattr(ctypes.CDLL(str(library_path(self.source))),
                     self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn

    def __call__(self, device: torch.device, *args) -> None:
        """Launch on `device`'s current stream, with `device` current (the
        library's runtime follows the thread's current context)."""
        if self._fn is None:
            self._load()
        with torch.cuda.device(device):
            err = self._fn(*args,
                           torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.symbol} failed to launch: CUDA "
                               f"error {err}")
        self.launches += 1


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def ptr_or_null(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    """`ptr`, or a null pointer for an operand left out (None)."""
    return ctypes.c_void_p(None) if t is None else ptr(t)


def pick(what: str, t: torch.Tensor, cuda_fn, plain_fn):
    """The kernel for CUDA tensors, the plain version for CPU tensors;
    raises for any other device (no fallback)."""
    if t.device.type == "cuda":
        return cuda_fn
    if t.device.type == "cpu":
        return plain_fn
    raise ValueError(f"{what}: no kernel for device {t.device}")


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype,
               shape: Sequence[int], device: torch.device,
               contiguous: bool = True) -> None:
    """Raise ValueError unless `t` is a `dtype` tensor of `shape` on the
    CUDA device `device`, contiguous unless the caller checks its layout
    itself (`contiguous=False`)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} is on {t.device}: not a CUDA tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
