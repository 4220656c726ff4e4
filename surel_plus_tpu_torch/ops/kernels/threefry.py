"""Threefry-2x32 words over a run of counters: the CUDA kernel
`csrc/threefry.cu` (K8), its plain PyTorch version, and the wrapper that
picks between them.

For a key (k0, k1) of 32-bit words and a start counter `offset`, entry i
of the output is w0 ^ w1 of threefry2x32((k0, k1); (c >> 32, c & mask))
with c = offset + i: `jax.random.bits(key, shape, uint32)` at flat index
i under the partitionable layout, as an int64 value in [0, 2^32). It
replaces no Pallas kernel (the JAX package's draws run in XLA); see
csrc/threefry.cu for its bound and design and ops/prng.py for the key
API that calls it.
"""

from __future__ import annotations

import ctypes

import torch

from surel_plus_tpu_torch.ops.kernels.build import CudaKernel, check_cuda, ptr

KERNEL = CudaKernel("threefry", "threefry_bits_launch",
                    [ctypes.c_uint, ctypes.c_uint, ctypes.c_ulonglong,
                     ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p])
MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0: int, k1: int, x0, x1):
    """The 20 rounds of threefry2x32 with key (k0, k1) on counter words
    (x0, x1): Python ints or int64 tensors of values in [0, 2^32) (each
    sum taken mod 2^32). Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def threefry_bits_plain(k0: int, k1: int, offset: int, out: torch.Tensor
                        ) -> None:
    """The same words in int64 torch ops with masks, into `out` (a
    contiguous int64 tensor, any device)."""
    c = torch.arange(out.numel(), dtype=torch.int64,
                     device=out.device) + offset
    w0, w1 = threefry2x32(k0, k1, c >> 32, c & MASK)
    out.view(-1).copy_(w0 ^ w1)


def threefry_bits_cuda(k0: int, k1: int, offset: int, out: torch.Tensor
                       ) -> None:
    """Launch K8 once over `out` (a contiguous int64 CUDA tensor)."""
    check_cuda("out", out, torch.int64, tuple(out.shape), out.device)
    if out.numel():
        KERNEL(out.device, k0, k1, offset, out.numel(), ptr(out))


def threefry_bits(k0: int, k1: int, offset: int, out: torch.Tensor
                  ) -> torch.Tensor:
    """Fill `out` (a contiguous int64 tensor of any shape) with the words
    of counters offset .. offset + out.numel() - 1 (0 <= offset, the last
    counter below 2^63: the plain version counts in int64). On a CUDA
    tensor this launches K8 once, on a CPU tensor it takes the plain
    version; raises for any other device. Returns `out`."""
    if not 0 <= k0 <= MASK or not 0 <= k1 <= MASK:
        raise ValueError(f"key words ({k0}, {k1}) must lie in [0, 2^32)")
    if offset < 0 or offset + out.numel() > 1 << 63:
        raise ValueError(f"counters {offset} .. {offset + out.numel()} "
                         f"leave [0, 2^63)")
    if out.dtype != torch.int64 or not out.is_contiguous():
        raise ValueError("out must be a contiguous int64 tensor")
    if out.device.type == "cuda":
        threefry_bits_cuda(k0, k1, offset, out)
    elif out.device.type == "cpu":
        threefry_bits_plain(k0, k1, offset, out)
    else:
        raise ValueError(f"threefry_bits: no kernel for device {out.device}")
    return out
