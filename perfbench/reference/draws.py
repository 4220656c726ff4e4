"""Frozen copy of the draws the program takes from a seed, in plain Python
and PyTorch: JAX's threefry2x32 key API in its partitionable layout (the
key of a seed, fold_in, split, flax's name fold, bits, bernoulli) and
`std::mt19937_64` with the Fisher-Yates row shuffle of the program's
graph ingest.

The benchmark's reference works every set, batch order and dropout mask
out again from these; it imports nothing of the program.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA

Key = Tuple[int, int]


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0: int, k1: int, x0, x1):
    """Twenty rounds of threefry2x32 on counter words (x0, x1): Python
    ints or int64 tensors of values in [0, 2^32)."""
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


def key_of(seed: int) -> Key:
    """The key of a 64-bit seed: its high and low words."""
    s = int(seed) & ((1 << 64) - 1)
    return (s >> 32, s & MASK)


def fold_in(key: Key, data: int) -> Key:
    return threefry2x32(key[0], key[1], 0, int(data) & MASK)


def split(key: Key, num: int = 2) -> List[Key]:
    return [threefry2x32(key[0], key[1], i >> 32, i & MASK)
            for i in range(num)]


def fold_names(key: Key, names: Sequence[Union[str, int]]) -> Key:
    """flax's fold of a scope path: the first four bytes of the SHA-1 of
    the names, read big-endian, folded in."""
    m = hashlib.sha1()
    for x in names:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(int(x).to_bytes((int(x).bit_length() + 7) // 8, "big"))
    return fold_in(key, int.from_bytes(m.digest()[:4], "big"))


def bits(key: Key, shape, device, offset: int = 0) -> torch.Tensor:
    """Word i of the draw is w0 ^ w1 of threefry2x32(key; (c >> 32,
    c & mask)) at counter c = offset + i: int64 values in [0, 2^32)."""
    n = int(np.prod(shape))
    c = torch.arange(n, dtype=torch.int64, device=device) + int(offset)
    w0, w1 = threefry2x32(key[0], key[1], c >> 32, c & MASK)
    return (w0 ^ w1).reshape(tuple(shape))


def bernoulli(key: Key, p: float, shape, device) -> torch.Tensor:
    """uniform(key) < p, the uniform from the high 23 bits of each word."""
    b = bits(key, shape, device)
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return f < torch.tensor(p, dtype=torch.float32, device=device)


# ------------------------------------------------------------ mt19937_64
_U64 = np.uint64
_MT_N, _MT_M = 312, 156
_UPPER, _LOWER = _U64(0xFFFFFFFF80000000), _U64(0x7FFFFFFF)
_MATRIX = _U64(0xB5026F5AA96619E9)


class MT19937_64:
    """`std::mt19937_64`, its state twisted 312 words at a time in numpy."""

    def __init__(self, seed: int):
        mt = [int(seed) & ((1 << 64) - 1)]
        for i in range(1, _MT_N):
            prev = mt[-1]
            mt.append((6364136223846793005 * (prev ^ (prev >> 62)) + i)
                      & ((1 << 64) - 1))
        self.mt = np.array(mt, dtype=np.uint64)
        self.out: List[int] = []

    def _twist(self) -> None:
        mt = self.mt
        with np.errstate(over="ignore"):
            def mix(a, b):
                x = (a & _UPPER) | (b & _LOWER)
                return (x >> _U64(1)) ^ np.where((x & _U64(1)) == 1,
                                                 _MATRIX, _U64(0))
            # words 0..155 read old words only; 156..310 the new 0..154
            mt[:_MT_M] = mt[_MT_M:] ^ mix(mt[:_MT_M], mt[1:_MT_M + 1])
            mt[_MT_M:_MT_N - 1] = mt[:_MT_M - 1] ^ mix(mt[_MT_M:_MT_N - 1],
                                                       mt[_MT_M + 1:])
            mt[_MT_N - 1] = mt[_MT_M - 1] ^ mix(mt[_MT_N - 1:], mt[:1])[0]
            y = mt.copy()
            y ^= (y >> _U64(29)) & _U64(0x5555555555555555)
            y ^= (y << _U64(17)) & _U64(0x71D67FFFEDA60000)
            y ^= (y << _U64(37)) & _U64(0xFFF7EEE000000000)
            y ^= y >> _U64(43)
        self.out = y.tolist()[::-1]

    def __call__(self) -> int:
        if not self.out:
            self._twist()
        return self.out.pop()


def shuffled_row(row: Sequence[int], shuffle_seed: int, node: int
                 ) -> List[int]:
    """The ingest's Fisher-Yates shuffle of `node`'s row: a generator
    seeded shuffle_seed * 0x9E3779B97F4A7C15 + node (mod 2^64), swapping
    position k with rng() % (k + 1) from the last position down."""
    out = list(row)
    if len(out) <= 1:
        return out
    rng = MT19937_64((int(shuffle_seed) * 0x9E3779B97F4A7C15 + int(node))
                     & ((1 << 64) - 1))
    for k in range(len(out) - 1, 0, -1):
        j = rng() % (k + 1)
        out[k], out[j] = out[j], out[k]
    return out
