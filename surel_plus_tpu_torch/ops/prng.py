"""JAX's threefry key API on torch: the port draws what the JAX package
draws from the same seed.

A key is a pair of Python ints (k0, k1), each in [0, 2^32): the two
uint32 words of `jax.random.PRNGKey(seed)` and of every key derived from
it. Keys live on the host, so deriving one adds no device work and no
sync; only `bits` (and `uniform`, `bernoulli` over it) touches a device,
through the threefry kernel K8 (`ops/kernels/threefry.py`).

Every function follows JAX's default threefry2x32 implementation in its
partitionable layout (`jax_threefry_partitionable`, on by default since
JAX 0.5 and in the JAX 0.9 the reference runs under; the JAX package
never sets it), and only that layout:

- prng_key(s) = (s >> 32, s & 0xffffffff) of a 64-bit seed (JAX's
  threefry_seed); JAX without x64 reads the seed as 32 bits first, and
  both give (0, s) for 0 <= s < 2^31;
- fold_in(k, d) = threefry2x32(k; (0, d));
- split(k, n)[i] = threefry2x32(k; (i >> 32, i & 0xffffffff));
- bits(k, shape)[i] = w0 ^ w1 of threefry2x32(k; (i >> 32, i & mask)) at
  flat index i, so a block of rows of a larger draw is the same draw at
  an offset (`offset`);
- uniform(k, shape, minval, maxval) = max(minval, f * (maxval - minval)
  + minval) in float32, f = bitcast((bits >> 9) | 0x3f800000) - 1, the
  product and the sum rounded once, as XLA's CPU backend fuses them;
- truncated_normal(k, lower, upper, shape) = sqrt(2) erf_inv(uniform(k,
  shape, erf(lower / sqrt(2)), erf(upper / sqrt(2)))) clipped to the
  open interval, erf and erf_inv as XLA computes them in float32
  (`ops/special.py`), so the draw is JAX's bit for bit;
- bernoulli(k, p, shape) = uniform(k, shape) < p;
- fold_in_static(k, names): flax's `_fold_in_static` (the rng of a module
  scope), with its name separator off (flax_fix_rng_separator, False in
  flax 0.12).

Under the other layout JAX's `split` and `bits` draw other words; the
port does not implement it.
"""

from __future__ import annotations

import functools
import hashlib
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from surel_plus_tpu_torch.ops import special
from surel_plus_tpu_torch.ops.kernels.threefry import (
    MASK,
    threefry2x32,
    threefry_bits,
)

Key = Tuple[int, int]


def prng_key(seed: int) -> Key:
    """`jax.random.PRNGKey(seed)`: the seed's high and low 32-bit words
    (a negative seed as its 64-bit two's complement)."""
    s = int(seed)
    if not -(1 << 63) <= s < 1 << 64:
        raise ValueError(f"seed {s} does not fit 64 bits")
    s &= (1 << 64) - 1
    return (s >> 32, s & MASK)


def as_key(key) -> Key:
    """A key from any two-word form: a (k0, k1) pair, a numpy array or a
    tensor of two uint32 (or int32 bit pattern) words, such as a
    checkpoint's "key"."""
    w = np.asarray(key).reshape(-1)
    if w.shape != (2,):
        raise ValueError(f"a key has two words, got shape {np.shape(key)}")
    return (int(w[0]) & MASK, int(w[1]) & MASK)


def key_words(key: Key) -> np.ndarray:
    """The key as JAX stores it: uint32 [2]."""
    return np.asarray(as_key(key), dtype=np.uint32)


def fold_in(key: Key, data: int) -> Key:
    """`jax.random.fold_in(key, data)` for 0 <= data < 2^32."""
    if not 0 <= int(data) <= MASK:
        raise ValueError(f"fold_in data {data} is not a uint32")
    return threefry2x32(*as_key(key), 0, int(data))


def split(key: Key, num: int = 2) -> List[Key]:
    """`jax.random.split(key, num)`, as a list of `num` keys."""
    k0, k1 = as_key(key)
    return [threefry2x32(k0, k1, i >> 32, i & MASK) for i in range(num)]


def fold_in_static(key: Key, names: Sequence[Union[str, int]]) -> Key:
    """flax's `_fold_in_static(key, names)`: fold in the first four bytes,
    read big-endian, of the SHA-1 of the names (str as UTF-8, int as its
    big-endian bytes), or the key itself for no names."""
    if not names:
        return as_key(key)
    m = hashlib.sha1()
    for x in names:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        elif isinstance(x, int):
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
        else:
            raise ValueError(f"expected int or str, got {x!r}")
    return fold_in(key, int.from_bytes(m.digest()[:4], byteorder="big"))


def bits(key: Key, shape, device, offset: int = 0) -> torch.Tensor:
    """`jax.random.bits(key, shape, uint32)` as int64 values in
    [0, 2^32) on `device`; `offset` starts the flat counters there, so
    bits(key, [r, c], offset=a * c) is rows a .. a + r - 1 of a larger
    draw of c columns. One launch of K8 on a CUDA device."""
    shape = tuple(int(d) for d in shape)
    out = torch.empty(shape, dtype=torch.int64, device=device)
    k0, k1 = as_key(key)
    return threefry_bits(k0, k1, int(offset), out)


def uniform(key: Key, shape, device, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform(key, shape, float32, minval, maxval)`: float32
    in [minval, maxval) from the high 23 bits of each word; the bounds
    rounded to float32, f * (maxval - minval) + minval rounded once (the
    fused multiply-add XLA's CPU backend makes of it)."""
    b = bits(key, shape, device)
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    if (minval, maxval) == (0.0, 1.0):
        return f                            # f * 1 + 0 is f, exactly
    lo = torch.full((), minval, dtype=torch.float32, device=device)
    hi = torch.full((), maxval, dtype=torch.float32, device=device)
    return torch.maximum(lo, special.fma(f, hi - lo, lo))


@functools.lru_cache(maxsize=None)
def truncation(lower: float, upper: float) -> Tuple[float, ...]:
    """erf(lower / sqrt(2)), erf(upper / sqrt(2)) and the clip bounds
    nextafter(lower, +inf), nextafter(upper, -inf), in float32 as
    `jax.random.truncated_normal` computes them (on the host)."""
    sqrt2 = torch.tensor(float(np.float32(np.sqrt(2))))
    lo, hi = (torch.tensor(float(x), dtype=torch.float32)
              for x in (lower, upper))
    a = special.erf(special.div(lo, sqrt2)).item()
    b = special.erf(special.div(hi, sqrt2)).item()
    inf = torch.tensor(np.inf, dtype=torch.float32)
    return (a, b, torch.nextafter(lo, inf).item(),
            torch.nextafter(hi, -inf).item())


def truncated_normal(key: Key, lower: float, upper: float, shape,
                     device) -> torch.Tensor:
    """`jax.random.truncated_normal(key, lower, upper, shape)` in float32:
    a normal truncated to (lower, upper), as JAX draws it bit for bit
    (the words from K8 on a CUDA device, the transform elementwise on the
    same device)."""
    a, b, lo, hi = truncation(float(lower), float(upper))
    u = uniform(key, shape, device, a, b)
    sqrt2 = torch.full((), float(np.float32(np.sqrt(2))),
                       dtype=torch.float32, device=device)
    return (sqrt2 * special.erf_inv(u)).clamp(lo, hi)


def bernoulli(key: Key, p: float, shape, device) -> torch.Tensor:
    """`jax.random.bernoulli(key, p, shape)`: uniform < p, with p rounded
    to float32 as JAX does (filled on the device: no host copy, no
    sync)."""
    return uniform(key, shape, device) < torch.full(
        (), p, dtype=torch.float32, device=device)
