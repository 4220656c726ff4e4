"""XLA's float32 erf, erf_inv and log1p as its CPU backend computes them,
op for op, so that the port's truncated normal draws JAX's bits.

`jax.random.truncated_normal` (behind flax's xavier_normal) maps uniforms
through `lax.erf_inv`, and its bounds through `lax.erf`. On the CPU, XLA
lowers both to float32 polynomials: erf to a rational function in x^2
with explicit fused multiply-adds, erf_inv to Giles' approximation over
w = -log1p(-x^2), with log1p its own: a rational function below
|x| < sqrt(2) - 1, and a Cephes-style logarithm of 1 + x above it. Its
LLVM backend contracts a product into the sum it feeds (FPOpFusion::Fast)
when the product has no other use; where a sum adds two such products,
the first operand's is contracted. Each function here takes the same
operations in the same order, each fused multiply-add rounded once
(`fma`), every other operation rounded as its float32 operation rounds.
The constants are the float32 bit patterns of XLA's lowering.

Every operation is a plain torch elementwise operation that rounds
correctly on both devices, so the CPU and the card give the same bits:
float32 +, -, * and comparisons; the fused multiply-adds, the division
and the square root go through float64 (an exact product, and a
round-to-odd sum, so the float32 result is rounded once; a float64
quotient or root rounds to float32 as the float32 operation would, since
53 >= 2 * 24 + 2). torch's own float32 sqrt on the CPU is not correctly
rounded, hence `sqrt`.
"""

from __future__ import annotations

import numpy as np
import torch

F32, F64 = torch.float32, torch.float64


def _bits(*words) -> list:
    """float32 constants from their bit patterns."""
    return [float(np.uint32(w).view(np.float32)) for w in words]


def _const(x: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar on `like`'s device (a fill, not a host copy)."""
    return torch.full((), x, dtype=F32, device=like.device)


def fma(a, b, c) -> torch.Tensor:
    """float32 a * b + c rounded once, as a fused multiply-add rounds.

    The product of two float32 is exact in float64; the float64 sum s
    and its exact error e (TwoSum) give the sum rounded to odd (s, or its
    neighbour toward e when s is even and e is not 0), which rounds to
    float32 as the exact sum does."""
    p = a.to(F64) * b.to(F64)
    q = c.to(F64)
    s = p + q
    bb = s - p
    e = (p - (s - bb)) + (q - bb)
    bits = s.view(torch.int64)
    step = torch.where((e > 0) == (s > 0), 1, -1)
    odd = torch.where((e != 0) & ((bits & 1) == 0), bits + step, bits)
    return odd.view(F64).to(F32)


def div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 a / b, correctly rounded on every device."""
    return (a.to(F64) / b.to(F64)).to(F32)


def sqrt(a: torch.Tensor) -> torch.Tensor:
    """float32 sqrt(a), correctly rounded on every device."""
    return torch.sqrt(a.to(F64)).to(F32)


# erf: x clamped to +-ERF_CLAMP, x * N(x^2) / D(x^2)
ERF_CLAMP = _bits(0x406F9C68)[0]
ERF_N = _bits(0x39702D51, 0x3B5F5DA2, 0x3D50B6EB, 0x3E3DA740, 0x3F906EBA)
ERF_D = _bits(0xB3FD3906, 0x37C588DF, 0x3A856D28, 0x3C6687D4, 0x3DE34C21,
              0x3EFEB44A, 0x3F800000)


def erf(x: torch.Tensor) -> torch.Tensor:
    """`lax.erf` of float32 x."""
    x = x.clamp(-ERF_CLAMP, ERF_CLAMP)
    x2 = x * x
    n = fma(_const(ERF_N[0], x), x2, _const(ERF_N[1], x))
    for k in ERF_N[2:]:
        n = fma(n, x2, _const(k, x))
    d = fma(_const(ERF_D[0], x), x2, _const(ERF_D[1], x))
    for k in ERF_D[2:]:
        d = fma(d, x2, _const(k, x))
    return div(x * n, d)


# log1p above the threshold: log(1 + x) from its mantissa m in
# [sqrt(1/2), sqrt(2)) and exponent e, the polynomial in three parts
LOG_P = _bits(0x3D9021BB, 0xBDEBD1B8, 0xBDFE5D4F, 0x3E11E9BF, 0x3E4CCEAC,
              0xBE7FFFFC, 0x3DEF251A, 0xBE2AAE50, 0x3EAAAAAA)
LOG_C1, LOG_C2, LOG_SQRTH, LOG_MIN = _bits(0xB95E8083, 0x3F318000,
                                           0x3F3504F3, 0x00800000)
# log1p below it: x - x^2 / 2 + x^3 P(x) / Q(x)
L1P_P = _bits(0x383DE04B, 0x3EFF40C5, 0x40D284FA, 0x41EF4B9C, 0x4273CC76,
              0x426473AD, 0x41A05101)
L1P_Q = _bits(0x417101AD, 0x42A6185B, 0x435DC32D, 0x439A8CA3, 0x43586D8A,
              0x42707982)
L1P_SMALL = _bits(0x3ED413CD)[0]


def _log_big(x: torch.Tensor) -> torch.Tensor:
    """log(1 + x), the branch for |x| >= L1P_SMALL."""
    one = _const(1.0, x)
    x1 = x + one
    b = torch.maximum(x1, _const(LOG_MIN, x)).view(torch.int32)
    e = ((b >> 23) - 127).to(F32) + one
    m = ((b & 0x7FFFFF) | 0x3F000000).view(F32)
    low = m < LOG_SQRTH
    zero = torch.zeros_like(m)
    e = e - torch.where(low, one, zero)
    v = (m + _const(-1.0, x)) + torch.where(low, m, zero)
    v2 = v * v
    v3 = v2 * v
    p = [_const(k, x) for k in LOG_P]
    y = fma(fma(v, p[0], p[1]), v, p[6])
    y1 = fma(fma(v, p[2], p[3]), v, p[7])
    y2 = fma(fma(v, p[4], p[5]), v, p[8])
    y = fma(fma(fma(y, v3, y1), v3, y2), v3, e * _const(LOG_C1, x))
    v = fma(-v2, _const(0.5, x), v) + y
    out = fma(e, _const(LOG_C2, x), v)
    out = torch.where(x1 == 0, _const(-np.inf, x), out)
    out = torch.where(x1 == np.inf, _const(np.inf, x), out)
    return torch.where(x1 < 0, _const(np.nan, x), out)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """`lax.log1p` of float32 x (finite x >= -1, as erf_inv gives it)."""
    xx = x * x
    q = x + _const(L1P_Q[0], x)
    for k in L1P_Q[1:]:
        q = fma(q, x, _const(k, x))
    p = fma(_const(L1P_P[0], x), x, _const(L1P_P[1], x))
    for k in L1P_P[2:]:
        p = fma(p, x, _const(k, x))
    small = x + fma(xx, _const(-0.5, x), (x * xx) * div(p, q))
    return torch.where(x.abs() < L1P_SMALL, small, _log_big(x))


# erf_inv: Giles' polynomials in t = w - 2.5 (w < 5) or sqrt(w) - 3
ERFINV_LO = _bits(0x32F16588, 0x34B84B36, 0xB66C7357, 0xB6935AC1,
                  0x396532DB, 0xBAA45408, 0xBB88E4EF, 0x3E7C8F63,
                  0x3FC02E2F)
ERFINV_HI = _bits(0xB951F09B, 0x38D3B56B, 0x3AB0DC72, 0xBB70BDE7,
                  0x3BBC127B, 0xBBF9C5D7, 0x3C1AA57E, 0x3F8036DB,
                  0x40354F7E)


def erf_inv(u: torch.Tensor) -> torch.Tensor:
    """`lax.erf_inv` of float32 u in [-1, 1] (+-inf at +-1)."""
    lg = log1p(u * (-u))
    near = lg > -5.0                                   # w = -lg < 5
    t = torch.where(near, _const(-2.5, u) - lg,
                    sqrt(-lg) + _const(-3.0, u))
    c = [torch.where(near, _const(a, u), _const(b, u))
         for a, b in zip(ERFINV_LO, ERFINV_HI)]
    p = fma(c[0], t, c[1])
    for k in c[2:]:
        p = fma(t, p, k)
    return u * torch.where(u.abs() == 1.0, _const(np.inf, u), p)
