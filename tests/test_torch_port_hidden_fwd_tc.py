"""PyTorch port, the fused key hidden set sum on the tensor cores (K1,
csrc/hidden_sum.cu on csrc/hidden_tc.cuh): the numerics of its design,
checked on the CPU.

K1 forms z = b1 + f(k) . U on mma.sync.m16n8k8 in TF32: the fields are
integers, exact in TF32 below 2^11 (and split in two exact parts above);
U is split into big (U truncated to TF32) and small (the rest, truncated
again), so each product is exact and z loses only small's truncation and
the tensor core's fp32 sum; b1 starts a fresh accumulator for every slot.
Where that z lies within S / 2^TC_NEAR_SHIFT of 0 (S = max |b1| + sum_i
f_i max |U_i|, the maxima over the slab's channels) a pass after the row
recomputes z in the fmaf order (b1 first, then field 0, 1, ...), takes
relu of the tensor-core z out of the sums and adds relu of the fmaf-order
z, so that its relu decisions are those K1 bwd recomputes and a set of one
slot sums relu of the fmaf-order z to the bit. The fmaf order is emulated exactly (`fma32`, held to exact
rational arithmetic here).
A warp takes a query row: the cross plane, then each endpoint's own row,
in k-steps of 8 consecutive slots (a k-step with no selected slot is
skipped, an unselected slot adds 0); lane c of a channel adds relu(z) of
the k-step's slots 2c and 2c + 1 to its sums (a cross slot weighted by
its endpoint bits), and at the row's end the four lanes' sums are added
as (c0 + c1) + (c2 + c3). The emulation below takes those steps in that
order and is held to the fp32 plain version and to the JAX package's
`fused_key_hidden_sum` (Pallas interpret mode) at L = 301, H = 96, a small
B, both key layouts, Q = 2 and 4; one TF32 product of U (rounded to the
nearest TF32 value) is shown to miss the tolerance. The recheck keeps
every relu decision of the fmaf order on weights made to put z at or near
0, where the tensor-core z alone does not, also on sets of one slot each
(chip_smoke.py's card check of the same). The Python mirror of K1's
layout constants is held to the header.

Tolerance: rtol 1e-4, atol 1e-3, as chip_smoke.py holds the kernel to the
plain version on the card (K1_RTOL, K1_ATOL).
"""

import re
from fractions import Fraction
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surel_plus_tpu.ops.pallas.hidden_sum_kernel import (
    fused_key_hidden_sum as jax_fused_key_hidden_sum,
)
from surel_plus_tpu_torch.ops.kernels import hidden_sum as hs
from surel_plus_tpu_torch.ops.kernels.hidden_sum import (
    _fields_ext,
    fma32,
    fused_key_hidden_sum_plain,
    zed_fmaf,
)
from test_torch_port_hidden_bwd_tc import LAYOUTS, _keys, _roots, _t, _u_ext
from test_torch_port_lstm_tc import tf32_rna, tf32_trunc
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

RTOL, ATOL = 1e-4, 1e-3
CSRC = Path(hs.__file__).resolve().parents[2] / "csrc"
L, H = 301, 96


# ------------------------------------------------ the kernel's arithmetic

def _fields(keys, shift, ncol, root):
    """The key's ncol fields, float32 [..., ncol]."""
    fo = _fields_ext(keys, torch.zeros(keys.shape, dtype=torch.bool), shift,
                     ncol, root)
    return fo[..., :ncol]


def z_tc(f, u_ext, shift, mode="split"):
    """z [..., H] as the tensor core forms it: "split" (the kernel): U in
    big and small TF32 parts, the fields whole (or split past shift 11),
    every product exact and summed to fp32 with b1; "single": U rounded to
    TF32 once; "unsplit": the fields truncated to TF32 (no split past 11)."""
    ncol = f.shape[-1]
    u = u_ext[:ncol]
    if mode == "single":
        parts_u = [tf32_rna(u)]
    else:
        big = tf32_trunc(u)
        parts_u = [big, tf32_trunc(u - big)]
    fb = tf32_trunc(f)
    parts_f = [fb]
    if mode != "unsplit" and shift > hs.TC_EXACT_SHIFT:
        parts_f.append(f - fb)
    uu = sum(p.double() for p in parts_u)
    ff = sum(p.double() for p in parts_f)
    return (u_ext[ncol + 1].double() + ff @ uu).float()


def near_bound(f, u_ext):
    """Each slot's recheck bound as the kernel takes it, [..., H]: S /
    2^TC_NEAR_SHIFT with S = max |b1| + sum_i f_i max |U_i|, the maxima
    over the channels of the slot's slab; 0 where the fields meet no
    nonzero U row (z is then b1 exactly)."""
    ncol, h = u_ext.shape[0] - 2, u_ext.shape[1]
    cs = 16 * hs.slab_mtiles(ncol, False)
    out = torch.empty(*f.shape[:-1], h)
    for c0 in range(0, h, cs):
        u = u_ext[:, c0:c0 + cs].abs()
        t = (f.double() * u[:ncol].amax(dim=1).double()).sum(dim=-1)
        s = torch.where(t > 0, u[ncol + 1].max() + t.float(), 0.0)
        out[..., c0:c0 + cs] = torch.ldexp(
            s, torch.tensor(-hs.TC_NEAR_SHIFT))[..., None]
    return out


def zed_k1(f, u_ext, shift, mode="split", recheck=True):
    """K1's z: the tensor-core z, recomputed in the fmaf order where it
    lies within the bound of 0 (`recheck`). Returns (z, rechecked)."""
    z = z_tc(f, u_ext, shift, mode)
    if not recheck:
        return z, torch.zeros(z.shape, dtype=torch.bool)
    near = z.abs() < near_bound(f, u_ext)
    return torch.where(near, zed_fmaf(f, u_ext), z), near


def _hot_and_fix(f, u_ext, shift, mode):
    """What the walk adds, relu of the tensor-core z; and where that z lies
    within the bound (0 elsewhere) what the recheck takes out again, the
    same relu, and what it adds in its place, relu of the fmaf-order z."""
    zt = z_tc(f, u_ext, shift, mode)
    near = zt.abs() < near_bound(f, u_ext)
    fix = torch.where(near, torch.relu(zed_fmaf(f, u_ext)), 0.0)
    return torch.relu(zt), torch.where(near, torch.relu(zt), 0.0), fix


def sum_fwd_tc(kown, mown, kcross, mcross, u_ext, shift, root_own=None,
               root_cross=None, mode="split"):
    """K1's arithmetic: relu of the tensor-core z through each segment's
    k-steps (the cross plane, then the own rows; an unselected slot adds 0,
    so skipping a k-step of them changes no bit), then the recheck in the
    same order: each near entry's relu taken out and the fmaf-order one
    added (a no-op, to the bit, elsewhere); the lanes' sums and their
    fixed-order reduction. -> [Q, B, H] float32."""
    q, b, _ = kown.shape
    ncol, h = u_ext.shape[0] - 2, u_ext.shape[1]
    hc, bc, fc = _hot_and_fix(_fields(kcross, shift, ncol, root_cross),
                              u_ext, shift, mode)                 # [B, Lc, H]
    ho, bo, fo = _hot_and_fix(_fields(kown, shift, ncol, root_own), u_ext,
                              shift, mode)                        # [Q,B,Lo,H]
    lanes = torch.zeros(q, 4, b, h)          # lane c's sums, endpoint q
    wc = mcross.to(torch.float32)
    segs = []
    for zc, zo in (((hc,), (ho,)), ((bc, fc), (bo, fo))):  # walk, recheck
        segs += [(-1, zc, mcross.any(dim=0), wc)]
        segs += [(i, tuple(z[i] for z in zo), mown[i], None)
                 for i in range(q)]
    for s, zs, sel, w in segs:
        pad = -zs[0].shape[1] % 8
        rows = [torch.nn.functional.pad(torch.where(sel[..., None], z, 0.0),
                                        (0, 0, 0, pad)) for z in zs]
        if w is not None:                    # the cross slots' bits
            wq = torch.nn.functional.pad(w, (0, pad))[:, :, :, None]
        for j in range(0, rows[0].shape[1], 8):
            for c in range(4):
                for e in (j + 2 * c, j + 2 * c + 1):
                    v = [r[:, e] if w is None else wq[:, :, e] * r[None, :, e]
                         for r in rows]
                    lane = lanes[s, c] if w is None else lanes[:, c]
                    if len(v) == 1:
                        lane += v[0]
                    else:
                        lane.copy_((lane - v[0]) + v[1])
    return (lanes[:, 0] + lanes[:, 1]) + (lanes[:, 2] + lanes[:, 3])


def _case(rng, layout, q, b):
    nw, ns = LAYOUTS[layout]
    kown = _keys(rng, (q, b, L), nw, ns)
    kcross = _keys(rng, (b, 2 * L), nw, ns)
    mown = rng.random((q, b, L)) < 0.4
    pick = rng.integers(0, q + 2, size=(b, 2 * L))
    mcross = np.stack([pick == i for i in range(q)])
    mown[:, 0] = False                  # set 0: all masked ...
    mcross[:, 0] = False                # ... and no cross slot
    roots = _roots(rng, layout, kown, kcross)
    return kown, mown, kcross, mcross, _u_ext(rng, nw, ns), roots


def _close(got, want):
    return bool(torch.allclose(got, want, rtol=RTOL, atol=ATOL))


def _excess(got, want):
    """The largest |got - want| over its allowance atol + rtol |want|."""
    return float(((got - want).abs() / (ATOL + RTOL * want.abs())).max())


# ------------------------------------------------------------ the tests

@pytest.mark.parametrize("q", [2, 4])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sum_fwd_emulation_matches_plain_and_jax(layout, q):
    """K1's products, recheck and sums in the kernel's order against the
    fp32 plain version and JAX's kernel (interpret mode); the all-masked
    set exactly 0; one TF32 product of U misses the tolerance."""
    nw, ns = LAYOUTS[layout]
    shift = int(nw).bit_length()
    rng = np.random.default_rng(40 + q)
    kown, mown, kcross, mcross, u, roots = _case(rng, layout, q, 3)
    args = (_t(kown), torch.as_tensor(mown), _t(kcross),
            torch.as_tensor(mcross), u)
    want = fused_key_hidden_sum_plain(*args, shift, *roots)
    jr = {} if roots[0] is None else dict(
        root_own=jnp.asarray(roots[0].numpy()),
        root_cross=jnp.asarray(roots[1].numpy()))
    jax_out = torch.as_tensor(np.array(jax_fused_key_hidden_sum(
        jnp.asarray(kown), jnp.asarray(mown), jnp.asarray(kcross),
        jnp.asarray(mcross), jnp.asarray(u.numpy()), shift, interpret=True,
        **jr)))
    got = sum_fwd_tc(*args, shift, *roots)
    assert _close(got, want) and _close(got, jax_out)
    assert _close(want, jax_out)
    assert bool((got[:, 0] == 0).all())
    single = sum_fwd_tc(*args, shift, *roots, mode="single")
    assert _excess(got, want) < 0.05 and _excess(single, want) > 1, (
        _excess(got, want), _excess(single, want))


def _near_zero_u(rng, nw, ns):
    """u_ext whose z is exactly 0 where fields 0 and 1 agree (U_1 = -U_0,
    b1 = 0, the other rows 0) in half the channels, and a few ulps off 0
    there in the other half (b1 of a few ulps of U_0)."""
    u = _u_ext(rng, nw, ns)
    half = H // 2
    u[1] = -u[0]
    u[2:ns + 1] = 0.0
    u[ns + 2, :half] = 0.0
    u[ns + 2, half:] = u[0, half:] * torch.as_tensor(
        rng.integers(-4, 5, size=H - half) * 2.0 ** -23, dtype=torch.float32)
    return u


def test_recheck_keeps_the_fmaf_decisions():
    """On weights that put z at or within a few ulps of 0 at many slots,
    the recheck makes every relu decision (z > 0) the fmaf order's, where
    the tensor-core z alone makes others; on the bench's weights it
    rechecks few slots, and the set sum stays within the tolerance."""
    nw, ns = LAYOUTS["lo_only"]
    shift = int(nw).bit_length()
    rng = np.random.default_rng(7)
    keys = _t(_keys(rng, (4, L), nw, ns))
    f = _fields(keys, shift, ns + 1, None)
    u = _near_zero_u(rng, nw, ns)
    ref = zed_fmaf(f, u) > 0
    z, near = zed_k1(f, u, shift)
    tc_only, _ = zed_k1(f, u, shift, recheck=False)
    assert torch.equal(z > 0, ref)
    assert int(((tc_only > 0) != ref).sum()) > 0
    # hundreds of slot-channels near 0 (the keys of zeros, exact, aside)
    assert float(near.float().mean()) > 1e-3
    _, near = zed_k1(f, _u_ext(rng, nw, ns), shift)
    assert float(near.float().mean()) < 1e-3
    kown, mown, kcross, mcross, _, roots = _case(rng, "lo_only", 2, 3)
    args = (_t(kown), torch.as_tensor(mown), _t(kcross),
            torch.as_tensor(mcross), u)
    assert _close(sum_fwd_tc(*args, shift),
                  fused_key_hidden_sum_plain(*args, shift))


@pytest.mark.parametrize("zero_bias", ["all", "some"])
def test_zero_keys_need_no_recheck(zero_bias):
    """The cross slots that the partner's set lacks carry key 0, and b1 is
    0 in a fresh Net ("all") and stays 0 in training where a channel's
    relu never passes ("some"): a key of zeros gives z = b1 exactly in
    both orders, and no such slot is rechecked (a bound from the fields'
    largest values, or from the largest |b1| alone, flags them)."""
    nw, ns = LAYOUTS["lo_only"]
    shift = int(nw).bit_length()
    u = _u_ext(np.random.default_rng(5), nw, ns)
    u[ns + 2, ::(1 if zero_bias == "all" else 7)] = 0.0
    f = _fields(torch.zeros(64, dtype=torch.int32), shift, ns + 1, None)
    z, near = zed_k1(f, u, shift)
    assert not bool(near.any())
    assert torch.equal(z, zed_fmaf(f, u))
    assert bool((z == u[ns + 2]).all())


def test_fields_split_past_shift_11():
    """shift 12 (num_walks >= 2048), fields over their whole width: z with
    the fields split as the kernel splits them is within the tolerance of
    the plain version's set sum; truncating them to TF32 misses."""
    rng = np.random.default_rng(3)
    shift, ncol, q, b = 12, 3, 2, 3
    kown = torch.as_tensor(rng.integers(0, 1 << 25, size=(q, b, L)).astype(
        np.int32))
    kcross = torch.as_tensor(rng.integers(0, 1 << 25, size=(b, 2 * L)
                                          ).astype(np.int32))
    mown = torch.as_tensor(rng.random((q, b, L)) < 0.4)
    mcross = torch.as_tensor(np.stack([rng.random((b, 2 * L)) < 0.3] * q))
    u = torch.cat([torch.as_tensor(rng.normal(size=(ncol, H)).astype(
        np.float32)) / 2048, torch.full((1, H), hs.NEG),
        torch.as_tensor(0.2 * rng.normal(size=(1, H)).astype(np.float32))])
    args = (kown, mown, kcross, mcross, u, shift)
    want = fused_key_hidden_sum_plain(*args)
    assert _close(sum_fwd_tc(*args), want)
    assert _excess(sum_fwd_tc(*args, mode="unsplit"), want) > 1


def _constants(text):
    return {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", text)}


def test_fwd_layout_mirrors_the_header():
    """K1's Python mirror (TC_NEAR_SHIFT, TC_QUEUE, TC_WARPS) against
    csrc/hidden_tc.cuh; the bound's 4x margin over the error terms the
    source derives (2^-20 + 18 * 2^-23 + 8 * 2^-24 of S)."""
    c = _constants((CSRC / "hidden_tc.cuh").read_text())
    assert (c["kNearShift"], c["kQueue"], c["kWarps"]) == (
        hs.TC_NEAR_SHIFT, hs.TC_QUEUE, hs.TC_WARPS)
    err = 2.0 ** -20 + 18 * 2.0 ** -23 + 8 * 2.0 ** -24
    assert 4 * err <= 2.0 ** -hs.TC_NEAR_SHIFT


def _f32(x: Fraction) -> float:
    """x rounded once to the nearest float32 (ties to even)."""
    if x == 0:
        return 0.0
    e = max(abs(x).numerator.bit_length() - abs(x).denominator.bit_length(),
            -126)
    while abs(x) >= Fraction(2) ** (e + 1):
        e += 1
    while e > -126 and abs(x) < Fraction(2) ** e:
        e -= 1
    scale = Fraction(2) ** (23 - e)
    return float(Fraction(round(x * scale)) / scale)


def test_fma32_rounds_once():
    """`fma32` against a * b + c in exact rational arithmetic, rounded once
    to float32, on random integers a below 2^22 and float32 b, c of every
    relative size (c down to 2^-60 of a * b and cancelling it), and on a
    case that a float64 sum rounded twice gets wrong: 97 * (172961 *
    2^-24) = 1 + 2^-24 lies on a float32 midpoint, and c = 2^-80 tips it."""
    rng = np.random.default_rng(11)
    n = 4000
    a = rng.integers(0, 1 << 22, size=n).astype(np.float32)
    b = (rng.normal(size=n) * 2.0 ** rng.integers(-20, 10, size=n)
         ).astype(np.float32)
    c = (rng.normal(size=n).astype(np.float32) * a * b
         * 2.0 ** -rng.integers(0, 60, size=n)).astype(np.float32)
    c[: n // 4] = -(a * b)[: n // 4]          # cancel to the product's ulps
    a = np.append(a, [97.0, 97.0]).astype(np.float32)
    b = np.append(b, [172961 * 2.0 ** -24] * 2).astype(np.float32)
    c = np.append(c, [2.0 ** -80, -(2.0 ** -80)]).astype(np.float32)
    got = fma32(*(torch.as_tensor(v) for v in (a, b, c))).numpy()
    want = np.array([_f32(Fraction(float(x)) * Fraction(float(y))
                          + Fraction(float(z))) for x, y, z in zip(a, b, c)],
                    dtype=np.float32)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert float(got[-2]) == 1 + 2.0 ** -23 and float(got[-1]) == 1.0
    twice = (torch.as_tensor(a[-2:]).double() * torch.as_tensor(b[-2:])
             .double() + torch.as_tensor(c[-2:]).double()).float()
    assert float(twice[0]) == 1.0


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_one_slot_sets_keep_the_fmaf_signs(layout):
    """Sets of one selected slot each (an own slot, or a cross slot of one
    or both endpoints), half the keys with fields 0 and 1 equal, on weights
    that put z at or within a few ulps of 0 there:
    K1's emulated sum is relu of the fmaf-order z, so its sign decisions
    are that order's at every slot-channel, to the bit where rechecked;
    the tensor-core z alone decides others (chip_smoke.py holds the card to
    the same, `k1_decisions`)."""
    nw, ns = LAYOUTS[layout]
    shift = int(nw).bit_length()
    rng = np.random.default_rng(8)
    q, b = 2, 64
    kown, _, kcross, _, _, roots = _case(rng, layout, q, b)
    fm = np.uint32((1 << shift) - 1)
    for k in (kown, kcross):              # fields 0 and 1 agree in half
        half = rng.random(k.shape) < 0.5
        k[half] = (k[half] & ~(fm << np.uint32(shift))) | (
            (k[half] & fm) << np.uint32(shift))
    u = _near_zero_u(rng, nw, ns)
    mown = np.zeros((q, b, L), bool)
    mcross = np.zeros((q, b, 2 * L), bool)
    own = rng.random((q, b)) < 0.5
    at_own = rng.integers(0, L, size=(q, b))
    at_cross = rng.integers(0, 2 * L, size=b)
    for i in range(q):
        mown[i, np.arange(b), at_own[i]] = own[i]
        mcross[i, np.arange(b), at_cross] = ~own[i]
    args = (_t(kown), torch.as_tensor(mown), _t(kcross),
            torch.as_tensor(mcross), u)
    got = sum_fwd_tc(*args, shift, *roots)
    ncol = u.shape[0] - 2
    fo = _fields(args[0], shift, ncol, roots[0])      # [Q, B, L, ncol]
    fc = _fields(args[2], shift, ncol, roots[1])      # [B, 2L, ncol]
    f = torch.where(torch.as_tensor(own)[..., None],
                    fo[torch.arange(q)[:, None], torch.arange(b),
                       torch.as_tensor(at_own)],
                    fc[torch.arange(b), torch.as_tensor(at_cross)][None])
    zf = zed_fmaf(f, u)                               # [Q, B, H]
    tc_only, near = zed_k1(f, u, shift, recheck=False)[0], \
        zed_k1(f, u, shift)[1]
    assert torch.equal(got > 0, zf > 0)
    assert torch.equal(got[near], torch.relu(zf)[near])
    assert int(near.sum()) > 0
    assert int(((tc_only > 0) != (zf > 0)).sum()) > 0
