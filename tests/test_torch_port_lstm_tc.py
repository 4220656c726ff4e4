"""PyTorch port, the LSTM backwards on the tensor cores (K4 bwd, K5 bwd,
csrc/lstm_tc.cuh): the numerics of their design, checked on the CPU.

The kernels take every product of the backward (dh_prev = dgates wh^T,
dx = dgates wi^T, dwi += x^T dgates, dwh += h_prev^T dgates) on the tensor
cores in 3xTF32: a b = a_big b_big + a_big b_small + a_small b_big, with
a_big = a truncated to TF32 (the low 13 of its 23 mantissa bits cleared,
one LOP3 in the kernel) and a_small = a - a_big, which the tensor core
reads truncated to TF32 in turn; products of TF32 values are exact in
fp32 and accumulate in fp32. The kernel's conversion is truncation, not
cvt.rna.tf32.f32 (round to nearest, ties away from zero, which a single
TF32 product as cuBLAS takes it uses). Both roundings are emulated here
and held to hand-worked bit patterns.

The plain BPTT with its four products in emulated 3xTF32 is held to the
fp32 plain BPTT (`lstm_bptt_plain`, which tests/test_torch_port_lstm.py
and tests/test_torch_port_lstm_x_bwd.py hold to `jax.grad`) at the bench
widths (L=301, h=H=96, uneven lengths and holes), for K5's function and
for K4's through the keys in both key layouts, and to `jax.grad` of JAX's
`lstm_final_hidden` and `lstm_from_keys` (Pallas interpret mode) at small
sizes. The same with one TF32 product is shown to miss the tolerance,
which is why the kernels split. The Python mirror of the backward's
layout and scratch sizes is held to the C sources' constants and
documented sizes.

Tolerance: each gradient within 1e-4 of its largest entry, as
chip_smoke.py holds the kernels to the plain versions on the card
(LSTM_BWD_TOL).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surel_plus_tpu.ops.pallas.lstm_kernel import (
    lstm_final_hidden as jax_lstm_final_hidden,
)
from surel_plus_tpu.ops.pallas.lstm_kernel import (
    lstm_from_keys as jax_lstm_from_keys,
)
from surel_plus_tpu_torch.ops.kernels import lstm_keys
from surel_plus_tpu_torch.ops.kernels.hidden_sum import (
    NEG,
    _fields_ext,
    u_core_rows,
)
from surel_plus_tpu_torch.ops.kernels.lstm_keys import (
    LSTMStash,
    bwd_layout,
    dx_layout,
    lstm_bptt_plain,
)
from surel_plus_tpu_torch.ops.walk import enc_field_layout
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-4
CSRC = Path(lstm_keys.__file__).resolve().parents[2] / "csrc"


def bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def from_bits(b):
    return np.asarray(b, np.uint32).view(np.float32)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 as cvt.rna.tf32.f32: to the nearest of the values with
    10 mantissa bits, ties away from zero (add half of the dropped unit to
    the magnitude, then clear the 13 low bits; a carry moves into the
    exponent)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 by truncation: the 13 low mantissa bits cleared (the
    kernels' split, and how the tensor core reads an fp32 operand)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels take it: a_small b_big + a_big b_small +
    a_big b_big, each a product of TF32 values summed in fp32."""
    ab, bb = tf32_trunc(a), tf32_trunc(b)
    asm, bsm = tf32_trunc(a - ab), tf32_trunc(b - bb)
    return asm @ bb + ab @ bsm + ab @ bb


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with both operands rounded to TF32 once (rna)."""
    return tf32_rna(a) @ tf32_rna(b)


def bptt(x, mask, wi, wh, bh, g, mm=None):
    """`lstm_bptt_plain` with its four backward products through `mm`
    (None: fp32, the plain version itself). The forward stays fp32, as
    the kernels' forward does."""
    if mm is None:
        return lstm_bptt_plain(x, mask, wi, wh, bh, g)
    r, ell, _ = x.shape
    keep = mask.reshape(r, ell, 1)

    def activations(t, c, h):
        gates = x[:, t] @ wi + h @ wh + bh
        gi, gf, gg, go = gates.chunk(4, dim=-1)
        return (torch.sigmoid(gi), torch.sigmoid(gf), torch.tanh(gg),
                torch.sigmoid(go))

    c = torch.zeros(r, wh.shape[0], dtype=x.dtype)
    h = torch.zeros_like(c)
    carries = []
    for t in range(ell):
        carries.append((c, h))
        si, sf, tg, so = activations(t, c, h)
        nc = sf * c + si * tg
        c = torch.where(keep[:, t], nc, c)
        h = torch.where(keep[:, t], so * torch.tanh(nc), h)
    dh = g.reshape(r, -1).to(x.dtype)
    dc = torch.zeros_like(dh)
    dwi, dwh = torch.zeros_like(wi), torch.zeros_like(wh)
    dbh = torch.zeros_like(bh)
    dx = torch.empty_like(x)
    for t in reversed(range(ell)):
        cp, hp = carries[t]
        si, sf, tg, so = activations(t, cp, hp)
        tc = torch.tanh(sf * cp + si * tg)
        dnc = dc + dh * so * (1 - tc * tc)
        k = keep[:, t]
        dgates = torch.where(k, torch.cat(
            [dnc * tg * si * (1 - si), dnc * cp * sf * (1 - sf),
             dnc * si * (1 - tg * tg), dh * tc * so * (1 - so)], dim=-1), 0.0)
        dwi += mm(x[:, t].T, dgates)
        dwh += mm(hp.T, dgates)
        dbh += dgates.sum(dim=0)
        dx[:, t] = torch.where(k, mm(dgates, wi.T), 0.0)
        dh = torch.where(k, mm(dgates, wh.T), dh)
        dc = torch.where(k, dnc * sf, dc)
    return dx, dwi, dwh, dbh


def rel(got, want) -> float:
    """max |got - want| over want's largest entry."""
    got, want = torch.as_tensor(np.array(got)), torch.as_tensor(
        np.array(want))
    return float((got - want).abs().max() / want.abs().max())


# ------------------------------------------------------------ bit patterns

@pytest.mark.parametrize("src, want", [
    (0x3F800000, 0x3F800000),   # 1.0 is a TF32 value
    (0x3F800FFF, 0x3F800000),   # below half a unit: down
    (0x3F801000, 0x3F802000),   # exactly half: away from zero (not even)
    (0x3F801001, 0x3F802000),   # above half: up
    (0x3F803000, 0x3F804000),   # half above an odd unit: away
    (0xBF801000, 0xBF802000),   # negative tie: away from zero
    (0xBF800FFF, 0xBF800000),   # negative, below half
    (0x3FFFFFFF, 0x40000000),   # the carry moves into the exponent: 2.0
    (0x00000000, 0x00000000),   # +0
    (0x80000000, 0x80000000),   # -0 keeps its sign
], ids=lambda v: f"{v:#010x}")
def test_tf32_rna_bit_patterns(src, want):
    got = tf32_rna(torch.as_tensor(from_bits([src])))
    assert int(bits(got.numpy())[0]) == want


@pytest.mark.parametrize("src, want", [
    (0x3F801FFF, 0x3F800000),   # all dropped bits set: still down
    (0x3F802000, 0x3F802000),
    (0xBF801FFF, 0xBF800000),   # toward zero for negatives too
    (0x7F7FFFFF, 0x7F7FE000),   # the largest float: no carry
], ids=lambda v: f"{v:#010x}")
def test_tf32_trunc_bit_patterns(src, want):
    got = tf32_trunc(torch.as_tensor(from_bits([src])))
    assert int(bits(got.numpy())[0]) == want


def test_split_is_exact_and_small_is_tiny():
    """x = big + small exactly in fp32; big has no bit below TF32's; small,
    read truncated by the tensor core, loses under 2^-20 of |x|."""
    x = torch.as_tensor(np.random.default_rng(0).normal(
        size=100_000).astype(np.float32) * 10.0 ** np.random.default_rng(
            1).integers(-5, 5, size=100_000).astype(np.float32))
    big = tf32_trunc(x)
    small = x - big
    assert torch.equal(big + small, x)
    assert bool(((big.view(torch.int32) & 0x1FFF) == 0).all())
    lost = (small - tf32_trunc(small)).abs()
    assert float((lost / x.abs()).max()) < 2.0 ** -20


def test_3xtf32_product_is_fp32_accurate_and_tf32_is_not():
    rng = np.random.default_rng(2)
    a = torch.as_tensor(rng.normal(size=(64, 384)).astype(np.float32))
    b = torch.as_tensor(rng.normal(size=(384, 96)).astype(np.float32))
    want = (a.double() @ b.double())
    scale = float(want.abs().max())
    err3 = float((mm_3xtf32(a, b).double() - want).abs().max()) / scale
    err1 = float((mm_tf32(a, b).double() - want).abs().max()) / scale
    err32 = float(((a @ b).double() - want).abs().max()) / scale
    assert err3 < 4 * err32 + 1e-7
    assert err1 > 10 * err3


# ------------------------------------------------- the BPTT at bench width

R_BENCH, L_BENCH, W_BENCH = 24, 301, 96


def _x_operands(seed, r=R_BENCH, ell=L_BENCH, h=W_BENCH, hh=W_BENCH,
                scale=0.1):
    """K5's operands: x [r, ell, h], a mask with uneven lengths and holes
    (row 0 empty, row 1 valid at its last slot only, one full row), the
    weights at a scale that keeps |gate| about 0.5, a cotangent."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(r, ell, h)).astype(np.float32)
    lens = rng.integers(1, ell + 1, size=r)
    mask = (np.arange(ell)[None] < lens[:, None]) & (
        rng.random((r, ell)) < 0.8)
    mask[0] = False
    mask[1] = False
    mask[1, -1] = True
    mask[2] = True
    w = lambda *s: (scale * rng.normal(size=s)).astype(np.float32)
    g = rng.normal(size=(r, hh)).astype(np.float32)
    ops = (x, mask, w(h, 4 * hh), w(hh, 4 * hh), w(4 * hh))
    return tuple(torch.as_tensor(a) for a in ops), torch.as_tensor(g)


def test_3xtf32_bptt_holds_to_fp32_bptt_at_bench_width():
    """K5's function: dx, dwi, dwh, dbh."""
    ops, g = _x_operands(3)
    want = bptt(*ops, g)
    got = bptt(*ops, g, mm=mm_3xtf32)
    for name, a, b in zip(("dx", "dwi", "dwh", "dbh"), got, want):
        assert rel(a, b) <= TOL, name
    assert bool((got[0][~ops[1]] == 0).all())


def test_single_tf32_misses_the_tolerance_at_bench_width():
    """Why the kernels split: one TF32 product misses 1e-4 of a
    gradient's largest entry on the same inputs."""
    ops, g = _x_operands(3)
    want = bptt(*ops, g)
    got = bptt(*ops, g, mm=mm_tf32)
    errs = [rel(a, b) for a, b in zip(got[:3], want[:3])]
    assert max(errs) > TOL, errs


KEY_LAYOUTS = {"lo_only": (100, 3), "lead_in_hi": (200, 4)}


def _key_operands(layout, seed, q=2, b=12, ell=L_BENCH, hh=W_BENCH):
    """K4's operands at the bench width: keys with every field used in
    the layout of M walks of S' steps, their root planes in the lead-in-hi
    layout, masks with uneven lengths and holes, U from a hidden layer,
    and folded weights."""
    nw, ns = KEY_LAYOUTS[layout]
    shift, starts, lead_bit = enc_field_layout(nw, ns)
    rng = np.random.default_rng(seed)

    def keys():
        k = np.zeros((q, b, ell), np.uint32)
        for j in range(1, ns + 1):
            if starts[j] < 32:
                k |= rng.integers(0, nw + 1, size=k.shape).astype(
                    np.uint32) << np.uint32(starts[j])
        if lead_bit < 32:
            k |= rng.integers(0, 2, size=k.shape).astype(
                np.uint32) << np.uint32(lead_bit)
        return torch.as_tensor(k.view(np.int32))

    lens = rng.integers(1, ell + 1, size=(q, b))
    mask = (np.arange(ell)[None, None] < lens[..., None]) & (
        rng.random((q, b, ell)) < 0.8)
    mask[0, 0] = False
    roots = (None, None)
    if lead_bit == 32:
        roots = tuple(torch.as_tensor(rng.integers(
            0, 2, size=(q, b, ell)).astype(np.int32)) for _ in range(2))
    w1 = (rng.normal(size=(ns + 1, hh)) / nw).astype(np.float32)
    b1 = (0.1 * rng.normal(size=hh)).astype(np.float32)
    u = torch.cat([u_core_rows(torch.as_tensor(w1), nw, ns),
                   torch.full((1, hh), NEG), torch.as_tensor(b1)[None]])
    w = lambda *s: torch.as_tensor((0.1 * rng.normal(size=s)).astype(
        np.float32))
    g = torch.as_tensor(rng.normal(size=(q, b, hh)).astype(np.float32))
    return (keys(), keys(), torch.as_tensor(mask), u, w(hh, 4 * hh),
            w(hh, 4 * hh), w(4 * hh), shift, *roots), g


def keys_bwd(args, g, mm=None):
    """`lstm_from_keys_bwd_plain` with the BPTT's products through `mm`:
    dx back through each side's relu into dU in fp32, as the kernel's
    epilogue takes it."""
    kown, kc, mask, u, wi, wh, bh, shift, ro, rc = args
    q, b, ell = kown.shape
    r = q * b
    ncol = u.shape[0] - 2
    zero = torch.zeros(kown.shape, dtype=torch.bool)
    fo = _fields_ext(kown, zero, shift, ncol, ro).reshape(r * ell, -1)
    fc = _fields_ext(kc, zero, shift, ncol, rc).reshape(r * ell, -1)
    zo, zc = fo @ u, fc @ u
    x = (torch.relu(zo) + torch.relu(zc)).reshape(r, ell, -1)
    dx, dwi, dwh, dbh = bptt(x, mask.reshape(r, ell), wi, wh, bh, g, mm)
    dx = dx.reshape(r * ell, -1)
    du = (fo.T @ torch.where(zo > 0, dx, 0.0)
          + fc.T @ torch.where(zc > 0, dx, 0.0))
    return du, dwi, dwh, dbh


@pytest.mark.parametrize("layout", sorted(KEY_LAYOUTS))
def test_3xtf32_keys_bptt_holds_to_fp32_at_bench_width(layout):
    """K4's function through the keys, both key layouts: du, dwi, dwh,
    dbh; the plain fp32 version is `lstm_from_keys_bwd_plain` itself."""
    args, g = _key_operands(layout, seed=4)
    want = lstm_keys.lstm_from_keys_bwd_plain(*args[:7], g, *args[7:])
    for name, a, b in zip(("du", "dwi", "dwh"), keys_bwd(args, g), want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(
            b.abs().max()), msg=name)          # the emulation's fp32 twin
    got = keys_bwd(args, g, mm=mm_3xtf32)
    for name, a, b in zip(("du", "dwi", "dwh", "dbh"), got, want):
        assert rel(a, b) <= TOL, name
    ncol = args[3].shape[0] - 2
    assert bool((got[0][ncol] == 0).all())      # dU's masking row


# ----------------------------------------------- against JAX, small sizes

def test_3xtf32_bptt_holds_to_jax_grad_of_lstm_final_hidden():
    ops, g = _x_operands(5, r=9, ell=23, h=6, hh=8, scale=0.4)
    x, mask, wi, wh, bh = (jnp.asarray(a.numpy()) for a in ops)

    def loss(x, wi, wh, bh):
        return (jax_lstm_final_hidden(x, mask, wi, wh, bh, chunk=4,
                                      interpret=True)
                * jnp.asarray(g.numpy())).sum()

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(x, wi, wh, bh)
    got = bptt(*ops, g, mm=mm_3xtf32)
    for name, a, b in zip(("dx", "dwi", "dwh", "dbh"), got, want):
        assert rel(a, b) <= TOL, name


@pytest.mark.parametrize("layout", sorted(KEY_LAYOUTS))
def test_3xtf32_keys_bptt_holds_to_jax_grad_of_lstm_from_keys(layout):
    args, g = _key_operands(layout, seed=6, b=5, ell=11, hh=8)
    kown, kc, mask, u, wi, wh, bh, shift, ro, rc = args
    jr = {} if ro is None else dict(root_own=jnp.asarray(ro.numpy()),
                                    root_cross=jnp.asarray(rc.numpy()))
    keys = [jnp.asarray(t.numpy()) for t in (kown, kc, mask)]

    def loss(*weights):
        return (jax_lstm_from_keys(*keys, *weights, shift, interpret=True,
                                   impl="t1", **jr)
                * jnp.asarray(g.numpy())).sum()

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(t.numpy()) for t in (u, wi, wh, bh)))
    got = keys_bwd(args, g, mm=mm_3xtf32)
    for name, a, b in zip(("du", "dwi", "dwh", "dbh"), got, want):
        assert rel(a, b) <= TOL, name


# ------------------------------------------------- the layout's mirror

def _constants(text):
    return {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", text)}


def test_backward_constants_mirror_the_header():
    c = _constants((CSRC / "lstm_tc.cuh").read_text())
    assert c["kSweepWarps"] * 16 == lstm_keys.SWEEP_ROWS
    assert c["kDxBlocks"] == lstm_keys.DX_BLOCKS
    assert c["kDxTiles"] == lstm_keys.DX_TILES
    assert c["kDxWarps"] == lstm_keys.DX_WARPS
    assert (c["kWM"], c["kWN"]) == (64, 128)


def test_dx_layout_mirrors_the_kernel():
    """csrc/lstm_tc.cuh dx_layout_for: n-tile groups of 3, as many warp
    streams as fit in 16 warps."""
    assert dx_layout(96) == (4, 4, 16)
    assert dx_layout(256) == (11, 1, 11)
    assert dx_layout(20) == (1, 16, 16)
    assert dx_layout(30) == (2, 8, 16)


def test_bwd_layout_mirrors_the_documented_sizes():
    """The sizes the C entry points document, at the bench width (R =
    8192, L = 301, h = H = 96; ncol = 4 for the keys) and at h = H = 256:
    the stash padded rows x L x 6H; the sweep's 128 blocks of 64 rows
    with wh resident (150,528 bytes) beside dh and dc (53,248), or, at
    H = 256, dh and dc alone; dx's wi resident (150,528) and U; part1
    kDxBlocks x streams x (ncol + 2) h; part2 P x (4H + (h + H) 4H)."""
    k4 = bwd_layout(8192, 301, 96, 96, 4)
    k5 = bwd_layout(8192, 301, 96, 96, None)
    assert k4["stash"] == k5["stash"] == 8192 * 301 * 6 * 96
    assert k4["tend"] == 256 and k4["sweep_blocks"] == 128
    assert k4["sweep_smem"] == 150_528 + 53_248 == 203_776
    assert k5["dx_smem"] == 150_528
    assert k4["dx_smem"] == 150_528 + 6 * 96 * 4
    assert k4["part1"] == 132 * 4 * 6 * 96 and k5["part1"] == 0
    assert k4["parts"] == 64
    assert k4["part2"] == 64 * (384 + 192 * 384)
    assert k4["out"] == 6 * 96 + 384 + 192 * 384
    assert k5["out"] == 384 + 192 * 384
    wide = bwd_layout(512, 301, 256, 256, 4)
    assert wide["sweep_smem"] == 2 * 64 * 264 * 4   # wh from L2
    assert wide["dx_smem"] == 6 * 256 * 4           # wi from L2
    assert wide["stash"] == 16 * 32 * 301 * 6 * 256  # 32-row blocks
    assert wide["tend"] == 16
    odd = bwd_layout(1000, 7, 30, 40, 3)
    assert odd["stash"] == 32 * 32 * 7 * 6 * 40 and odd["tend"] == 32
    assert odd["parts"] == 64 and odd["sweep_blocks"] == 16


def test_a_stash_is_taken_once():
    """The backward writes the gates' gradients over the stashed gates, so
    a stash serves one backward."""
    st = LSTMStash(torch.zeros(6), torch.zeros(1, dtype=torch.int32), None)
    assert st.take() is st
    with pytest.raises(RuntimeError, match="used by a backward already"):
        st.take()


def test_no_grad_and_frozen_weights_keep_no_stash():
    """The forward keeps a stash only where autograd will ask for a
    gradient: not under no_grad, not when no weight needs one."""
    w = torch.zeros(3, requires_grad=True)
    assert lstm_keys.needs_grad(w)
    with torch.no_grad():
        assert not lstm_keys.needs_grad(w)
    assert not lstm_keys.needs_grad(torch.zeros(3))
