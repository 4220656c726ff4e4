"""PyTorch port, the LSTM forwards on the tensor cores (K4, K5: the step
loop of csrc/lstm_keys.cuh), and the training stash in row groups: the
numerics and layouts of their design, checked on the CPU.

The forward takes gates = [x_t | h] [wi; wh] + bh a k-step (8 channels) at
a time on the tensor cores in 3xTF32: a b = a_small b_big + a_big b_small
+ a_big b_big, with a_big = a rounded to TF32 and a_small = a - a_big,
which the tensor core reads truncated; each k-step's three terms are
summed in a fresh accumulator in that order and added to the step's sum,
which starts at bh, the x k-steps first; the cell in fp32. That arithmetic,
emulated here over a few rows at the bench width (h = H = 96, L = 301 and
L = 801, uneven lengths, holes, an empty row), is held to the fp32 plain
versions and to JAX's `lstm_final_hidden` and `lstm_from_keys` (Pallas
interpret mode, impl t1) on the same numpy-made inputs, in both key
layouts. The same with one TF32 product is shown to miss the tolerance.

The weights' fragment order (`fragment_order`) is held to the mma
fragments it must feed, lane by lane, and the layout constants to the
header. The backward over row groups (the stash budget's repair) is held
to the whole backward with the plain versions on row slices.

Tolerance: rtol = atol = 1e-4 on the final h, as chip_smoke.py holds the
kernels to their plain versions on the card (LSTM_TOL); gradients within
1e-5 of each tensor's largest entry (fp32 sums in another order).
"""

import re
from pathlib import Path

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
    MAX_NCOL,
    NEG,
    fused_key_hidden_slots_plain,
    u_core_rows,
)
from surel_plus_tpu_torch.ops.kernels.lstm import (
    lstm_final_hidden_bwd_plain,
    lstm_final_hidden_plain,
)
from surel_plus_tpu_torch.ops.kernels.lstm_keys import (
    add_grads,
    bwd_layout,
    fragment_order,
    lstm_from_keys_bwd_plain,
    lstm_from_keys_plain,
    row_ends,
    row_groups,
    row_order,
    stash_group,
)
from surel_plus_tpu_torch.ops.walk import enc_field_layout
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-4
GRAD_TOL = 1e-5
CSRC = Path(lstm_keys.__file__).resolve().parents[2] / "csrc"
W_BENCH = 96


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 by truncation (how the tensor core reads an fp32
    operand)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 rounded to nearest, ties away (cvt.rna.tf32.f32, and
    the forward's `split_rn`)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _ksteps(a: torch.Tensor) -> torch.Tensor:
    """a [n, K] zero-padded to whole k-steps: [n, K/8 up, 8]."""
    n, k = a.shape
    nk = -(-k // 8)
    out = a.new_zeros(n, nk * 8)
    out[:, :k] = a
    return out.reshape(n, nk, 8)


def _terms(a, w, single):
    """a [R, K] @ w [K, 4H] as the kernel adds it: per k-step j the terms
    [j][t] [R, 4H], t = a_small b_big, a_big b_small, a_big b_big, with
    x_big = x rounded to TF32 (`split_rn`) and x_small = x - x_big, read
    truncated (single: one product of TF32-rounded operands)."""
    ak = _ksteps(a)                                  # [R, nk, 8]
    wk = _ksteps(w.T).permute(1, 2, 0)               # [nk, 8, 4H]
    mm = lambda x, y: torch.einsum("rjk,jkn->jrn", x, y)
    if single:
        return [(t,) for t in mm(tf32_rna(ak), tf32_rna(wk))]
    ab, wb = tf32_rna(ak), tf32_rna(wk)
    asm, wsm = tf32_trunc(ak - ab), tf32_trunc(wk - wb)
    return list(zip(mm(asm, wb), mm(ab, wsm), mm(ab, wb)))


def _sigmoid(v):
    return 1.0 / (1.0 + torch.exp(-v))


def forward_tc(x, mask, wi, wh, bh, single=False):
    """Final h [R, H] of the masked LSTM over x [R, L, h] (fp32) in the
    forward kernels' arithmetic: the gate products in 3xTF32 (or single
    TF32), k-step by k-step in the kernel's order from bh, then the
    cell."""
    r, ell, _ = x.shape
    hh = wh.shape[0]
    c = torch.zeros(r, hh)
    h = torch.zeros(r, hh)
    for t in range(ell):
        acc = bh.expand(r, 4 * hh).clone()
        for a, w in ((x[:, t], wi), (h, wh)):
            for step in _terms(a, w, single):
                part = step[0]
                for term in step[1:]:
                    part = part + term
                acc = acc + part     # a fresh accumulator a k-step
        gi, gf, gg, go = acc.chunk(4, dim=-1)
        nc = _sigmoid(gf) * c + _sigmoid(gi) * torch.tanh(gg)
        nh = _sigmoid(go) * torch.tanh(nc)
        keep = mask[:, t, None]
        c = torch.where(keep, nc, c)
        h = torch.where(keep, nh, h)
    return h


def _close(got, want, tol=TOL):
    got = torch.as_tensor(np.array(got))
    want = torch.as_tensor(np.array(want))
    return bool(torch.allclose(got, want, rtol=tol, atol=tol))


def _masks(rng, shape, ell):
    """Uneven lengths with holes, the first row empty, one row valid at its
    last slot only."""
    lens = rng.integers(1, ell + 1, size=shape)
    mask = (np.arange(ell) < lens[..., None]) & (
        rng.random(shape + (ell,)) < 0.8)
    flat = mask.reshape(-1, ell)
    flat[0] = False
    flat[1] = False
    flat[1, -1] = True
    return mask


def _x_case(seed, ell, r=8, h=W_BENCH, hh=W_BENCH):
    """K5's operands: x [r, ell, h], the masks, weights at a scale that
    keeps |gate| about 0.5."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(r, ell, h)).astype(np.float32)
    w = lambda *s: (0.1 * rng.normal(size=s)).astype(np.float32)
    ops = (x, _masks(rng, (r,), ell), w(h, 4 * hh), w(hh, 4 * hh),
           w(4 * hh))
    return tuple(torch.as_tensor(a) for a in ops)


KEY_LAYOUTS = {"lo_only": (100, 3), "lead_in_hi": (200, 4)}


def _key_case(layout, seed, ell, q=2, b=4, hh=W_BENCH):
    """K4's operands at the bench width: keys with every field used in the
    layout of M walks of S' steps (root planes in the lead-in-hi layout),
    the masks, U from a hidden layer, folded weights."""
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

    mask = torch.as_tensor(_masks(rng, (q, b), ell))
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
    return (keys(), keys(), mask, u, w(hh, 4 * hh), w(hh, 4 * hh),
            w(4 * hh), shift, *roots)


def _key_rows(args):
    """K4's hidden rows x [Q B, L, h] and masks [Q B, L] (the plain
    version's), for the emulation."""
    kown, kc, mask, u, _, _, _, shift, ro, rc = args
    q, b, ell = kown.shape
    x = fused_key_hidden_slots_plain(kown, kc, u, shift, root_own=ro,
                                     root_cross=rc)
    return x.reshape(q * b, ell, -1), mask.reshape(q * b, ell)


def _jax(*ts):
    return [jnp.asarray(t.numpy()) for t in ts]


# ------------------------------------------------ the arithmetic, vs fp32

@pytest.mark.parametrize("ell", [301, 801])
def test_3xtf32_forward_holds_to_fp32_and_jax(ell):
    """K5's function: the emulated kernel arithmetic against the fp32
    plain version and JAX's lstm_final_hidden; the empty row exactly 0."""
    x, mask, wi, wh, bh = _x_case(1, ell)
    got = forward_tc(x, mask, wi, wh, bh)
    assert _close(got, lstm_final_hidden_plain(x, mask, wi, wh, bh))
    want = jax_lstm_final_hidden(*_jax(x, mask, wi, wh, bh), chunk=32,
                                 interpret=True)
    assert _close(got, want)
    assert bool((got[0] == 0).all())


@pytest.mark.parametrize("ell", [301, 801])
@pytest.mark.parametrize("layout", sorted(KEY_LAYOUTS))
def test_3xtf32_keys_forward_holds_to_fp32_and_jax(layout, ell):
    """K4's function through the keys: the emulation over the hidden rows
    against the fp32 plain version and JAX's lstm_from_keys."""
    args = _key_case(layout, 2, ell)
    kown, kc, mask, u, wi, wh, bh, shift, ro, rc = args
    x, flat = _key_rows(args)
    got = forward_tc(x, flat, wi, wh, bh).reshape(kown.shape[0],
                                                  kown.shape[1], -1)
    assert _close(got, lstm_from_keys_plain(*args))
    jr = {} if ro is None else dict(zip(("root_own", "root_cross"),
                                        _jax(ro, rc)))
    want = jax_lstm_from_keys(*_jax(kown, kc, mask, u, wi, wh, bh), shift,
                              interpret=True, impl="t1", **jr)
    assert _close(got, want)


def test_single_tf32_misses_the_tolerance():
    """Why the kernels split: one TF32 product a term misses 1e-4 on the
    same inputs at L = 301."""
    x, mask, wi, wh, bh = _x_case(1, 301)
    want = lstm_final_hidden_plain(x, mask, wi, wh, bh)
    got = forward_tc(x, mask, wi, wh, bh, single=True)
    assert not _close(got, want)
    assert float((got - want).abs().max()) > TOL


# ----------------------------------------------------- the fragment order

def _mma_from_fragments(a, f, k, hh):
    """a [16, K] @ W [K, 4H] assembled as the kernel does it from the
    lanes' fragments: A from row-major a with k-step kk's fragment k c
    at channel 8kk + 2c and c + 4 at 8kk + 2c + 1 (a0 = row g, a1 = row
    g + 8, a2, a3 the same at k c + 4), B from the fragment order f (b0 at
    k c, b1 at k c + 4, column g), each n-tile (gate q, unit tile n) to
    columns q H + 8n + 0..7. Also checks that the accumulator a lane holds
    for unit tile n is, word for word, its A fragment of k-step n."""
    nk, nu = -(-k // 8), -(-hh // 8)
    ap = torch.zeros(16, nk * 8, dtype=torch.float64)
    ap[:, :k] = a
    f = f.reshape(nk, nu, 2, 32, 4).double()
    out = torch.zeros(16, 4, nu * 8, dtype=torch.float64)
    for kk in range(nk):
        at = torch.zeros(16, 8, dtype=torch.float64)   # the mma's A tile
        for lane in range(32):
            g, c = lane // 4, lane % 4
            at[g, c], at[g + 8, c] = ap[g, 8 * kk + 2 * c], ap[
                g + 8, 8 * kk + 2 * c]
            at[g, c + 4], at[g + 8, c + 4] = ap[g, 8 * kk + 2 * c + 1], ap[
                g + 8, 8 * kk + 2 * c + 1]
        for n in range(nu):
            for q in range(4):
                bt = torch.zeros(8, 8, dtype=torch.float64)
                for lane in range(32):
                    g, c = lane // 4, lane % 4
                    v = f[kk, n, q // 2, lane]
                    bt[c, g], bt[c + 4, g] = v[2 * (q % 2)], v[
                        2 * (q % 2) + 1]
                out[:, q, 8 * n:8 * n + 8] += at @ bt
    for lane in range(32):    # accumulator (g, 2c), (g, 2c+1), (g+8, ...)
        g, c = lane // 4, lane % 4
        for n in range(nu):
            acc = {(g, 8 * n + 2 * c), (g, 8 * n + 2 * c + 1),
                   (g + 8, 8 * n + 2 * c), (g + 8, 8 * n + 2 * c + 1)}
            frag = {(g, 8 * n + 2 * c), (g + 8, 8 * n + 2 * c),
                    (g, 8 * n + 2 * c + 1), (g + 8, 8 * n + 2 * c + 1)}
            assert acc == frag
    return out[:, :, :hh].reshape(16, 4 * hh)


@pytest.mark.parametrize("k, hh", [(96, 96), (30, 40), (8, 5)])
def test_fragment_order_feeds_the_mma_fragments(k, hh):
    rng = np.random.default_rng(k)
    a = torch.as_tensor(rng.normal(size=(16, k)))
    w = torch.as_tensor(rng.normal(size=(k, 4 * hh)).astype(np.float32))
    f = fragment_order(w, hh)
    assert f.dtype == torch.float32
    assert f.numel() == -(-k // 8) * -(-hh // 8) * 256
    got = _mma_from_fragments(a, f, k, hh)
    torch.testing.assert_close(got, a @ w.double(), rtol=1e-12, atol=1e-12)


# ------------------------------------------------ the layout's mirror

def _constants(text):
    return {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", text)}


def test_forward_constants_mirror_the_header():
    text = (CSRC / "lstm_keys.cuh").read_text()
    c = _constants(text)
    assert c["kWarpRows"] == lstm_keys.WARP_ROWS == 16
    assert c["kFwdGroups"] == lstm_keys.FWD_GROUPS
    assert c["kResidentUnits"] == lstm_keys.RESIDENT_UNITS
    assert c["kStashRows"] == lstm_keys.STASH_ROWS
    assert c["kMaxH"] == lstm_keys.MAX_H
    assert c["kMaxNcol"] == MAX_NCOL
    limit = re.search(r"constexpr int kMaxSmem = (\d+) - (\d+);", text)
    assert int(limit[1]) - int(limit[2]) == lstm_keys.SMEM_LIMIT
    # the resident path's words fit at the bench width, U of 8 fields too
    assert lstm_keys.block_layout(96, 96, MAX_NCOL)["resident"]


def test_row_ends_and_order():
    """Each row's last valid slot + 1 (0 when none), the order longest
    first, stable."""
    mask = torch.zeros(5, 6, dtype=torch.bool)
    mask[0, :2] = True
    mask[1, 4] = True
    mask[3, :5] = True
    mask[4, 1] = True
    ends = row_ends(mask)
    assert ends.tolist() == [2, 5, 0, 5, 2] and ends.dtype == torch.int32
    assert row_order(mask, ends).tolist() == [1, 3, 0, 4, 2]


# ------------------------------------------------ the stash in row groups

def test_stash_groups_keep_the_bench_widths_whole():
    """The budget from shapes alone: the bench width (5.7 GB of stash) and
    L = 801 (15.1 GB) keep one group; the general layout's L = 4001 (75.5
    GB) runs in groups of whole stash blocks."""
    gb = lambda rows, ell: 4 * bwd_layout(rows, ell, 1, 96, None)[
        "stash"] / 1e9
    assert round(gb(8192, 301), 1) == 5.7 and round(gb(8192, 801), 1) == 15.1
    assert round(gb(8192, 4001), 1) == 75.5
    assert stash_group(8192, 301, 96) == 8192
    assert stash_group(8192, 801, 96) == 8192
    group = stash_group(8192, 4001, 96)
    assert group % lstm_keys.STASH_ROWS == 0 and group < 8192
    assert 4 * bwd_layout(group, 4001, 1, 96, None)["stash"] \
        <= lstm_keys.STASH_BUDGET
    assert len(row_groups(torch.arange(8192, dtype=torch.int32),
                          group)) == -(-8192 // group) == 5


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_grouped_backward_equals_the_whole():
    """K5's backward over row groups of the sorted rows (the plain version
    on each group's rows, the weight gradients added in order, dx written
    by row) against the whole backward."""
    x, mask, wi, wh, bh = _x_case(3, 41, r=19, h=12, hh=16)
    g = torch.as_tensor(np.random.default_rng(4).normal(
        size=(19, 16)).astype(np.float32))
    whole = lstm_final_hidden_bwd_plain(x, mask, wi, wh, bh, g)
    dx = torch.empty_like(x)
    grads = None
    for rows in row_groups(row_order(mask), 6):
        idx = rows.long()
        part = lstm_final_hidden_bwd_plain(x[idx], mask[idx], wi, wh, bh,
                                           g[idx])
        dx[idx] = part[0]
        grads = add_grads(grads, part[1:])
    for a, b in zip((dx, *grads), whole):
        assert _rel(a, b) <= GRAD_TOL


@pytest.mark.parametrize("layout", sorted(KEY_LAYOUTS))
def test_grouped_keys_backward_equals_the_whole(layout):
    """K4's backward (du, dwi, dwh, dbh) over row groups against the
    whole, both key layouts."""
    args = _key_case(layout, 5, 23, q=2, b=9, hh=8)
    kown, kc, mask, u, wi, wh, bh, shift, ro, rc = args
    q, b, ell = kown.shape
    g = torch.as_tensor(np.random.default_rng(6).normal(
        size=(q, b, 8)).astype(np.float32))
    whole = lstm_from_keys_bwd_plain(*args[:7], g, *args[7:])
    flat = lambda t: None if t is None else t.reshape(1, q * b, *t.shape[2:])
    grads = None
    for rows in row_groups(row_order(mask.reshape(q * b, ell)), 5):
        pick = lambda t: None if t is None else flat(t)[:, rows.long()]
        part = lstm_from_keys_bwd_plain(
            pick(kown), pick(kc), pick(mask), u, wi, wh, bh, pick(g), shift,
            root_own=pick(ro), root_cross=pick(rc))
        grads = add_grads(grads, part)
    for a, b_ in zip(grads, whole):
        assert _rel(a, b_) <= GRAD_TOL
