"""PyTorch port, the hidden-layer backwards on the tensor cores (K7 bwd,
csrc/hidden_slots_bwd.cu, and K1 bwd, csrc/hidden_sum_bwd.cu, on
csrc/hidden_tc.cuh): the numerics of their design, checked on the CPU.

Both kernels take dU^T = dZ^T F_ext on mma.sync.m16n8k8 in TF32: the
fields are integers, exact in TF32 below 2^11 (and split in two exact
parts above); dZ is exact in TF32 for a bf16 cotangent and split in two
TF32 parts otherwise (big = dZ truncated, small = dZ - big, read truncated
by the tensor core); each slab of slots (a K7 bwd tile of `tile_slots`
slots, both sides; a K1 bwd batch of whole k-steps of 8 compacted slots,
taken after each 32-slot tile) goes into a fresh accumulator, and the
slabs, a block's warps and the blocks' partials are added in fp32. z is
recomputed in the forwards' fmaf order, so its relu decisions are the
forwards' (no relu flips to count). The emulations below take those
products in that order and are held to the fp32 plain backwards and to
the JAX package's VJPs (Pallas interpret mode) at L = 301, H = 96, a small
B, both key layouts, Q = 2 and 4; one TF32 product of dZ (rounded to the
nearest TF32 value, as cuBLAS takes it) is shown to miss the tolerance
(by 1.7-3x here), while the split stays within a hundredth of it.
The Python mirror of the kernels' layout is held to the header.

Tolerance: dU within 1e-4 of each row's largest entry, as chip_smoke.py
holds the kernels to the plain versions on the card (K1B_TOL, K7B_TOL);
the masking row exactly 0.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surel_plus_tpu.ops.pallas.hidden_sum_kernel import (
    fused_key_hidden_slots as jax_fused_key_hidden_slots,
)
from surel_plus_tpu.ops.pallas.hidden_sum_kernel import (
    fused_key_hidden_sum as jax_fused_key_hidden_sum,
)
from surel_plus_tpu.ops.walk import enc_field_layout
from surel_plus_tpu_torch.ops.kernels import hidden_sum as hs
from surel_plus_tpu_torch.ops.kernels.hidden_sum import (
    NEG,
    _fields_ext,
    fused_key_hidden_slots_bwd_plain,
    fused_key_hidden_sum_bwd_plain,
    u_core_rows,
)
from test_torch_port_lstm_tc import tf32_rna, tf32_trunc
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-4
CSRC = Path(hs.__file__).resolve().parents[2] / "csrc"
# (num_walks, num_steps) of the bench's lo-only sets (M=100, S'=3: three
# 7-bit fields and the root bit) and of the lead-in-hi ones (M=200, S'=4:
# four 8-bit fields fill the lo word, the root comes from a plane)
LAYOUTS = {"lo_only": (100, 3), "lead_in_hi": (200, 4)}
B, L, H = 2, 301, 96


def _keys(rng, shape, nw, ns):
    """Packed lo keys: every field up to nw, the root bit where it lies in
    the lo word, about a fifth of the keys 0."""
    _, starts, lead_bit = enc_field_layout(nw, ns)
    k = np.zeros(shape, np.uint32)
    for j in range(1, ns + 1):
        k |= rng.integers(0, nw + 1, size=shape).astype(
            np.uint32) << np.uint32(starts[j])
    if lead_bit < 32:
        k |= rng.integers(0, 2, size=shape).astype(np.uint32) << np.uint32(
            lead_bit)
    k[rng.random(shape) < 0.2] = 0
    return k


def _u_ext(rng, nw, ns):
    w1 = torch.as_tensor(rng.normal(size=(ns + 1, H)).astype(np.float32))
    b1 = torch.as_tensor(0.2 * rng.normal(size=(1, H)).astype(np.float32))
    return torch.cat([u_core_rows(w1, nw, ns), torch.full((1, H), NEG), b1])


def _roots(rng, layout, *keys):
    """int32 0/1 root planes (0 where the key is 0) in the lead-in-hi
    layout, else None."""
    if layout != "lead_in_hi":
        return [None] * len(keys)
    return [torch.as_tensor(np.where(k == 0, 0, rng.integers(
        0, 2, size=k.shape)).astype(np.int32)) for k in keys]


def _t(k):
    return torch.as_tensor(k.view(np.int32))


def _row_err(got, want):
    """Largest |got - want| over each dU row's largest |want|."""
    scale = want.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
    return float(((got - want).abs() / scale).max())


# ------------------------------------------------ the kernels' arithmetic

def _contract(dz, fe, mode, fsplit):
    """A slab's fresh accumulator, fe^T dz [C, H] in fp32 (a batch of
    slabs: [..., C, H]), as the kernels' mma products take it. mode
    "exact": dz is exact in TF32 (a bf16 cotangent), one product; "split":
    dz = big + small, the small term first; "single": dz rounded to TF32
    once. fsplit: the fields' small parts too (shift > 11)."""
    fb = tf32_trunc(fe)
    fs = tf32_trunc(fe - fb)
    if mode == "exact":
        assert torch.equal(tf32_trunc(dz), dz)
        parts = [dz]
    elif mode == "split":
        big = tf32_trunc(dz)
        parts = [big, tf32_trunc(dz - big)]
    else:
        parts = [tf32_rna(dz)]
    acc = torch.zeros(*fe.shape[:-2], fe.shape[-1], dz.shape[-1])
    if len(parts) == 2:
        acc += fb.mT @ parts[1]
    if fsplit:
        acc += fs.mT @ parts[0]
    acc += fb.mT @ parts[0]
    return acc


def _to_du(parts, ncol):
    """Partials [n, ncol + 1, H] -> dU [ncol + 2, H]: kernel blocks of
    TC_WARPS streams added in warp order, then the blocks; the masking
    row 0."""
    n = parts.shape[0]
    pad = -n % hs.TC_WARPS
    parts = torch.cat([parts, parts.new_zeros(pad, *parts.shape[1:])])
    blocks = parts.reshape(-1, hs.TC_WARPS, *parts.shape[1:])
    acc = blocks[:, 0].clone()
    for w in range(1, hs.TC_WARPS):
        acc += blocks[:, w]
    tot = acc.sum(dim=0)
    du = torch.zeros(ncol + 2, tot.shape[1])
    du[:ncol] = tot[:ncol]
    du[ncol + 1] = tot[ncol]
    return du


def _fields_cols(keys, shift, ncol, root):
    """F_ext's columns [..., ncol + 1]: the fields, then the bias column,
    and z's operand [..., ncol + 2] (the masking column 0)."""
    fo = _fields_ext(keys, torch.zeros(keys.shape, dtype=torch.bool),
                     shift, ncol, root)
    return torch.cat([fo[..., :ncol], fo[..., ncol + 1:]], dim=-1), fo


def slots_bwd_tc(kown, kc, u_ext, g, shift, root_own=None, root_cross=None,
                 mode=None):
    """K7 bwd's arithmetic: tiles of `tile_slots` slots of the flattened
    [Q, B, L], both sides of a slot in one fresh accumulator, a warp a
    tile (the grid's warps outnumber the tiles here)."""
    ncol, h = u_ext.shape[0] - 2, u_ext.shape[1]
    if mode is None:
        mode = "exact" if g.dtype == torch.bfloat16 else "split"
    ts = hs.tile_slots(ncol, g.element_size())
    gf = g.float().reshape(-1, h)
    cols, dzs = [], []
    for keys, root in ((kown, root_own), (kc, root_cross)):
        fe, fo = _fields_cols(keys.reshape(-1), shift, ncol,
                              None if root is None else root.reshape(-1))
        cols.append(fe)
        dzs.append(torch.where(fo @ u_ext > 0, gf, 0.0))
    n = gf.shape[0]
    assert -(-n // ts) <= hs.SLOTS_BWD_PARTS * hs.TC_WARPS
    # the tiles' rows (both sides), the last one padded with zero rows
    tile = lambda x: torch.cat([x, x.new_zeros(-n % ts, x.shape[1])]
                               ).reshape(-1, ts, x.shape[1])
    dz = torch.cat([tile(dzs[0]), tile(dzs[1])], dim=1)
    fe = torch.cat([tile(cols[0]), tile(cols[1])], dim=1)
    return _to_du(_contract(dz, fe, mode, shift > hs.TC_EXACT_SHIFT), ncol)


def sum_bwd_tc(kown, mown, kcross, mcross, u_ext, g, shift, root_own=None,
               root_cross=None, mode="split"):
    """K1 bwd's arithmetic: a warp a query row walks the cross plane, then
    each endpoint's own row, in 32-slot tiles; the selected slots queue up
    in order, and after each tile its whole k-steps of 8 go into one fresh
    accumulator (the rest waits); the row's last entries are padded. dz =
    (z > 0) * G[bits], G[m] the sum of g over the endpoints in m, q
    ascending."""
    q, b, lo = kown.shape
    ncol, h = u_ext.shape[0] - 2, u_ext.shape[1]
    fsplit = shift > hs.TC_EXACT_SHIFT
    fe_o, fo_o = _fields_cols(kown, shift, ncol, root_own)
    fe_c, fo_c = _fields_cols(kcross, shift, ncol, root_cross)
    z_o, z_c = fo_o @ u_ext, fo_c @ u_ext
    bits_c = sum(mcross[i].to(torch.int64) << i for i in range(q))
    rows = []
    for r in range(b):
        tab = torch.zeros(1 << q, h)
        for m in range(1, 1 << q):
            for i in range(q):
                if (m >> i) & 1:
                    tab[m] += g[i, r]
        segs = [(fe_c[r], z_c[r], bits_c[r])]
        segs += [(fe_o[i, r], z_o[i, r], mown[i, r].to(torch.int64) << i)
                 for i in range(q)]
        queue_f, queue_dz, slabs = [], [], []
        for fe, z, bits in segs:
            for t in range(0, fe.shape[0], 32):
                sel = torch.nonzero(bits[t:t + 32]).flatten() + t
                queue_f += [fe[sel]]
                queue_dz += [torch.where(z[sel] > 0, tab[bits[sel]], 0.0)]
                f, dz = torch.cat(queue_f), torch.cat(queue_dz)
                whole = f.shape[0] // 8 * 8
                if whole:
                    slabs.append(_contract(dz[:whole], f[:whole], mode,
                                           fsplit))
                queue_f, queue_dz = [f[whole:]], [dz[whole:]]
        if queue_f[0].shape[0]:
            slabs.append(_contract(queue_dz[0], queue_f[0], mode, fsplit))
        run = torch.zeros(ncol + 1, h)
        for s in slabs:
            run += s
        rows.append(run)
    return _to_du(torch.stack(rows), ncol)


# ------------------------------------------------------------ the tests

def test_fields_exact_in_tf32_up_to_shift_11():
    """Every field value below 2^shift is a TF32 value up to shift 11, not
    at 12; there its two parts (truncated, rest) are exact."""
    for shift in range(1, 13):
        v = torch.arange(1 << shift, dtype=torch.float32)
        exact = bool(torch.equal(tf32_trunc(v), v))
        assert exact == (shift <= hs.TC_EXACT_SHIFT), shift
    big = tf32_trunc(v)
    assert torch.equal(big + tf32_trunc(v - big), v)
    assert not torch.equal(big, v)


def test_dz_split_in_two_tf32_parts():
    """A bf16 cotangent is a TF32 value (one product is exact); an fp32
    one in two parts as the kernels split it keeps all but the last bits,
    and the small part is the rest exactly."""
    x = torch.as_tensor(np.random.default_rng(0).normal(
        size=100_000).astype(np.float32))
    xb = x.bfloat16().float()
    assert torch.equal(tf32_trunc(xb), xb)
    big = tf32_trunc(x)
    small = x - big
    assert torch.equal(big + small, x)
    rel = ((big + tf32_trunc(small) - x).abs() / x.abs()).max()
    assert float(rel) <= 2.0 ** -21
    assert float(((tf32_rna(x) - x).abs() / x.abs()).max()) > 2.0 ** -12


_JAX_SLOTS_VJP = {}


def _jax_slots_du(layout, kown, kc, u_ext, g, shift, roots):
    """JAX's VJP of `fused_key_hidden_slots` (interpret mode), jitted once
    a layout and shape."""
    key = (layout, kown.shape)
    if key not in _JAX_SLOTS_VJP:
        def du(k1, k2, u, ct, r1, r2):
            jr = {} if r1 is None else dict(root_own=r1, root_cross=r2)
            _, vjp = jax.vjp(lambda uj: jax_fused_key_hidden_slots(
                k1, k2, uj, shift, interpret=True, **jr), u)
            return vjp(ct)[0]
        _JAX_SLOTS_VJP[key] = jax.jit(du)
    r1, r2 = (None, None) if roots[0] is None else (
        jnp.asarray(roots[0].numpy()), jnp.asarray(roots[1].numpy()))
    return torch.as_tensor(np.array(_JAX_SLOTS_VJP[key](
        jnp.asarray(kown), jnp.asarray(kc), jnp.asarray(u_ext.numpy()),
        jnp.asarray(g.float().numpy()), r1, r2)))


@pytest.mark.parametrize("q", [2, 4])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_slots_bwd_emulation_matches_plain_and_jax(layout, q):
    """K7 bwd's products as the kernel takes them, with a bf16 cotangent
    (one exact product) and an fp32 one (split), against the fp32 plain
    backward and JAX's VJP; one TF32 product of an fp32 dZ misses."""
    nw, ns = LAYOUTS[layout]
    shift = int(nw).bit_length()
    rng = np.random.default_rng(10 + q)
    kown = _keys(rng, (q, B, L), nw, ns)
    kc = _keys(rng, (q, B, L), nw, ns)
    roots = _roots(rng, layout, kown, kc)
    u = _u_ext(rng, nw, ns)
    g32 = torch.as_tensor(rng.normal(size=(q, B, L, H)).astype(np.float32))
    args = (_t(kown), _t(kc), u)
    for g in (g32.bfloat16(), g32):
        want = fused_key_hidden_slots_bwd_plain(*args, g, shift, *roots)
        jax_du = _jax_slots_du(layout, kown, kc, u, g, shift, roots)
        got = slots_bwd_tc(*args, g, shift, *roots)
        assert _row_err(got, want) <= TOL and _row_err(got, jax_du) <= TOL
        assert _row_err(want, jax_du) <= TOL
        assert bool((got[ns + 1] == 0).all())
    split = _row_err(slots_bwd_tc(*args, g32, shift, *roots), want)
    single = _row_err(slots_bwd_tc(*args, g32, shift, *roots,
                                   mode="single"), want)
    assert split <= TOL / 100 and single > TOL, (split, single)


@pytest.mark.parametrize("q", [2, 4])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sum_bwd_emulation_matches_plain_and_jax(layout, q):
    """K1 bwd's compacted slots, slabs and products as the kernel takes
    them (dZ split), against the fp32 plain backward and jax.grad of JAX's
    kernel; a set all masked, a query row selecting no slot; one TF32
    product of dZ misses."""
    nw, ns = LAYOUTS[layout]
    shift = int(nw).bit_length()
    rng = np.random.default_rng(20 + q)
    b = B + 1
    kown = _keys(rng, (q, b, L), nw, ns)
    kcross = _keys(rng, (b, 2 * L), nw, ns)
    mown = rng.random((q, b, L)) < 0.4
    pick = rng.integers(0, q + 2, size=(b, 2 * L))
    mcross = np.stack([pick == i for i in range(q)])
    mown[0, 0] = False                  # endpoint 0 of row 0: all masked
    mown[:, b - 1] = False              # the last row selects nothing
    mcross[:, b - 1] = False
    roots = _roots(rng, layout, kown, kcross)
    u = _u_ext(rng, nw, ns)
    g = torch.as_tensor(rng.normal(size=(q, b, H)).astype(np.float32))
    args = (_t(kown), torch.as_tensor(mown), _t(kcross),
            torch.as_tensor(mcross), u)
    want = fused_key_hidden_sum_bwd_plain(*args, g, shift, *roots)
    jr = {} if roots[0] is None else dict(
        root_own=jnp.asarray(roots[0].numpy()),
        root_cross=jnp.asarray(roots[1].numpy()))
    jax_du = torch.as_tensor(np.array(jax.jit(jax.grad(
        lambda uj: jnp.sum(jax_fused_key_hidden_sum(
            jnp.asarray(kown), jnp.asarray(mown), jnp.asarray(kcross),
            jnp.asarray(mcross), uj, shift, interpret=True, **jr)
            * jnp.asarray(g.numpy()))))(jnp.asarray(u.numpy()))))
    got = sum_bwd_tc(*args, g, shift, *roots)
    assert _row_err(got, want) <= TOL and _row_err(got, jax_du) <= TOL
    assert bool((got[ns + 1] == 0).all())
    single = _row_err(sum_bwd_tc(*args, g, shift, *roots, mode="single"),
                      want)
    assert _row_err(got, want) <= TOL / 100 and single > TOL, single


def test_fields_split_past_shift_11():
    """shift 12 (num_walks >= 2048), fields over their whole width: K7
    bwd's products with the fields split as the kernel splits them match
    the plain backward; without the split they do not (a field of 12
    significant bits loses its last)."""
    rng = np.random.default_rng(3)
    shift, ncol = 12, 3
    k = lambda: torch.as_tensor(rng.integers(
        0, 1 << 25, size=(2, B, L)).astype(np.int32))
    kown, kc = k(), k()
    u = torch.cat([torch.as_tensor(rng.normal(size=(ncol, H)).astype(
        np.float32)) / 2048, torch.full((1, H), NEG),
        torch.as_tensor(0.2 * rng.normal(size=(1, H)).astype(np.float32))])
    g = torch.as_tensor(rng.normal(size=(2, B, L, H)).astype(np.float32))
    want = fused_key_hidden_slots_bwd_plain(kown, kc, u, g, shift)
    assert _row_err(slots_bwd_tc(kown, kc, u, g, shift), want) <= TOL
    old = hs.TC_EXACT_SHIFT
    hs.TC_EXACT_SHIFT = 12      # as if the fields were taken whole
    try:
        unsplit = _row_err(slots_bwd_tc(kown, kc, u, g, shift), want)
    finally:
        hs.TC_EXACT_SHIFT = old
    assert unsplit > TOL, unsplit


def _constants(text):
    return {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", text)}


def test_layout_mirrors_the_header():
    """The Python mirror (TC_*, slab_mtiles, tile_slots, the partitions)
    against csrc/hidden_tc.cuh, and K7 bwd's grid of three blocks an SM:
    their shared memory fits an H100's 227 KB at every width."""
    text = (CSRC / "hidden_tc.cuh").read_text()
    c = _constants(text)
    assert (c["kWarps"], c["kStages"], c["kStageBytes"], c["kQueue"],
            c["kExactShift"]) == (hs.TC_WARPS, hs.TC_STAGES,
                                  hs.TC_STAGE_BYTES, hs.TC_QUEUE,
                                  hs.TC_EXACT_SHIFT)
    assert ("return slots ? (ncol <= 5 ? 6 : (ncol <= 6 ? 4 : 3)) : "
            "(ncol <= 4 ? 6 : 3);") in text
    assert [hs.slab_mtiles(n, True) for n in range(2, 9)] == [
        6, 6, 6, 6, 4, 3, 3]
    assert [hs.slab_mtiles(n, False) for n in range(2, 9)] == [
        6, 6, 6, 3, 3, 3, 3]
    # slots of a tile: the bench (ncol 4) bf16 and fp32, wider keys
    assert {(n, e): hs.tile_slots(n, e) for n in (4, 6, 8)
            for e in (2, 4)} == {(4, 2): 32, (4, 4): 16, (6, 2): 32,
                                 (6, 4): 24, (8, 2): 32, (8, 4): 32}
    assert hs.SLOTS_BWD_PARTS == 3 * 132
    for ncol in range(2, 9):
        for es in (2, 4):
            ts = hs.tile_slots(ncol, es)
            cs = 16 * hs.slab_mtiles(ncol, True)
            stage = ts * (cs + c["kRowPad"] // es) * es + 4 * ts * 4
            assert 3 * hs.TC_WARPS * hs.TC_STAGES * stage <= 232448
            assert ts % 4 == 0 and ts * cs * es <= hs.TC_STAGE_BYTES
