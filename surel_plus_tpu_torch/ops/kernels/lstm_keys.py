"""Masked LSTM straight from the packed keys: the CUDA kernels
`csrc/lstm_keys.cu` (K4, forward) and `csrc/lstm_keys_bwd.cu` (K4 bwd,
its BPTT), their plain PyTorch versions, and the autograd Function that
joins them.

Replaces surel_plus_tpu/ops/pallas/lstm_kernel.py `lstm_from_keys`: impl
"t2" (`_klstm_t2_fwd_kernel`, `_klstm_t2_bwd_kernel`, the default) and
impl "t1" (`_klstm_t_fwd_kernel`, `_klstm_t_bwd_kernel`). For each row
r = (q, b) and slot l in order:

    x_l   = relu(fext(kown[l], 0) @ U) + relu(fext(kcross_al[l], 0) @ U)
    gates = x_l @ wi + h @ wh + bh              [4H], order (i, f, g, o)
    c'    = sigmoid(f) c + sigmoid(i) tanh(g),  h' = sigmoid(o) tanh(c')
    (c, h) <- (c', h') where mask[r, l]; out[q, b] = the final h

with fext(k, 0) = [f(k) | 0 | 1] (`_fields_ext`: the invalid field is 0 on
BOTH sides here, unlike the attention pool's own side) and U = u_ext. A
row with no valid slot gives 0. Any mask is allowed (t1's contract); t2's
prefix-mask shortcut is not carried over, in either direction.

The TPU kernels carry the mask as an extra lane of U and wi, keep the
planes transposed and extract fields chunk by chunk, all for Mosaic's lane
rules: none of that is here. The kernels read the mask plane.

The gradient is taken for u_ext, wi, wh and bh (the keys and the mask
get none). When one is needed, the forward on the card keeps a stash of
every step's gates and carries (K4's training instance), and the backward
(K4 bwd) runs from it without a forward of its own. Where that stash would
pass STASH_BUDGET bytes (wide sets: the general hi/lo layout's L = 4001),
the forward serves and keeps none, and the backward walks the sorted rows
in groups whose stash fits: a training forward over the group's rows, then
K4 bwd, the groups' gradients added in order. LSTM rows are independent,
so the split is exact up to the order of the weight gradients' sums.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from surel_plus_tpu_torch.ops.kernels.build import (
    CudaKernel,
    check_cuda,
    pick,
    ptr,
    ptr_or_null,
)
from surel_plus_tpu_torch.ops.kernels.hidden_sum import (
    MAX_NCOL,
    MAX_Q,
    _fields_ext,
    fused_key_hidden_slots_plain,
)

LSTM_KERNEL = CudaKernel("lstm_keys", "lstm_keys_fwd_launch",
                         [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6
                         + [ctypes.c_void_p])
LSTM_BWD_KERNEL = CudaKernel("lstm_keys_bwd", "lstm_keys_bwd_launch",
                             [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7
                             + [ctypes.c_void_p])
MAX_H = 256     # LSTM width H and input width h (csrc/lstm_keys.cuh kMaxH)
# csrc/lstm_keys.cuh: the forward's layout
WARP_ROWS = 16       # rows of a forward row group (kWarpRows)
FWD_GROUPS = 4       # row groups (two warps each) a block (kFwdGroups)
RESIDENT_UNITS = 12  # unit tiles of the resident path (kResidentUnits)
STASH_ROWS = 32      # rows of a stash block (kStashRows)
SMEM_LIMIT = 232448 - 1024  # dynamic shared memory a block may have, bytes
# bytes of stash one training forward may keep: above it the backward runs
# in row groups. 15 GiB keeps the bench width (5.7 GB) and L = 801 (15.1
# GB) whole and splits the general layout's L = 4001 (75.5 GB at R = 8192)
STASH_BUDGET = 15 * 2 ** 30
# csrc/lstm_tc.cuh: the backward's fixed partitions, which fix its bits
BWD_PARTS = 64  # parts of the weight-gradient slabs, one partial sum each
SWEEP_ROWS = 64  # rows of a sweep block (kSweepRows: 4 warps of 16)
DX_BLOCKS = 132  # blocks of the dx pass (kDxBlocks)
DX_TILES = 3     # n-tiles of 8 channels a dx warp holds (kDxTiles)
DX_WARPS = 16    # a dx block's target warp count (kDxWarps)


def lstm_scan_plain(x, mask, wi, wh, bh):
    """Final hidden state [R, H] float32 of the masked LSTM over rows
    x [R, L, h], mask bool [R, L], in the order of the JAX package's scan
    (layers.py:286-302): x_l @ wi in the promoted type of x and wi, then
    float32 for the rest (float64 where x or wi is). The input product is
    taken a step at a time: all of x @ wi at once would be 4H/h times the
    size of x."""
    r, ell, _ = x.shape
    hh = wh.shape[0]
    dt = torch.promote_types(x.dtype, wi.dtype)
    ct = torch.promote_types(dt, torch.float32)
    wi = wi.to(dt)
    wh = wh.to(ct)
    bh = bh.to(ct)
    c = torch.zeros(r, hh, dtype=ct, device=x.device)
    h = torch.zeros_like(c)
    for t in range(ell):
        gates = (x[:, t].to(dt) @ wi).to(ct) + h @ wh + bh
        gi, gf, gg, go = gates.chunk(4, dim=-1)
        nc = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
        nh = torch.sigmoid(go) * torch.tanh(nc)
        keep = mask[:, t, None]
        c = torch.where(keep, nc, c)
        h = torch.where(keep, nh, h)
    return h


def lstm_from_keys_plain(kown, kcross_al, mask, u_ext, wi, wh, bh,
                         shift: int, root_own=None, root_cross=None):
    """[Q, B, H] float32 in plain PyTorch: materializes the hidden rows,
    then runs `lstm_scan_plain` over them."""
    q, b, ell = kown.shape
    x = fused_key_hidden_slots_plain(kown, kcross_al, u_ext, shift,
                                     root_own=root_own,
                                     root_cross=root_cross)
    out = lstm_scan_plain(x.reshape(q * b, ell, -1),
                          mask.reshape(q * b, ell), wi, wh, bh)
    return out.reshape(q, b, -1)


def lstm_bptt_plain(x, mask, wi, wh, bh, g):
    """(dx [R, L, h], dwi [h, 4H], dwh [H, 4H], dbh [4H]) in x's dtype
    (float32, or float64): the gradient of the masked LSTM's final hidden
    state over rows x [R, L, h], mask bool [R, L], with wi, wh and bh in
    x's dtype, for the cotangent g [R, H], by an explicit BPTT in plain
    PyTorch (the TPU kernels' formulas): a forward that keeps the carries
    entering each slot, then a reverse loop that recomputes each slot's
    gates from them. A masked slot passes dh and dc on, contributes
    nothing and gets dx exactly 0."""
    r, ell, _ = x.shape
    keep = mask.reshape(r, ell, 1)

    def activations(t, c, h):
        gates = x[:, t] @ wi + h @ wh + bh
        gi, gf, gg, go = gates.chunk(4, dim=-1)
        return (torch.sigmoid(gi), torch.sigmoid(gf), torch.tanh(gg),
                torch.sigmoid(go))

    c = torch.zeros(r, wh.shape[0], dtype=x.dtype, device=x.device)
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
        dwi += x[:, t].T @ dgates
        dwh += hp.T @ dgates
        dbh += dgates.sum(dim=0)
        dx[:, t] = torch.where(k, dgates @ wi.T, 0.0)
        dh = torch.where(k, dgates @ wh.T, dh)
        dc = torch.where(k, dnc * sf, dc)
    return dx, dwi, dwh, dbh


def lstm_from_keys_bwd_plain(kown, kcross_al, mask, u_ext, wi, wh, bh, g,
                             shift: int, root_own=None, root_cross=None):
    """(du [ncol+2, h], dwi [h, 4H], dwh [H, 4H], dbh [4H]) float32 for the
    cotangent g [Q, B, H]: `lstm_bptt_plain` over the hidden rows, then dx
    back through each side's relu into du."""
    q, b, ell = kown.shape
    r = q * b
    ncol = u_ext.shape[0] - 2
    zero = torch.zeros(kown.shape, dtype=torch.bool, device=kown.device)
    fo = _fields_ext(kown, zero, shift, ncol, root_own).reshape(r * ell, -1)
    fc = _fields_ext(kcross_al, zero, shift, ncol,
                     root_cross).reshape(r * ell, -1)
    zo, zc = fo @ u_ext, fc @ u_ext
    x = (torch.relu(zo) + torch.relu(zc)).reshape(r, ell, -1)
    dx, dwi, dwh, dbh = lstm_bptt_plain(x, mask.reshape(r, ell), wi, wh, bh,
                                        g)
    dx = dx.reshape(r * ell, -1)
    du = (fo.T @ torch.where(zo > 0, dx, 0.0)
          + fc.T @ torch.where(zc > 0, dx, 0.0))
    return du, dwi, dwh, dbh


def row_ends(mask: torch.Tensor) -> torch.Tensor:
    """int32 [R]: each row's last valid slot index + 1 in mask [R, L] (0
    for a row with none), the step count the forward runs it to."""
    ell = mask.shape[-1]
    pos = torch.arange(1, ell + 1, dtype=torch.int32, device=mask.device)
    return torch.where(mask, pos, 0).amax(dim=-1).to(torch.int32)


def row_order(mask: torch.Tensor, ends=None) -> torch.Tensor:
    """int32 [R]: the rows of mask [R, L] by their last valid slot, the
    longest first (stable), so that a warp's rows end together; `ends`:
    `row_ends(mask)` if already at hand."""
    last = row_ends(mask) if ends is None else ends
    return torch.argsort(last, descending=True, stable=True).to(torch.int32)


def fragment_order(w: torch.Tensor, hh: int) -> torch.Tensor:
    """w [K, 4H] (H = hh) as the forward's B fragments, flat float32
    (csrc/lstm_keys.cuh, "Fragment order"): [K/8 up][H/8 up][2][32][4], lane
    4g + c's float4 of (k-step kk, unit tile n, gate pair p) being
    W[8kk + 2c + e][q H + 8n + g] for q = 2p, 2p + 1 and e = 0, 1 (q
    outer), zero past K and H. A warp reads a fragment as 512 contiguous
    bytes."""
    k = w.shape[0]
    nk, nu = -(-k // 8), -(-hh // 8)
    wp = w.new_zeros(nk * 8, 4, nu * 8, dtype=torch.float32)
    wp[:k, :, :hh] = w.reshape(k, 4, hh)
    # [kk, c, e, p, q2, n, g]: channel 8kk + 2c + e, gate 2p + q2, unit
    # 8n + g
    wp = wp.reshape(nk, 4, 2, 2, 2, nu, 8)
    return wp.permute(0, 5, 3, 6, 1, 4, 2).contiguous().reshape(-1)


def _check_operands(kown, kcross_al, mask, u_ext, wi, wh, bh, shift,
                    root_own, root_cross):
    """Raise unless the operands are what the CUDA kernel takes; returns
    (Q, B, L, h, H, ncol)."""
    q, b, ell = kown.shape
    nbx, h = u_ext.shape
    ncol = nbx - 2
    hh = wh.shape[0]
    dev = kown.device
    check_cuda("kown", kown, torch.int32, (q, b, ell), dev)
    check_cuda("kcross_al", kcross_al, torch.int32, (q, b, ell), dev)
    check_cuda("mask", mask, torch.bool, (q, b, ell), dev)
    check_cuda("u_ext", u_ext, torch.float32, (nbx, h), dev)
    check_cuda("wi", wi, torch.float32, (h, 4 * hh), dev)
    check_cuda("wh", wh, torch.float32, (hh, 4 * hh), dev)
    check_cuda("bh", bh, torch.float32, (4 * hh,), dev)
    if (root_own is None) != (root_cross is None):
        raise ValueError("pass both root planes or neither")
    if root_own is not None:
        check_cuda("root_own", root_own, torch.int32, (q, b, ell), dev)
        check_cuda("root_cross", root_cross, torch.int32, (q, b, ell), dev)
    nshift = ncol - 1 if root_own is not None else ncol
    if not (1 <= q <= MAX_Q and 2 <= ncol <= MAX_NCOL and 1 <= h <= MAX_H
            and 1 <= hh <= MAX_H and ell >= 1):
        raise ValueError(f"unsupported shape: Q={q} L={ell} ncol={ncol} "
                         f"h={h} H={hh} (h, H <= {MAX_H})")
    if (nshift - 1) * shift >= 32 or (root_own is not None
                                      and nshift * shift > 32):
        raise ValueError(f"{ncol} fields of {shift} bits do not fit the "
                         "lo word")
    return q, b, ell, h, hh, ncol


def block_layout(h: int, hh: int, ncol: Optional[int] = None):
    """The forward kernels' blocks at input width h and LSTM width hh, for
    the keys with ncol count fields or (None) for x rows
    (csrc/lstm_keys.cuh `fwd_layout_for`): unit tiles `nu`, x's k-steps
    `nkx`, whether the path is `resident` (12 unit tiles and the words
    fit: wh in shared memory beside a ring of two of wi's k-steps, h in
    place), row `groups` of WARP_ROWS rows (two warps each) a block, its
    `rows` and dynamic shared memory `smem` in bytes."""
    nu, nkx = -(-hh // 8), -(-h // 8)
    wh, ring = nu * nu * 256, 2 * nu * 256
    u = 0 if ncol is None else _round((ncol + 2) * h, 4)
    bias = nu * 32
    limit = SMEM_LIMIT // 4
    per_group = 128 * (nu + nkx)
    resident = (nu == RESIDENT_UNITS
                and wh + ring + u + bias + FWD_GROUPS * per_group <= limit)
    if resident:
        groups = FWD_GROUPS
    else:
        per_group = 128 * (3 * nu + nkx)
        groups = min(FWD_GROUPS, (limit - u - bias) // per_group)
    words = (wh + ring if resident else 0) + u + bias + groups * per_group
    return dict(nu=nu, nkx=nkx, resident=resident, groups=groups,
                rows=WARP_ROWS * groups, smem=4 * words)


def dx_layout(h: int):
    """(n-tile groups, warp streams a block, warps a block) of the
    backward's dx pass at input width h (csrc/lstm_tc.cuh
    `dx_layout_for`)."""
    ng = -(-(-(-h // 8)) // DX_TILES)
    streams = DX_WARPS // ng if ng < DX_WARPS else 1
    return ng, streams, ng * streams


def _round(x: int, m: int) -> int:
    return -(-x // m) * m


def bwd_layout(rows: int, ell: int, h: int, hh: int, ncol: Optional[int]):
    """The backward's blocks and buffers in 4-byte words, as the C entry
    points document them (csrc/lstm_tc.cuh, lstm_keys_bwd.cu, lstm_bwd.cu):
    the stash (blocks of STASH_ROWS rows), the sweep's blocks and dynamic
    shared memory (wh padded and resident where it fits in 227 KB less 1
    KB, with dh and dc), the dx pass's (wi padded where it fits, U for the
    keys), its dU partials (the keys, ncol given), the weight-gradient
    parts and partials, and the output."""
    rb = STASH_ROWS
    blocks = -(-rows // rb)
    hp = _round(hh, 8)
    ld = _round(4 * hp, 32) + 8
    state = 2 * SWEEP_ROWS * (_round(hp, 32) + 8)
    limit = SMEM_LIMIT // 4
    sweep = _round(hh, 8) * ld + state
    sweep = sweep if sweep <= limit else state
    u = 0 if ncol is None else (ncol + 2) * h
    dx = _round(h, 8) * ld + u
    dx = dx if dx <= limit else u
    e1 = 0 if ncol is None else (ncol + 2) * h
    e2 = 4 * hh + (h + hh) * 4 * hh
    parts = min(BWD_PARTS, blocks * ell)
    return dict(stash=blocks * rb * ell * 6 * hh, tend=blocks,
                sweep_blocks=-(-rows // SWEEP_ROWS), sweep_smem=4 * sweep,
                dx_smem=4 * dx, part1=DX_BLOCKS * dx_layout(h)[1] * e1,
                parts=parts, part2=parts * e2, out=e1 + e2)


@dataclass
class LSTMStash:
    """What the training forward of K4 or K5 keeps for the backward: every
    step's activated gates and entering carries (`data`, padded rows x L x
    6H fp32), each stash block's step count (`tend`), and the rows it ran
    in that order (`order`: all rows, or a group of them; None: all rows in
    their own order). The backward overwrites the gates with their
    gradients, so it takes a stash once."""
    data: torch.Tensor
    tend: torch.Tensor
    order: Optional[torch.Tensor]
    used: bool = False

    def take(self) -> "LSTMStash":
        if self.used:
            raise RuntimeError("this LSTM stash was used by a backward "
                               "already: run the forward again")
        self.used = True
        return self


def new_stash(rows: int, ell: int, hh: int, order, device) -> LSTMStash:
    """An empty stash for rows x ell slots at LSTM width hh."""
    lay = bwd_layout(rows, ell, 1, hh, None)
    return LSTMStash(
        torch.empty(lay["stash"], dtype=torch.float32, device=device),
        torch.empty(lay["tend"], dtype=torch.int32, device=device), order)


def stash_group(rows: int, ell: int, hh: int) -> int:
    """Rows a training forward keeps the stash of: all of them where their
    stash fits STASH_BUDGET, else the most whole stash blocks that fit (at
    least one). From the shapes alone."""
    if 4 * bwd_layout(rows, ell, 1, hh, None)["stash"] <= STASH_BUDGET:
        return rows
    block = 4 * STASH_ROWS * ell * 6 * hh
    return max(1, STASH_BUDGET // block) * STASH_ROWS


def row_groups(order: torch.Tensor, group: int):
    """The rows of `order` in groups of `group` (the last one shorter)."""
    return [order[i:i + group] for i in range(0, order.numel(), group)]


def add_grads(total, part):
    """The groups' gradients summed in the order they come."""
    return part if total is None else tuple(a + b for a, b in
                                            zip(total, part))


def processed_rows(order, rows: int, device) -> int:
    """The processing positions: order's rows (int32, on the device, each
    row at most once) where given, else all rows."""
    if order is None:
        return rows
    if (order.dtype != torch.int32 or order.device != device
            or order.dim() != 1 or not order.is_contiguous()
            or order.numel() > rows):
        raise ValueError("order must be a contiguous int32 vector of at "
                         "most R rows on the operands' device")
    return order.numel()


def lstm_from_keys_cuda(kown, kcross_al, mask, u_ext, wi, wh, bh,
                        shift: int, root_own=None, root_cross=None,
                        sort_rows: bool = True, order=None,
                        keep_stash: bool = False):
    """Launch K4; see csrc/lstm_keys.cu. wi [h, 4H], wh [H, 4H], bh [4H]:
    contiguous float32. The rows run in `order` (int32, the rows of the
    flattened [Q * B] to run, each at most once; the others' outputs are
    left unwritten) if given, else, with `sort_rows`, by their last valid
    slot, longest first (`row_order`), else in their own order. Returns
    [Q, B, H] float32; with `keep_stash` (training), also the LSTMStash for
    `lstm_from_keys_bwd_cuda`, the output bit for bit the same."""
    q, b, ell, h, hh, ncol = _check_operands(
        kown, kcross_al, mask, u_ext, wi, wh, bh, shift, root_own,
        root_cross)
    dev = kown.device
    out = torch.empty(q, b, hh, dtype=torch.float32, device=dev)
    rows = processed_rows(order, q * b, dev)
    stash = None
    if rows:
        flat = mask.reshape(q * b, ell)
        ends = row_ends(flat)
        if order is None and sort_rows:
            order = row_order(flat, ends)
        if keep_stash:
            stash = new_stash(rows, ell, hh, order, dev)
        # held until the launch: a freed temporary's memory would be
        # handed to the next allocation before the kernel reads it
        wif, whf = fragment_order(wi, hh), fragment_order(wh, hh)
        LSTM_KERNEL(dev, ptr(kown), ptr(kcross_al), ptr(mask),
                    ptr_or_null(root_own), ptr_or_null(root_cross),
                    ptr_or_null(order), ptr(ends), ptr(u_ext), ptr(wif),
                    ptr(whf), ptr(bh), ptr(out),
                    ptr_or_null(None if stash is None else stash.data),
                    ptr_or_null(None if stash is None else stash.tend),
                    rows, ell, h, hh, ncol, shift)
    elif keep_stash:
        stash = new_stash(0, ell, hh, order, dev)
    return (out, stash) if keep_stash else out


def lstm_from_keys_bwd_cuda(kown, kcross_al, mask, u_ext, wi, wh, bh, g,
                            shift: int, root_own=None, root_cross=None,
                            stash: Optional[LSTMStash] = None):
    """Launch K4 bwd; see csrc/lstm_keys_bwd.cu. g: contiguous fp32
    [Q, B, H]; `stash`: what `lstm_from_keys_cuda(..., keep_stash=True)`
    kept on the same operands (the rows run in its order: a group of rows
    gives that group's gradients), taken once.
    Scratch is sized from the shapes alone (no host sync). Returns
    (du [ncol+2, h], dwi [h, 4H], dwh [H, 4H], dbh [4H])."""
    q, b, ell, h, hh, ncol = _check_operands(
        kown, kcross_al, mask, u_ext, wi, wh, bh, shift, root_own,
        root_cross)
    dev = kown.device
    check_cuda("g", g, torch.float32, (q, b, hh), dev)
    if stash is None:
        raise ValueError("the backward needs the training forward's stash "
                         "(lstm_from_keys_cuda(..., keep_stash=True))")
    st = stash.take()
    rows = processed_rows(st.order, q * b, dev)
    lay = bwd_layout(rows, ell, h, hh, ncol)
    if not rows:
        out = torch.zeros(lay["out"], dtype=torch.float32, device=dev)
    else:
        if st.data.numel() != lay["stash"] or st.tend.numel() != lay["tend"]:
            raise ValueError("the stash does not fit these operands")
        empty = lambda n: torch.empty(n, dtype=torch.float32, device=dev)
        out = empty(lay["out"])
        part1, part2 = empty(lay["part1"]), empty(lay["part2"])
        LSTM_BWD_KERNEL(dev, ptr(kown), ptr(kcross_al), ptr(mask),
                        ptr_or_null(root_own), ptr_or_null(root_cross),
                        ptr_or_null(st.order), ptr(u_ext), ptr(wi), ptr(wh),
                        ptr(g), ptr(st.data), ptr(st.tend), ptr(part1),
                        ptr(part2), ptr(out), rows, ell, h, hh, ncol, shift,
                        lay["parts"])
    n = (ncol + 2) * h
    e1 = n + 4 * hh
    return (out[:n].view(ncol + 2, h), out[e1:e1 + h * 4 * hh].view(h, -1),
            out[e1 + h * 4 * hh:].view(hh, -1), out[n:e1])


class FusedKeysLSTM(torch.autograd.Function):
    """The keys-LSTM with its gradient for u_ext, wi, wh and bh only (the
    custom VJP `_klstmt2` of the JAX kernel). On the card the forward
    orders the rows once (`row_order`); when `train`, it runs K4's training
    instance, which keeps the stash, and the backward runs K4 bwd from it;
    where the stash would pass STASH_BUDGET (`stash_group`), the forward
    serves and the backward re-runs the training forward and K4 bwd group
    by group of the ordered rows. On the CPU the pair is the plain
    versions."""

    @staticmethod
    def forward(ctx, kown, kcross_al, mask, u_ext, wi, wh, bh, shift,
                root_own, root_cross, train):
        fwd = pick("lstm_from_keys forward", kown, lstm_from_keys_cuda,
                   lstm_from_keys_plain)
        args = (kown, kcross_al, mask, u_ext, wi, wh, bh, shift, root_own,
                root_cross)
        ctx.stash = ctx.order = None
        if fwd is lstm_from_keys_cuda:
            ell = mask.shape[-1]
            order = row_order(mask.reshape(-1, ell))
            ctx.group = stash_group(order.numel(), ell, wh.shape[0])
            if train and ctx.group == order.numel():
                out, ctx.stash = fwd(*args, order=order, keep_stash=True)
            else:
                out = fwd(*args, order=order)
                ctx.order = order if train else None
        else:
            out = fwd(*args)
        ctx.shift = shift
        ctx.save_for_backward(kown, kcross_al, mask, u_ext, wi, wh, bh,
                              root_own, root_cross)
        return out

    @staticmethod
    def backward(ctx, g):
        (kown, kcross_al, mask, u_ext, wi, wh, bh, root_own,
         root_cross) = ctx.saved_tensors
        bwd = pick("lstm_from_keys backward", kown, lstm_from_keys_bwd_cuda,
                   lstm_from_keys_bwd_plain)
        ops = (kown, kcross_al, mask, u_ext, wi, wh, bh)
        roots = (root_own, root_cross)
        gf = g.to(torch.float32).contiguous()
        if bwd is lstm_from_keys_bwd_cuda:
            if ctx.order is not None:  # stash groups
                grads = None
                for rows in row_groups(ctx.order, ctx.group):
                    _, st = lstm_from_keys_cuda(*ops, ctx.shift, *roots,
                                                order=rows, keep_stash=True)
                    grads = add_grads(grads, bwd(*ops, gf, ctx.shift, *roots,
                                                 stash=st))
                du, dwi, dwh, dbh = grads
            else:
                if ctx.stash is None:
                    raise RuntimeError("lstm_from_keys backward: the forward "
                                       "ran without grad and kept no stash")
                du, dwi, dwh, dbh = bwd(*ops, gf, ctx.shift, *roots,
                                        stash=ctx.stash)
            ctx.stash = None  # taken: free it with the graph's other
            #                   buffers
        else:
            du, dwi, dwh, dbh = bwd(*ops, gf, ctx.shift, *roots)
        return None, None, None, du, dwi, dwh, dbh, None, None, None, None


def needs_grad(*tensors) -> bool:
    """Whether autograd will ask for a gradient of any of `tensors`."""
    return torch.is_grad_enabled() and any(t.requires_grad
                                           for t in tensors)


def lstm_from_keys(kown: torch.Tensor, kcross_al: torch.Tensor,
                   mask: torch.Tensor, u_ext: torch.Tensor,
                   wi: torch.Tensor, wh: torch.Tensor, bh: torch.Tensor,
                   shift: int, root_own: Optional[torch.Tensor] = None,
                   root_cross: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Masked LSTM final hidden state from the packed keys -> [Q, B, H]
    float32, differentiable in u_ext, wi, wh and bh.

    kown, kcross_al [Q, B, L]: int32 bits of the own and the slot-aligned
    partner lo keys; mask bool [Q, B, L] (any pattern); u_ext
    [ncol + 2, h] as for `fused_key_hidden_sum`; wi [h, 4H] (the input
    weights, projection folded in), wh [H, 4H], bh [4H], cast to float32
    here. root_own / root_cross: int32 0/1 planes replacing the key's root
    bit (lead-in-hi layout). On CUDA tensors this launches K4 (its
    training instance, and K4 bwd when differentiated, where a gradient is
    needed), on CPU tensors it takes the plain versions."""
    f32 = lambda t: t.to(torch.float32).contiguous()
    ws = (f32(u_ext), f32(wi), f32(wh), f32(bh).reshape(-1))
    return FusedKeysLSTM.apply(kown, kcross_al, mask, *ws, shift, root_own,
                               root_cross, needs_grad(*ws))
