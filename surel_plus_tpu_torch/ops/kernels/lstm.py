"""Masked LSTM over given input rows: the CUDA kernels `csrc/lstm.cu` (K5,
forward) and `csrc/lstm_bwd.cu` (K5 bwd, its BPTT), their plain PyTorch
versions, and the autograd Function that joins them.

Replaces surel_plus_tpu/ops/pallas/lstm_kernel.py `lstm_final_hidden`
(the kernels `_lstm_kernel` and `_lstm_bwd_kernel`): the LSTM
aggregator's fused route where the set rows come as x [R, L, h] and not
as packed keys (the encoding-table path, and a keys join without planes).
For each row r and slot l in order:

    gates = x[r, l] @ wi + h @ wh + bh          [4H], order (i, f, g, o)
    c'    = sigmoid(f) c + sigmoid(i) tanh(g),  h' = sigmoid(o) tanh(c')
    (c, h) <- (c', h') where mask[r, l]; out[r] = the final h

all in float32: x and wi are cast to float32 BEFORE the input product, as
lstm_final_hidden casts them (lstm_kernel.py:340-348). That is this
module's contract; `lstm_keys.lstm_scan_plain` follows the JAX package's
scan instead (the input product in the promoted dtype of x and wi,
layers.py:286), and `lstm_final_hidden_plain` is that scan on float32
operands.

The gradient is taken for x, wi, wh and bh (the mask gets none). When
one is needed, the forward on the card runs K5's training instance, which
keeps the stash that K5 bwd runs from; where that stash would pass
`lstm_keys.STASH_BUDGET`, the backward runs the training forward and K5
bwd group by group of the ordered rows instead (as `FusedKeysLSTM` does).
"""

from __future__ import annotations

import ctypes

import torch

from surel_plus_tpu_torch.ops.kernels.build import (
    CudaKernel,
    check_cuda,
    pick,
    ptr,
    ptr_or_null,
)
from surel_plus_tpu_torch.ops.kernels.lstm_keys import (
    MAX_H,
    LSTMStash,
    add_grads,
    bwd_layout,
    fragment_order,
    lstm_bptt_plain,
    lstm_scan_plain,
    needs_grad,
    new_stash,
    processed_rows,
    row_ends,
    row_groups,
    row_order,
    stash_group,
)

LSTM_X_KERNEL = CudaKernel("lstm", "lstm_x_fwd_launch",
                           [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                           + [ctypes.c_void_p])
LSTM_X_BWD_KERNEL = CudaKernel("lstm_bwd", "lstm_x_bwd_launch",
                               [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                               + [ctypes.c_void_p])


def _wide(t: torch.Tensor) -> torch.Tensor:
    """t in float32, or in float64 if it is float64 (for gradcheck)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def lstm_final_hidden_plain(x, mask, wi, wh, bh):
    """[R, H] float32 in plain PyTorch: `lstm_scan_plain` on x and wi cast
    to float32 (kept in float64 if they are)."""
    return lstm_scan_plain(_wide(x), mask, _wide(wi), wh, bh)


def _check_operands(x, mask, wi, wh, bh):
    """Raise unless the operands are what the CUDA kernels take; returns
    (R, L, h, H)."""
    r, ell, h = x.shape
    hh = wh.shape[0]
    dev = x.device
    check_cuda("x", x, torch.float32, (r, ell, h), dev)
    check_cuda("mask", mask, torch.bool, (r, ell), dev)
    check_cuda("wi", wi, torch.float32, (h, 4 * hh), dev)
    check_cuda("wh", wh, torch.float32, (hh, 4 * hh), dev)
    check_cuda("bh", bh, torch.float32, (4 * hh,), dev)
    if not (1 <= h <= MAX_H and 1 <= hh <= MAX_H and ell >= 1):
        raise ValueError(f"unsupported shape: L={ell} h={h} H={hh} "
                         f"(h, H <= {MAX_H})")
    return r, ell, h, hh


def lstm_final_hidden_cuda(x, mask, wi, wh, bh, sort_rows: bool = True,
                           order=None, keep_stash: bool = False):
    """Launch K5; see csrc/lstm.cu. x [R, L, h], wi [h, 4H], wh [H, 4H],
    bh [4H]: contiguous float32; mask bool [R, L]. The rows run in `order`
    (int32, the rows to run, each at most once; the others' outputs are
    left unwritten) if given, else, with `sort_rows`, by their last valid
    slot, longest first (`row_order`), else in their own order. Returns
    [R, H] float32; with `keep_stash` (training), also the LSTMStash for
    `lstm_final_hidden_bwd_cuda`, the output bit for bit the same."""
    r, ell, h, hh = _check_operands(x, mask, wi, wh, bh)
    out = torch.empty(r, hh, dtype=torch.float32, device=x.device)
    rows = processed_rows(order, r, x.device)
    stash = None
    if rows:
        ends = row_ends(mask)
        if order is None and sort_rows:
            order = row_order(mask, ends)
        if keep_stash:
            stash = new_stash(rows, ell, hh, order, x.device)
        # held until the launch (see lstm_from_keys_cuda)
        wif, whf = fragment_order(wi, hh), fragment_order(wh, hh)
        LSTM_X_KERNEL(x.device, ptr(x), ptr(mask), ptr_or_null(order),
                      ptr(ends), ptr(wif), ptr(whf), ptr(bh), ptr(out),
                      ptr_or_null(None if stash is None else stash.data),
                      ptr_or_null(None if stash is None else stash.tend),
                      rows, ell, h, hh)
    elif keep_stash:
        stash = new_stash(0, ell, hh, order, x.device)
    return (out, stash) if keep_stash else out


def lstm_final_hidden_bwd_plain(x, mask, wi, wh, bh, g):
    """(dx [R, L, h], dwi [h, 4H], dwh [H, 4H], dbh [4H]) float32 for the
    cotangent g [R, H], by an explicit BPTT in plain PyTorch
    (`lstm_bptt_plain`) on the operands cast to float32 (kept in float64
    if x is)."""
    dt = _wide(x).dtype
    x, wi, wh, bh = (t.to(dt) for t in (x, wi, wh, bh))
    return lstm_bptt_plain(x, mask, wi, wh, bh, g)


def lstm_final_hidden_bwd_cuda(x, mask, wi, wh, bh, g,
                               stash: LSTMStash = None, dx=None):
    """Launch K5 bwd; see csrc/lstm_bwd.cu. Operands as for
    `lstm_final_hidden_cuda`, g: contiguous fp32 [R, H]; `stash`: what
    `lstm_final_hidden_cuda(..., keep_stash=True)` kept on the same
    operands (the rows run in its order: a group of rows gives that
    group's gradients and dx rows), taken once; `dx`: where to write dx
    (contiguous fp32 like x; its other rows are left as they are), else a
    new tensor. Scratch is sized from the shapes alone (no host sync).
    Returns (dx [R, L, h], dwi [h, 4H], dwh [H, 4H], dbh [4H])."""
    r, ell, h, hh = _check_operands(x, mask, wi, wh, bh)
    dev = x.device
    check_cuda("g", g, torch.float32, (r, hh), dev)
    if stash is None:
        raise ValueError("the backward needs the training forward's stash "
                         "(lstm_final_hidden_cuda(..., keep_stash=True))")
    h4 = 4 * hh
    st = stash.take()
    rows = processed_rows(st.order, r, dev)
    lay = bwd_layout(rows, ell, h, hh, None)
    empty = lambda n: torch.empty(n, dtype=torch.float32, device=dev)
    if dx is None:
        dx = empty((r, ell, h))
    else:
        check_cuda("dx", dx, torch.float32, (r, ell, h), dev)
    if not rows:
        out = torch.zeros(lay["out"], dtype=torch.float32, device=dev)
    else:
        if st.data.numel() != lay["stash"] or st.tend.numel() != lay["tend"]:
            raise ValueError("the stash does not fit these operands")
        out = empty(lay["out"])
        part = empty(lay["part2"])
        LSTM_X_BWD_KERNEL(dev, ptr(x), ptr(mask), ptr_or_null(st.order),
                          ptr(wi), ptr(wh), ptr(g), ptr(st.data),
                          ptr(st.tend), ptr(part), ptr(dx), ptr(out), rows,
                          ell, h, hh, lay["parts"])
    return (dx, out[h4:h4 + h * h4].view(h, h4),
            out[h4 + h * h4:].view(hh, h4), out[:h4])


class FinalHiddenLSTM(torch.autograd.Function):
    """The masked LSTM over given rows with its gradient for x, wi, wh and
    bh (the custom VJP `_lstm` of the JAX kernel). On the card the forward
    orders the rows once (`row_order`); when `train`, it runs K5's
    training instance, which keeps the stash (K5's gates bit for bit), and
    the backward runs K5 bwd from it; where the stash would pass the
    budget (`stash_group`), the forward serves and the backward re-runs
    the training forward and K5 bwd group by group, each group's dx rows
    written in place. On the CPU the pair is the plain versions."""

    @staticmethod
    def forward(ctx, x, mask, wi, wh, bh, train=False):
        fwd = pick("lstm_final_hidden forward", x, lstm_final_hidden_cuda,
                   lstm_final_hidden_plain)
        ctx.stash = ctx.order = None
        if fwd is lstm_final_hidden_cuda:
            order = row_order(mask)
            ctx.group = stash_group(order.numel(), mask.shape[-1],
                                    wh.shape[0])
            if train and ctx.group == order.numel():
                out, ctx.stash = fwd(x, mask, wi, wh, bh, order=order,
                                     keep_stash=True)
            else:
                out = fwd(x, mask, wi, wh, bh, order=order)
                ctx.order = order if train else None
        else:
            out = fwd(x, mask, wi, wh, bh)
        ctx.save_for_backward(x, mask, wi, wh, bh)
        return out

    @staticmethod
    def backward(ctx, g):
        x, mask, wi, wh, bh = ctx.saved_tensors
        bwd = pick("lstm_final_hidden backward", x,
                   lstm_final_hidden_bwd_cuda, lstm_final_hidden_bwd_plain)
        args = (x, mask, wi, wh, bh, g.to(torch.float32).contiguous())
        if bwd is lstm_final_hidden_bwd_cuda:
            if ctx.order is not None:  # stash groups
                dx = torch.empty_like(x)
                grads = None
                for rows in row_groups(ctx.order, ctx.group):
                    _, st = lstm_final_hidden_cuda(*args[:5], order=rows,
                                                   keep_stash=True)
                    grads = add_grads(grads, bwd(*args, stash=st,
                                                 dx=dx)[1:])
                dwi, dwh, dbh = grads
            else:
                if ctx.stash is None:
                    raise RuntimeError("lstm_final_hidden backward: the "
                                       "forward ran without grad and kept "
                                       "no stash")
                dx, dwi, dwh, dbh = bwd(*args, stash=ctx.stash)
            ctx.stash = None
        else:
            dx, dwi, dwh, dbh = bwd(*args)
        return dx, None, dwi, dwh, dbh, None


def lstm_final_hidden(x: torch.Tensor, mask: torch.Tensor, wi: torch.Tensor,
                      wh: torch.Tensor, bh: torch.Tensor) -> torch.Tensor:
    """Final masked-LSTM hidden state -> [R, H] float32, differentiable in
    x, wi, wh and bh.

    x [R, L, h] (any float dtype, computed in float32), mask bool [R, L]
    (any pattern; a masked slot leaves the carry as it is), wi [h, 4H],
    wh [H, 4H], bh [4H]. On CUDA tensors this launches K5 (its training
    instance, and K5 bwd when differentiated, where a gradient is needed),
    on CPU tensors it takes the plain versions."""
    f32 = lambda t: t.to(torch.float32).contiguous()
    ts = (f32(x), f32(wi), f32(wh), f32(bh).reshape(-1))
    return FinalHiddenLSTM.apply(ts[0], mask.contiguous(), *ts[1:],
                                 needs_grad(*ts))
