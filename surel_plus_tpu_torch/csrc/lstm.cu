// Masked LSTM over given input rows, forward (K5): for every row r and slot
// l = 0..L-1 in order,
//
//   gates = x[r, l] . wi + h . wh + bh                [4H], order (i, f, g, o)
//   c'    = sigmoid(f) c + sigmoid(i) tanh(g),  h' = sigmoid(o) tanh(c')
//   (c, h) <- (c', h') where mask[r, l], else left as they are
//   out[r] = the final h                                             [R, H]
//
// all in fp32; a row with no valid slot gives 0. x [R, L, h] is the LSTM
// aggregator's input without keys (the encoding-table path: the pair-summed
// hidden rows), wi the input weight with the upstream projection folded in.
//
// Replaces the TPU kernel surel_plus_tpu/ops/pallas/lstm_kernel.py
// _lstm_kernel (launched by lstm_final_hidden). That kernel carries the mask
// as x's last lane and a zero row of wi, for Mosaic's lane rules; this one
// reads a mask plane. The input product x . wi is taken inside the kernel,
// step by step, as the TPU kernel does.
//
// Bound on the H100: operations. Per valid (row, slot) the gate product is
// 4H (h + H) multiply-adds (147,456 operations at h = H = 96) and the cell
// some 20 H; at the bench width (R = 8192, L = 301, about 39% of the slots
// valid) about 1.4e11 operations, 2.1 ms on the fp32 CUDA cores, while x of
// the valid slots is about 0.37 GB (0.11 ms at 3.35 TB/s).
//
// Design: K4's own step loop (`forward_kernel` in lstm_keys.cuh, NCOL =
// kXRows): the block layout (one thread per hidden unit and 8 rows, 32 rows
// a block at H = 96), wh in shared memory where it fits, wi from L2, one
// barrier a step, the early stop after the block's last valid slot index
// and the rows ordered by it (the wrapper's `order`). In place of the hidden
// rows computed from the keys, each step's x rows are copied into shared
// memory with cp.async, coalesced from the contiguous [R, L, h] layout,
// one slot ahead: slot t + 1's copy runs while slot t's gate sums do. The
// mask is staged 32 slots at a time, as K4 stages it.
//
// Training (a non-null `stash`): the same loop also keeps the stash for
// the backward (lstm_bwd.cu), as K4's training instance does; its final h
// is serving's bit for bit.
//
// Uses expf / tanhf and no float atomics: two launches give the same bits.

#include "lstm_tc.cuh"

using namespace lstm;

// stash: null (serving), or blocks * rb * L * 6H floats and tend: blocks
// ints (layout_for(H): rb rows a block, blocks = ceil(rows / rb)).
extern "C" int lstm_x_fwd_launch(const void* x, const void* mask,
                                 const void* order, const void* wi,
                                 const void* wh, const void* bh, void* out,
                                 void* stash, void* tend, int rows, int L,
                                 int h, int H, void* stream) {
  const Operands p{nullptr,           nullptr,           (const uint8_t*)mask,
                   nullptr,           nullptr,           (const int32_t*)order,
                   nullptr,           (const float*)wi,  (const float*)wh,
                   (const float*)bh,  rows,              L,
                   h,                 H,                 0,
                   (const float*)x};
  if (rows < 1 || L < 1 || h < 1 || h > kMaxH || H < 1 || H > kMaxH ||
      (stash == nullptr) != (tend == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (stash != nullptr)
    return (int)launch_forward<kXRows, true>(
        p, (float*)out, stash_in(stash, tend, rows, L, H), st);
  const Stash none{nullptr, nullptr, nullptr, nullptr};
  return (int)launch_forward<kXRows, false>(p, (float*)out, none, st);
}
