// Masked LSTM over given input rows, forward (K5): for every row r and slot
// l = 0..L-1 in order,
//
//   gates = x[r, l] . wi + h . wh + bh                [4H], order (i, f, g, o)
//   c'    = sigmoid(f) c + sigmoid(i) tanh(g),  h' = sigmoid(o) tanh(c')
//   (c, h) <- (c', h') where mask[r, l], else left as they are
//   out[r] = the final h                                             [R, H]
//
// with fp32 accuracy; a row with no valid slot gives 0. x [R, L, h] is the
// LSTM aggregator's input without keys (the encoding-table path: the
// pair-summed hidden rows), wi the input weight with the upstream
// projection folded in.
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
// valid) about 1.4e11 operations: 2.1 ms on the fp32 CUDA cores, 0.9 ms
// for the three TF32 products of 3xTF32 at the TF32 tensor rate, while x
// of the valid slots is about 0.37 GB (0.11 ms at 3.35 TB/s).
//
// Design: K4's step loop (`forward_kernel` in lstm_keys.cuh, KEYS false):
// 3xTF32 products on the tensor cores, row groups of 16 rows on two warps
// each, the block's 4 groups stepping to its rows' last valid slot, wh
// resident in shared memory at H = 96, wi through a two-k-step ring, the
// rows ordered by their last valid slot (the wrapper's `order`). In place
// of the hidden rows computed from the keys, each lane copies its A
// fragments of slot t + 1's x rows (alternate k-steps for the two warps)
// into the group's shared-memory words with cp.async, a k-step at a time
// beside the h wh products, once every warp has read slot t's.
//
// Training (a non-null `stash`): the same loop also keeps the stash for
// the backward (lstm_bwd.cu), as K4's training instance does; its final h
// is serving's bit for bit.
//
// Uses expf / tanhf and no float atomics: two launches give the same bits.

#include "lstm_tc.cuh"

using namespace lstm;

// rows, order, ends, wif, whf, stash, tend, out: as for
// lstm_keys_fwd_launch (lstm_keys.cu), the rows those of x [R, L, h].
extern "C" int lstm_x_fwd_launch(const void* x, const void* mask,
                                 const void* order, const void* ends,
                                 const void* wif, const void* whf,
                                 const void* bh, void* out, void* stash,
                                 void* tend, int rows, int L, int h, int H,
                                 void* stream) {
  FwdOperands p{};
  p.mask = (const uint8_t*)mask;
  p.order = (const int32_t*)order;
  p.bh = (const float*)bh;
  p.rows = rows;
  p.L = L;
  p.h = h;
  p.H = H;
  p.x = (const float*)x;
  p.ends = (const int32_t*)ends;
  p.wif = (const float*)wif;
  p.whf = (const float*)whf;
  if (rows < 1 || L < 1 || h < 1 || h > kMaxH || H < 1 || H > kMaxH ||
      (stash == nullptr) != (tend == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (stash != nullptr)
    return (int)launch_forward<false, false, true>(
        p, (float*)out, stash_in(stash, tend, rows, L, H), st);
  const Stash none{nullptr, nullptr, nullptr, nullptr};
  return (int)launch_forward<false, false, false>(p, (float*)out, none, st);
}
