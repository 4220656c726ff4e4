// Keys-LSTM, forward (K4): for every row r = (q, b) and slot l = 0..L-1 in
// order,
//
//   x_l   = relu(fext(kown[l], 0) . U) + relu(fext(kcross_al[l], 0) . U)
//   gates = x_l . wi + h . wh + bh                    [4H], order (i, f, g, o)
//   c'    = sigmoid(f) c + sigmoid(i) tanh(g),  h' = sigmoid(o) tanh(c')
//   (c, h) <- (c', h') where mask[l], else left as they are
//   out[r] = the final h                                         [Q, B, H]
//
// with fext(k, 0) = [f(k) | 0 | 1], f(k) the key's ncol count fields
// (csrc/hidden_sum.cu) and U = u_ext [ncol + 2, h]. A row with no valid
// slot gives 0. wi is the input weight with the upstream projection folded
// in (wi_eff = W2 @ wi, bh_eff = bh + 2 b2 @ wi, in the caller).
//
// Replaces the TPU kernels surel_plus_tpu/ops/pallas/lstm_kernel.py
// _klstm_t2_fwd_kernel ("t2", the default: rows sorted by valid count and
// whole chunks skipped, which holds only for prefix masks) and
// _klstm_t_fwd_kernel ("t1": any mask). This kernel meets t1's contract: a
// masked slot anywhere leaves the carry, and a block stops after the last
// valid slot INDEX of its rows, not their count.
//
// Bound on the H100: operations. Per valid (row, slot) the gate product is
// 4H (h + H) multiply-adds (147,456 operations at h = H = 96), against
// 2 h (2 ncol + 1) for the hidden rows and some 20 H for the cell; at the
// bench width (Q=2, B=4096, L=301, about 39% of the slots valid) about
// 1.5e11 operations: 2.2 ms on the fp32 CUDA cores, 0.9 ms for the three
// TF32 products of 3xTF32 at the TF32 tensor rate, while the keys are
// about 30 MB (9 us at 3.35 TB/s). It holds fp32 accuracy: the recurrence
// runs up to 801 steps and is held to its plain version at 1e-4.
//
// Design (the step loop `forward_kernel` in lstm_keys.cuh). The products
// run on the tensor cores (mma.sync.m16n8k8, 3xTF32; the big parts rounded
// to nearest and each k-step's products in a fresh accumulator, as
// accurate as fp32): a row group of 16 rows runs on two warps, each
// holding all four gates of half the units, so the cell runs in the lane;
// the h' a lane computes is the next step's A fragment of the same lane of
// both warps (K axis permuted), passed through shared memory in lane
// order. A block holds 4 row groups (64 rows; 128 blocks at R = 8192, one
// wave on 132 SMs, 8 warps an SM) that step together. At H = 96 wh (147
// KB in fragment order) stays in shared memory and c in registers; wi (147
// KB more) cannot join it and streams through a two-k-step ring in shared
// memory (cp.async, a block barrier a k-step), h updated in place. The
// hidden rows are formed from each lane's keys and U (in shared memory)
// as A fragments in the lane's words, a slot's keys loaded a step ahead,
// the two warps taking alternate k-steps. The wrapper orders the rows by
// their last valid slot, longest first (the `order` operand), so a block's
// rows end together; it also passes each row's end (`ends`) and the
// weights in fragment order.
//
// Training (a non-null `stash`): the same step loop also keeps every
// step's activated gates and entering carries (c, h) and each 32-row stash
// block's step count for the backward (lstm_keys_bwd.cu), padded rows x L
// x 6H fp32 (5.7 GB at the bench width); the final h it writes is
// serving's bit for bit.
//
// Uses expf / tanhf (no fast-math intrinsics) and no float atomics: two
// launches give the same bits, and a row's bits do not depend on the order
// the rows run in.

#include "lstm_tc.cuh"

using namespace lstm;

// rows: the processing positions (order [rows] when given, a subset of the
// [Q B] rows, each at most once; else the first rows rows). ends [Q B]:
// each row's last valid slot + 1. wif, whf: wi, wh in fragment order
// (lstm_keys.cuh: (h or H) / 8 up x H / 8 up x 256 floats). stash: null
// (serving), or blocks * kStashRows * L * 6H floats and tend: blocks ints
// (blocks = ceil(rows / kStashRows)). out [Q B, H]: the rows processed
// written.
extern "C" int lstm_keys_fwd_launch(const void* kown, const void* kcross,
                                    const void* mask, const void* rown,
                                    const void* rcross, const void* order,
                                    const void* ends, const void* u,
                                    const void* wif, const void* whf,
                                    const void* bh, void* out, void* stash,
                                    void* tend, int rows, int L, int h,
                                    int H, int ncol, int shift,
                                    void* stream) {
  FwdOperands p{};
  p.kown = (const uint32_t*)kown;
  p.kcross = (const uint32_t*)kcross;
  p.mask = (const uint8_t*)mask;
  p.rown = (const int32_t*)rown;
  p.rcross = (const int32_t*)rcross;
  p.order = (const int32_t*)order;
  p.u = (const float*)u;
  p.bh = (const float*)bh;
  p.rows = rows;
  p.L = L;
  p.h = h;
  p.H = H;
  p.shift = shift;
  p.ends = (const int32_t*)ends;
  p.wif = (const float*)wif;
  p.whf = (const float*)whf;
  p.ncol = ncol;
  if (rows < 1 || L < 1 || h < 1 || h > kMaxH || H < 1 || H > kMaxH ||
      ncol < 2 || ncol > kMaxNcol ||
      (rown == nullptr) != (rcross == nullptr) ||
      (stash == nullptr) != (tend == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  float* o = (float*)out;
  const bool root = rown != nullptr;
  if (stash != nullptr) {
    const Stash keep = stash_in(stash, tend, rows, L, H);
    return root ? (int)launch_forward<true, true, true>(p, o, keep, st)
                : (int)launch_forward<true, false, true>(p, o, keep, st);
  }
  const Stash none{nullptr, nullptr, nullptr, nullptr};
  return root ? (int)launch_forward<true, true, false>(p, o, none, st)
              : (int)launch_forward<true, false, false>(p, o, none, st);
}
