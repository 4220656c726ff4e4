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
// 1.5e11 operations, 2.2 ms on the fp32 CUDA cores, while the keys are
// about 30 MB (9 us at 3.35 TB/s). It stays in fp32: the recurrence runs
// up to 801 steps and is held to its plain version at 1e-4.
//
// The weights do not fit in one SM: wi and wh are 2 x 96 x 384 fp32 =
// 295 KB, above the 227 KB of shared memory a block may have and above
// the register file. So each step reads them once per BLOCK (through the
// read-only cache, from L2), and a block runs several rows to reuse every
// weight it reads: one thread per hidden unit j and row group of 8 rows,
// kMaxGroups groups (32 rows at H = 96, 384 threads). A thread keeps the
// four gate sums of unit j for its 8 rows in registers (32 accumulators,
// 32 multiply-adds per 4 weight loads), so the cell update needs no
// exchange; c stays in registers, h and x go through shared memory,
// double buffered, with one barrier a step. Where it fits (H = 96), wh
// is copied into shared memory once per block, so only wi streams from
// L2; wider H reads both from L2. Keys are staged 32 slots at a
// time. The wrapper orders the rows by their last valid slot, longest
// first (the `order` operand), so a block's rows end together and the
// longest blocks start first; out[order[i]] is written directly.
//
// Training (a non-null `stash`): the same step loop also keeps every
// step's activated gates and entering carries (c, h) and each block's step
// count for the backward (lstm_keys_bwd.cu), padded rows x L x 6H fp32 (5.7
// GB at the bench width); the final h it writes is serving's bit for bit.
//
// Uses expf / tanhf (no fast-math intrinsics) and no float atomics: two
// launches give the same bits. The kernel itself, `forward_kernel`, lives
// in lstm_keys.cuh: K5 runs the same step loop over given rows.

#include "lstm_tc.cuh"

using namespace lstm;

// stash: null (serving), or blocks * rb * L * 6H floats and tend: blocks
// ints (layout_for(H): rb rows a block, blocks = ceil(rows / rb)).
extern "C" int lstm_keys_fwd_launch(const void* kown, const void* kcross,
                                    const void* mask, const void* rown,
                                    const void* rcross, const void* order,
                                    const void* u, const void* wi,
                                    const void* wh, const void* bh, void* out,
                                    void* stash, void* tend, int rows, int L,
                                    int h, int H, int ncol, int shift,
                                    void* stream) {
  const Operands p{(const uint32_t*)kown, (const uint32_t*)kcross,
                   (const uint8_t*)mask,  (const int32_t*)rown,
                   (const int32_t*)rcross, (const int32_t*)order,
                   (const float*)u,       (const float*)wi,
                   (const float*)wh,      (const float*)bh,
                   rows, L, h, H, shift};
  if (rows < 1 || L < 1 || h < 1 || h > kMaxH || H < 1 || H > kMaxH ||
      (rown == nullptr) != (rcross == nullptr) ||
      (stash == nullptr) != (tend == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  float* o = (float*)out;
  if (stash != nullptr) {
    const Stash keep = stash_in(stash, tend, rows, L, H);
    switch (ncol) {
      case 2: return (int)launch_forward<2, true>(p, o, keep, st);
      case 3: return (int)launch_forward<3, true>(p, o, keep, st);
      case 4: return (int)launch_forward<4, true>(p, o, keep, st);
      case 5: return (int)launch_forward<5, true>(p, o, keep, st);
      case 6: return (int)launch_forward<6, true>(p, o, keep, st);
      case 7: return (int)launch_forward<7, true>(p, o, keep, st);
      case 8: return (int)launch_forward<8, true>(p, o, keep, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  const Stash none{nullptr, nullptr, nullptr, nullptr};
  switch (ncol) {
    case 2: return (int)launch_forward<2, false>(p, o, none, st);
    case 3: return (int)launch_forward<3, false>(p, o, none, st);
    case 4: return (int)launch_forward<4, false>(p, o, none, st);
    case 5: return (int)launch_forward<5, false>(p, o, none, st);
    case 6: return (int)launch_forward<6, false>(p, o, none, st);
    case 7: return (int)launch_forward<7, false>(p, o, none, st);
    case 8: return (int)launch_forward<8, false>(p, o, none, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
