// Keys-LSTM, backward (K4 bwd): the gradient of the forward (lstm_keys.cu)
// with respect to u_ext [ncol + 2, h], wi [h, 4H], wh [H, 4H] and bh [4H],
// given the cotangent g = dL/dout [Q, B, H]; the keys and the mask get none.
// Per row, in reverse over the slots, from dh = g and dc = 0:
//
//   gi, gf, gg, go: the gates after their activations; c = gf c_prev + gi gg
//   dgo = dh tanh(c) go (1 - go);        dc~ = dc + dh go (1 - tanh(c)^2)
//   dgi = dc~ gg gi (1 - gi);  dgf = dc~ c_prev gf (1 - gf);
//   dgg = dc~ gi (1 - gg^2)
//   dgates = [dgi, dgf, dgg, dgo] where mask, else 0                  [4H]
//   dwi += x^T dgates;  dwh += h_prev^T dgates;  dbh += dgates
//   dx = dgates wi^T;   dU += fext_own^T (dx where z_own > 0)
//                             + fext_cross^T (dx where z_cross > 0)
//   dh_prev = dgates wh^T where mask, else dh
//   dc_prev = dc~ gf where mask, else dc
//
// with fext(k, 0) = [f(k) | 0 | 1], so dU's masking row stays 0.
//
// Replaces the TPU kernel surel_plus_tpu/ops/pallas/lstm_kernel.py
// _klstm_t2_bwd_kernel ("t2": rows sorted by valid count, chunks skipped
// by it, right only for prefix masks) and covers _klstm_t_bwd_kernel ("t1",
// any mask): dh and dc ride through masked slots, and a block starts its
// reverse sweep at its rows' last valid slot INDEX.
//
// Design (lstm_tc.cuh, shared with K5 bwd): the training forward, K4's own
// step loop (`forward_kernel` with STASH), has kept every step's activated
// gates and entering carries, so the relu decisions and the gates are K4's bit
// for bit over the same rows in the same order, and this entry point runs no
// forward. The TPU kernels keep chunk-boundary carries and re-forward each
// chunk, for their small VMEM; the card holds the stash (padded rows x L x 6H
// fp32: 5.7 GB at the bench width, 15 GB at L = 801) or, where it would pass a
// fixed budget, the stash of one group of rows at a time (the caller's loop,
// ops/kernels/lstm_keys.py). It runs the reverse sweep (dh_prev = dgates wh^T
// on the tensor cores in 3xTF32, dgates written over the stashed gates), the
// dx pass (dx = dgates wi^T; its epilogue recomputes each slot's fields from
// the keys and adds dx back through each side's relu into dU: x is recomputed,
// not stashed, which keeps the stash at 6H a slot), the weight gradients [dwi;
// dwh] and dbh over the stash's slabs, and the fixed-order reductions. h and H
// are each at most 256; h is no longer tied to H.
//
// Bound on the H100: the stash read once (about 2.5 GB of valid slabs at
// the bench width, 0.8 ms at 3.35 TB/s), against the products dh_prev, dx,
// dwi and dwh, 4 x 4H (h + H) multiply-adds per valid (row, slot), some
// 4.3 ms on the fp32 CUDA cores or, in 3xTF32 on the tensor cores, 1.8 ms
// at 495 TFLOP/s. chip_smoke.py counts both from its inputs.

#include "lstm_tc.cuh"

using namespace lstm;

// The stash and tend come from the training forward (lstm_keys.cu) over the
// same operands and `order`, and are consumed (the dgates overwrite the
// gates). Scratch, sized by the caller from the shapes:
//   part1: kDxBlocks * dx_layout_for(h).streams * (ncol + 2) h floats;
//   part2: P * (4H + (h + H) 4H) floats.
// out: (ncol + 2) h + 4H + (h + H) 4H floats, [dU | dbh | dwi | dwh]. P
// (>= 1) fixes the partition of the weight-gradient slabs, and with it the
// bits.
extern "C" int lstm_keys_bwd_launch(
    const void* kown, const void* kcross, const void* mask, const void* rown,
    const void* rcross, const void* order, const void* u, const void* wi,
    const void* wh, const void* g, void* stash, void* tend, void* part1,
    void* part2, void* out, int rows, int L, int h, int H, int ncol,
    int shift, int P, void* stream) {
  const Operands p{(const uint32_t*)kown, (const uint32_t*)kcross,
                   (const uint8_t*)mask,  (const int32_t*)rown,
                   (const int32_t*)rcross, (const int32_t*)order,
                   (const float*)u,       (const float*)wi,
                   (const float*)wh,      nullptr,
                   rows, L, h, H, shift};
  if (rows < 1 || L < 1 || H < 1 || H > kMaxH || h < 1 || h > kMaxH ||
      P < 1 || (rown == nullptr) != (rcross == nullptr))
    return (int)cudaErrorInvalidValue;
  const Stash st = stash_in(stash, tend, rows, L, H);
  const cudaStream_t cs = (cudaStream_t)stream;
  const float* gg = (const float*)g;
  float* p1 = (float*)part1;
  float* p2 = (float*)part2;
  float* o = (float*)out;
  const bool root = rown != nullptr;
#define LSTM_KEYS_BWD(n)                                                     \
  case n:                                                                    \
    return root ? (int)launch_backward<n, true>(p, st, gg, nullptr, p1, p2,  \
                                                o, P, cs)                    \
                : (int)launch_backward<n, false>(p, st, gg, nullptr, p1, p2, \
                                                 o, P, cs);
  switch (ncol) {
    LSTM_KEYS_BWD(2)
    LSTM_KEYS_BWD(3)
    LSTM_KEYS_BWD(4)
    LSTM_KEYS_BWD(5)
    LSTM_KEYS_BWD(6)
    LSTM_KEYS_BWD(7)
    LSTM_KEYS_BWD(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef LSTM_KEYS_BWD
}
