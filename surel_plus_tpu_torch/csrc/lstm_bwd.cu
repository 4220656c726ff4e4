// Masked LSTM over given input rows, backward (K5 bwd): the gradient of the
// forward (lstm.cu, K5) with respect to x [R, L, h], wi [h, 4H], wh [H, 4H]
// and bh [4H], given the cotangent g = dL/dout [R, H]; the mask gets none.
// Per row, in reverse over the slots, from dh = g and dc = 0:
//
//   gi, gf, gg, go: the gates after their activations; c = gf c_prev + gi gg
//   dgo = dh tanh(c) go (1 - go);        dc~ = dc + dh go (1 - tanh(c)^2)
//   dgi = dc~ gg gi (1 - gi);  dgf = dc~ c_prev gf (1 - gf);
//   dgg = dc~ gi (1 - gg^2)
//   dgates = [dgi, dgf, dgg, dgo] where mask, else 0                  [4H]
//   dwi += x^T dgates;  dwh += h_prev^T dgates;  dbh += dgates
//   dx[r, l] = dgates wi^T                        (exactly 0 where masked)
//   dh_prev = dgates wh^T where mask, else dh
//   dc_prev = dc~ gf where mask, else dc
//
// Replaces the TPU kernel surel_plus_tpu/ops/pallas/lstm_kernel.py
// _lstm_bwd_kernel (launched by lstm_final_hidden's custom VJP). That kernel
// keeps chunk-boundary carries in VMEM and re-runs each chunk's forward
// before its reverse pass, for its small VMEM; it reads the mask from x's
// last lane. This one reads the mask plane and keeps the whole forward.
//
// Design: K4 bwd's (lstm_tc.cuh), with x given in place of the keys. The
// training forward, K5's own step loop (`forward_kernel` with STASH), has
// kept every step's activated gates and entering carries (padded rows x L
// x 6H fp32, 5.7 GB at R = 8192, L = 301, H = 96; one group of rows at a
// time past a fixed budget), so the gates are K5's bit for bit over the
// same rows in the same order (`row_order`), and this entry point runs no
// forward. It runs the reverse
// sweep (dh_prev = dgates wh^T on the tensor cores in 3xTF32), the dx pass
// (dx = dgates wi^T, written at every row's every slot: 0 where the slot is
// masked or past its block's last valid slot), the weight gradients
// [dwi; dwh] (x read from its rows) and dbh, and a fixed-order reduction.
//
// Bound on the H100: the stash read once and dx written (about 2.5 GB and
// 0.93 GB at the bench width, about 1 ms at 3.35 TB/s), against the
// products dh_prev, dx, dwi and dwh, 4 x 4H (h + H) multiply-adds per valid
// (row, slot), some 4.3 ms on the fp32 CUDA cores or, in 3xTF32 on the
// tensor cores, 1.8 ms at 495 TFLOP/s. chip_smoke.py counts both from its
// inputs.

#include "lstm_tc.cuh"

using namespace lstm;

// The stash and tend come from the training forward (lstm.cu) over the
// same operands and `order`, and are consumed. Scratch, sized by the caller
// from the shapes: part: P * (4H + (h + H) 4H) floats. dx: like x, every
// slot of each processed row written (rows: the positions of `order`, a
// subset of x's rows, or x's first rows). out: 4H + (h + H) 4H floats,
// [dbh | dwi | dwh]. P (>= 1) fixes the partition of the weight-gradient
// slabs, and with it the bits.
extern "C" int lstm_x_bwd_launch(const void* x, const void* mask,
                                 const void* order, const void* wi,
                                 const void* wh, const void* g, void* stash,
                                 void* tend, void* part, void* dx, void* out,
                                 int rows, int L, int h, int H, int P,
                                 void* stream) {
  const Operands p{nullptr,           nullptr,           (const uint8_t*)mask,
                   nullptr,           nullptr,           (const int32_t*)order,
                   nullptr,           (const float*)wi,  (const float*)wh,
                   nullptr,           rows,              L,
                   h,                 H,                 0,
                   (const float*)x};
  if (rows < 1 || L < 1 || h < 1 || h > kMaxH || H < 1 || H > kMaxH ||
      P < 1)
    return (int)cudaErrorInvalidValue;
  return (int)launch_backward<kXRows, false>(
      p, stash_in(stash, tend, rows, L, H), (const float*)g, (float*)dx,
      nullptr, (float*)part, (float*)out, P, (cudaStream_t)stream);
}
