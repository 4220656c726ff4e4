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
// Uses expf / tanhf (no fast-math intrinsics) and no float atomics: two
// launches give the same bits.

#include "lstm_keys.cuh"

namespace {

using namespace lstm;

template <int NCOL, bool ROOT, bool WHS>
__global__ void __launch_bounds__(kMaxThreads)
lstm_keys_fwd_kernel(Operands p, Layout lay, Smem sm, float* out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int srow[kMaxGroups * kRows];
  __shared__ int tend;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int rb = lay.rb;
  const int ld = lay.ld;
  const int cs = rb + 1;
  const int base = blockIdx.x * rb;
  const int nrows = min(rb, p.rows - base);  // rows of this block
  float* xs = smem + sm.xs;
  float* hs = smem + sm.hs;
  uint32_t* sko = reinterpret_cast<uint32_t*>(smem + sm.ko);
  uint32_t* skc = reinterpret_cast<uint32_t*>(smem + sm.kc);
  int32_t* smk = reinterpret_cast<int32_t*>(smem + sm.mk);
  int32_t* sro = reinterpret_cast<int32_t*>(smem + sm.ro);
  int32_t* src = reinterpret_cast<int32_t*>(smem + sm.rc);
  float* su = smem + sm.u;
  float* swh = smem + sm.wh;

  for (int i = tid; i < (NCOL + 2) * p.h; i += nt) su[i] = p.u[i];
  if (WHS)
    for (int i = tid; i < 4 * p.H * p.H; i += nt) swh[i] = __ldg(p.wh + i);
  for (int i = tid; i < p.H * ld; i += nt) hs[i] = 0.f;  // h0 = 0, buffer 0
  if (tid < nrows) srow[tid] = p.order ? p.order[base + tid] : base + tid;
  if (tid == 0) tend = 0;
  __syncthreads();
  // the block's last valid slot index + 1: later steps change no carry
  int last = 0;
  for (int i = tid; i < nrows * p.L; i += nt) {
    const int r = i / p.L;
    const int l = i - r * p.L;
    if (p.mask[(size_t)srow[r] * p.L + l]) last = max(last, l + 1);
  }
  if (last) atomicMax(&tend, last);

  const int j = tid % lay.hp;
  const int g = tid / lay.hp;
  const int r0 = g * kRows;
  const bool on = j < p.H;
  float bias[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) bias[q] = on ? p.bh[q * p.H + j] : 0.f;
  float c[kRows], hv[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) c[i] = hv[i] = 0.f;
  __syncthreads();
  const int steps = tend;

  for (int t = 0; t < steps; ++t) {
    const int tt = t % kChunk;
    const int cur = t & 1;
    if (tt == 0) {
      __syncthreads();  // the previous chunk is consumed
      for (int i = tid; i < rb * kChunk; i += nt) {
        const int r = i / kChunk;
        const int s = i - r * kChunk;
        const bool in = r < nrows && t + s < p.L;
        const size_t off = in ? (size_t)srow[r] * p.L + t + s : 0;
        sko[s * cs + r] = in ? p.kown[off] : 0u;
        skc[s * cs + r] = in ? p.kcross[off] : 0u;
        smk[s * cs + r] = in ? (int32_t)(p.mask[off] != 0) : 0;
        if (ROOT) {
          sro[s * cs + r] = in ? p.rown[off] : 0;
          src[s * cs + r] = in ? p.rcross[off] : 0;
        }
      }
      __syncthreads();
    }
    // x of this slot for the block's rows, [h][ld]
    float* x = xs + cur * p.h * ld;
    for (int i = tid; i < rb * p.h; i += nt) {
      const int k = i / rb;
      const int r = i - k * rb;
      float fo[NCOL], fc[NCOL];
      fields<NCOL, ROOT>(sko[tt * cs + r], ROOT ? sro[tt * cs + r] : 0,
                         p.shift, fo);
      fields<NCOL, ROOT>(skc[tt * cs + r], ROOT ? src[tt * cs + r] : 0,
                         p.shift, fc);
      x[k * ld + r] = hidden(fo, fc, su, p.h, k);
    }
    __syncthreads();  // x ready; h of the previous step ready
    float acc[4][kRows];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[q][i] = bias[q];
    gate_sum<false>(acc, p.wi, x, p.h, p.H, ld, j, on, r0);
    gate_sum<WHS>(acc, WHS ? swh : p.wh, hs + cur * p.H * ld, p.H, p.H, ld,
                  j, on, r0);
    float* hn = hs + (cur ^ 1) * p.H * ld;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (smk[tt * cs + r0 + i])
        cell(acc[0][i], acc[1][i], acc[2][i], acc[3][i], c[i], hv[i]);
      if (on) hn[j * ld + r0 + i] = hv[i];
    }
  }
  if (on) {
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      if (r0 + i < nrows) out[(size_t)srow[r0 + i] * p.H + j] = hv[i];
  }
}

template <int NCOL, bool WHS>
cudaError_t launch(const Operands& p, const Layout& lay, const Smem& sm,
                   float* out, cudaStream_t stream) {
  const size_t bytes = (size_t)sm.words * sizeof(float);
  void (*kernel)(Operands, Layout, Smem, float*) =
      p.rown ? &lstm_keys_fwd_kernel<NCOL, true, WHS>
             : &lstm_keys_fwd_kernel<NCOL, false, WHS>;
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (p.rows + lay.rb - 1) / lay.rb;
  kernel<<<blocks, lay.hp * lay.groups, bytes, stream>>>(p, lay, sm, out);
  return cudaGetLastError();
}

template <int NCOL>
cudaError_t launch(const Operands& p, float* out, cudaStream_t stream) {
  const Layout lay = layout_for(p.H);
  const Smem with_wh = smem_for(lay, p.h, p.H, NCOL, true);
  if ((size_t)with_wh.words * sizeof(float) <= (size_t)kMaxSmem)
    return launch<NCOL, true>(p, lay, with_wh, out, stream);
  return launch<NCOL, false>(p, lay, smem_for(lay, p.h, p.H, NCOL, false),
                             out, stream);
}

}  // namespace

extern "C" int lstm_keys_fwd_launch(const void* kown, const void* kcross,
                                    const void* mask, const void* rown,
                                    const void* rcross, const void* order,
                                    const void* u, const void* wi,
                                    const void* wh, const void* bh, void* out,
                                    int rows, int L, int h, int H, int ncol,
                                    int shift, void* stream) {
  const Operands p{(const uint32_t*)kown, (const uint32_t*)kcross,
                   (const uint8_t*)mask,  (const int32_t*)rown,
                   (const int32_t*)rcross, (const int32_t*)order,
                   (const float*)u,       (const float*)wi,
                   (const float*)wh,      (const float*)bh,
                   rows, L, h, H, shift};
  if (rows < 1 || L < 1 || h < 1 || h > kMaxH || H < 1 || H > kMaxH ||
      (rown == nullptr) != (rcross == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  float* o = (float*)out;
  switch (ncol) {
    case 2: return (int)launch<2>(p, o, st);
    case 3: return (int)launch<3>(p, o, st);
    case 4: return (int)launch<4>(p, o, st);
    case 5: return (int)launch<5>(p, o, st);
    case 6: return (int)launch<6>(p, o, st);
    case 7: return (int)launch<7>(p, o, st);
    case 8: return (int)launch<8>(p, o, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
