// Fused attention pool, backward: the gradient of the forward
// (csrc/attn_pool.cu) with respect to u_ext [ncol + 2, H] and
// gv = [gvec | gconst] [H + 1], given the cotangent g [Q, B, H] and the
// forward's residuals m, s [Q, B]. Per row, with hs, gate recomputed from
// the keys exactly as the forward computes them:
//
//   a     = exp(gate - m) / s                 the forward's softmax weights
//   da    = hs . g,    t = sum_l a * da
//   dgate = a * (da - t)                      the softmax's VJP
//   dhs   = a * g + dgate * gvec
//   dU   += fext_own^T (z_own > 0) dhs + fext_cross^T (z_cross > 0) dhs
//   dgvec += hs * dgate,   dgconst += dgate
//
// Replaces the TPU kernels surel_plus_tpu/ops/pallas/hidden_sum_kernel.py
// _attn_bwd_kernel (monolithic) and _attn_ct_kernel + _attn_cbwd_kernel
// (the slot-chunked t-pass and gradient pass). The TPU kernels carry dU and
// dgv across their sequential grid; on the GPU blocks run in no order, so
// each block keeps partial sums and a second pass adds the partials in a
// fixed order (no float atomics: two launches give the same bits).
//
// Bound on the H100: operations. At the bench width (Q=2, B=4096, L=301,
// H=96, ncol=4) it reads the forward's 22 MB of keys and masks and 3 MB of
// g, but needs, per valid slot and channel, the hidden row again, the
// gate's and da's multiply-adds, dhs and dgvec's multiply-add, and where
// a side's z > 0 its 2 ncol + 1 operations into dU: some 3.6 GFLOP in
// fp32, 53 us on the CUDA cores (chip_smoke.py counts it from its inputs).
// The kernel recomputes the hidden rows twice, masked slots included.
//
// Design: as the forward, one thread per hidden channel. Block p walks the
// rows p, p + P, p + 2P, ... Per row, pass A recomputes each tile's hidden
// rows, reduces each slot's gate and da over the channels (two transposed
// butterflies) and keeps a and da of every slot in shared memory (2 L
// floats); warp 0 sums t in order; then dgate replaces da. Pass B
// recomputes z per tile and accumulates the thread's column of dU and its
// dgvec entry in registers. Partials go to part[(e * P) + p] for the entry
// e of out = [dU (row-major) | dgvec | dgconst], so the reduction pass reads
// each entry's P partials contiguously.

#include "attn_pool.cuh"

namespace {

using namespace attn;

constexpr int kReduceThreads = 256;

template <int NCOL, bool ROOT>
__global__ void __launch_bounds__(1024)
attn_pool_bwd_kernel(Planes p, const float* g, const float* m_in,
                     const float* s_in, float* part) {
  extern __shared__ float dyn[];  // hs [kTile][blockDim.x] | a [L] | d [L]
  __shared__ Tile<NCOL> t;
  __shared__ float red_gate[kMaxWarps][kTile];
  __shared__ float red_da[kMaxWarps][kTile];
  __shared__ float t_sh;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int nwarps = nt >> 5;
  const int P = gridDim.x;
  float* hs_sh = dyn;
  float* a_sh = dyn + kTile * nt;
  float* d_sh = a_sh + p.L;
  Channel<NCOL> c;
  c.load(p, tid);
  const bool active = tid < p.H;
  const float gconst = p.gv[p.H];

  float acc_u[NCOL];   // dU rows of the fields
  float acc_neg = 0.f;  // dU's NEG row
  float acc_b = 0.f;    // dU's b1 row
  float acc_g = 0.f;    // dgvec[tid]
  float acc_c = 0.f;    // dgconst (the same in every thread)
#pragma unroll
  for (int i = 0; i < NCOL; ++i) acc_u[i] = 0.f;

  for (int row = blockIdx.x; row < p.rows; row += P) {
    const size_t off = (size_t)row * p.L;
    const float gh = active ? g[(size_t)row * p.H + tid] : 0.f;
    const float m = m_in[row];
    const float s_row = s_in[row];

    // pass A: a and da of every slot
    for (int base = 0; base < p.L; base += kTile) {
      const int n = min(kTile, p.L - base);
      __syncthreads();  // the previous tile (or row) is consumed
      stage<NCOL, ROOT>(p, off + base, n, t);
      __syncthreads();
      float v[kTile];
#pragma unroll
      for (int s = 0; s < kTile; ++s) {
        const float hs = s < n ? hidden(t, s, c) : 0.f;
        hs_sh[s * nt + tid] = hs;
        v[s] = hs * c.gvec;
      }
      red_gate[tid >> 5][tid & 31] = warp_transpose_sum(v);
#pragma unroll
      for (int s = 0; s < kTile; ++s) v[s] = hs_sh[s * nt + tid] * gh;
      red_da[tid >> 5][tid & 31] = warp_transpose_sum(v);
      __syncthreads();
      if (tid < n) {
        const float gate = gate_of(red_gate, tid, nwarps, t.inv[tid],
                                   gconst);
        float da = 0.f;
        for (int w = 0; w < nwarps; ++w) da += red_da[w][tid];
        a_sh[base + tid] = expf(gate - m) / s_row;
        d_sh[base + tid] = da;
      }
    }
    __syncthreads();
    if (tid < 32) {  // t = sum_l a * da, in a fixed order
      float tp = 0.f;
      for (int l = tid; l < p.L; l += 32) tp = fmaf(a_sh[l], d_sh[l], tp);
#pragma unroll
      for (int k = 16; k > 0; k >>= 1)
        tp += __shfl_xor_sync(0xffffffffu, tp, k);
      if (tid == 0) t_sh = tp;
    }
    __syncthreads();
    const float tsum = t_sh;
    for (int l = tid; l < p.L; l += nt) d_sh[l] = a_sh[l] * (d_sh[l] - tsum);

    // pass B: the gradients
    for (int base = 0; base < p.L; base += kTile) {
      const int n = min(kTile, p.L - base);
      __syncthreads();  // dgate is written; the previous tile is consumed
      stage<NCOL, ROOT>(p, off + base, n, t);
      __syncthreads();
      for (int s = 0; s < n; ++s) {
        const float zo = c.z(t.fo[s], t.inv[s]);
        const float zc = c.z(t.fc[s], 0.f);
        const float hs = fmaxf(zo, 0.f) + fmaxf(zc, 0.f);
        const float a = a_sh[base + s];
        const float dg = d_sh[base + s];
        const float dhs = fmaf(dg, c.gvec, a * gh);
        const float dzo = zo > 0.f ? dhs : 0.f;
        const float dzc = zc > 0.f ? dhs : 0.f;
#pragma unroll
        for (int i = 0; i < NCOL; ++i) {
          acc_u[i] = fmaf(t.fo[s][i], dzo, acc_u[i]);
          acc_u[i] = fmaf(t.fc[s][i], dzc, acc_u[i]);
        }
        acc_neg = fmaf(t.inv[s], dzo, acc_neg);
        acc_b += dzo;
        acc_b += dzc;
        acc_g = fmaf(hs, dg, acc_g);
        acc_c += dg;
      }
    }
  }
  if (active) {
    const int b = blockIdx.x;
#pragma unroll
    for (int i = 0; i < NCOL; ++i)
      part[((size_t)i * p.H + tid) * P + b] = acc_u[i];
    part[((size_t)NCOL * p.H + tid) * P + b] = acc_neg;
    part[((size_t)(NCOL + 1) * p.H + tid) * P + b] = acc_b;
    part[((size_t)(NCOL + 2) * p.H + tid) * P + b] = acc_g;
    if (tid == 0) part[(size_t)(NCOL + 3) * p.H * P + b] = acc_c;
  }
}

// One block per entry of out: the entry's P partials, summed in a fixed
// order (a strided pass per thread, then a tree over the block).
__global__ void attn_pool_bwd_reduce(const float* part, float* out, int P) {
  __shared__ float red[kReduceThreads];
  const float* q = part + (size_t)blockIdx.x * P;
  float s = 0.f;
  for (int i = threadIdx.x; i < P; i += kReduceThreads) s += q[i];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = kReduceThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = red[0];
}

template <int NCOL>
cudaError_t launch(const Planes& p, bool root, const float* g,
                   const float* m, const float* s, float* part, int P,
                   cudaStream_t stream) {
  const int threads = ((p.H + 31) / 32) * 32;
  const size_t smem = ((size_t)kTile * threads + 2 * (size_t)p.L)
                      * sizeof(float);
  void (*kernel)(Planes, const float*, const float*, const float*, float*) =
      root ? &attn_pool_bwd_kernel<NCOL, true>
           : &attn_pool_bwd_kernel<NCOL, false>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<P, threads, smem, stream>>>(p, g, m, s, part);
  return cudaGetLastError();
}

}  // namespace

// part: scratch of ((ncol + 3) * H + 1) * P floats; out: (ncol + 3) * H + 1
// floats, [dU (ncol + 2) x H | dgvec H | dgconst]. P (1 <= P <= Q * B)
// fixes the partition of the rows, and with it the bits of the result.
extern "C" int attn_pool_bwd_launch(const void* kown, const void* kcross,
                                    const void* mask, const void* rown,
                                    const void* rcross, const void* u,
                                    const void* gv, const void* g,
                                    const void* m, const void* s, void* part,
                                    void* out, int Q, int B, int L, int H,
                                    int ncol, int shift, int P,
                                    void* stream) {
  const Planes p{(const uint32_t*)kown, (const uint32_t*)kcross,
                 (const uint8_t*)mask, (const int32_t*)rown,
                 (const int32_t*)rcross, (const float*)u, (const float*)gv,
                 Q * B, L, H, shift};
  const bool root = rown != nullptr;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* gg = (const float*)g;
  const float* mm = (const float*)m;
  const float* ss = (const float*)s;
  float* pp = (float*)part;
  if (Q < 1 || B < 1 || L < 1 || H < 1 || H > 32 * kMaxWarps || P < 1
      || P > Q * B)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  switch (ncol) {
    case 2: err = launch<2>(p, root, gg, mm, ss, pp, P, st); break;
    case 3: err = launch<3>(p, root, gg, mm, ss, pp, P, st); break;
    case 4: err = launch<4>(p, root, gg, mm, ss, pp, P, st); break;
    case 5: err = launch<5>(p, root, gg, mm, ss, pp, P, st); break;
    case 6: err = launch<6>(p, root, gg, mm, ss, pp, P, st); break;
    case 7: err = launch<7>(p, root, gg, mm, ss, pp, P, st); break;
    case 8: err = launch<8>(p, root, gg, mm, ss, pp, P, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  attn_pool_bwd_reduce<<<(ncol + 3) * H + 1, kReduceThreads, 0, st>>>(
      pp, (float*)out, P);
  return (int)cudaGetLastError();
}
