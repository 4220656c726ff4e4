// Fused attention pool, forward: for every endpoint q and query row b,
//
//   hs[l]   = relu(fext(kown[l], 1 - mask[l]) . U)
//             + relu(fext(kcross[l], 0) . U)
//   gate[l] = hs[l] . gvec + NEG * (1 - mask[l]) + gconst
//   out     = sum_l softmax_l(gate)[l] * hs[l]                    [Q, B, H]
//
// with fext(k, inv) = [f(k) | inv | 1], f(k) the key's ncol count fields
// (csrc/hidden_sum.cu), U = u_ext [ncol + 2, H] (W1's rows, the NEG row, b1)
// and gv = [gvec | gconst] [H + 1]. A masked slot's gate sits 1e9 below the
// others, so its weight is exactly 0. Also writes the softmax's residuals
// per row: m = max_l gate[l] and s = sum_l exp(gate[l] - m).
//
// Replaces the TPU kernels surel_plus_tpu/ops/pallas/hidden_sum_kernel.py
// _attn_fwd_kernel (monolithic) and _attn_cstats_kernel with its XLA
// combine (slot-chunked, for the wide shapes whose planes overflow the
// TPU's scoped VMEM). A block here streams its row's slots through shared
// memory with an online softmax, so one kernel serves every L.
//
// Bound on the H100: operations. At the bench width (Q=2, B=4096, L=301,
// H=96, ncol=4) it reads about 22 MB of keys and masks (7 us at 3.35 TB/s)
// but needs, for every valid slot and channel, two hidden rows (ncol
// multiply-adds, a bias add and a max each), the gate's multiply-add and
// the pool's: on sampled sets (about 40% of the slots valid) some
// 2.3 GFLOP, 35 us on the fp32 CUDA cores (chip_smoke.py counts it from its
// inputs). The kernel also computes the masked slots, whose weight is 0.
// It stays in fp32.
//
// Design: one block per (q, b) row, one thread per hidden channel, U's
// column and gvec[h] in registers. Per tile of 32 slots: warp 0 unpacks the
// keys into shared memory; each thread computes its channel's hidden row of
// the 32 slots (kept in shared memory) and its term of each gate; each warp
// reduces its 32 gate terms with one transposed butterfly (31 shuffles), the
// warps' partials are added in order; then the running max, sum and
// weighted sum of the online softmax are rescaled and updated.

#include "attn_pool.cuh"

namespace {

using namespace attn;

template <int NCOL, bool ROOT>
__global__ void __launch_bounds__(1024)
attn_pool_fwd_kernel(Planes p, float* out, float* m_out, float* s_out) {
  extern __shared__ float hs_sh[];  // [kTile][blockDim.x]
  __shared__ Tile<NCOL> t;
  __shared__ float red[kMaxWarps][kTile];
  __shared__ float gate[kTile];
  __shared__ float e[kTile];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int nwarps = nt >> 5;
  Channel<NCOL> c;
  c.load(p, tid);
  const float gconst = p.gv[p.H];
  const size_t off = (size_t)row * p.L;

  float m = -INFINITY;  // running max of the gates
  float ssum = 0.f;     // running sum of exp(gate - m)
  float acc = 0.f;      // running sum of exp(gate - m) * hs, channel tid
  for (int base = 0; base < p.L; base += kTile) {
    const int n = min(kTile, p.L - base);
    __syncthreads();  // the previous tile is consumed
    stage<NCOL, ROOT>(p, off + base, n, t);
    __syncthreads();
    float v[kTile];
#pragma unroll
    for (int s = 0; s < kTile; ++s) {
      const float hs = s < n ? hidden(t, s, c) : 0.f;
      hs_sh[s * nt + tid] = hs;
      v[s] = hs * c.gvec;
    }
    red[tid >> 5][tid & 31] = warp_transpose_sum(v);
    __syncthreads();
    if (tid < n) gate[tid] = gate_of(red, tid, nwarps, t.inv[tid], gconst);
    __syncthreads();
    float mt = m;
    for (int s = 0; s < n; ++s) mt = fmaxf(mt, gate[s]);
    if (tid < n) e[tid] = expf(gate[tid] - mt);
    __syncthreads();
    const float scale = expf(m - mt);  // 0 on the first tile
    ssum *= scale;
    acc *= scale;
    for (int s = 0; s < n; ++s) {
      ssum += e[s];
      acc = fmaf(e[s], hs_sh[s * nt + tid], acc);
    }
    m = mt;
  }
  if (tid < p.H) out[(size_t)row * p.H + tid] = acc / ssum;
  if (tid == 0) {
    m_out[row] = m;
    s_out[row] = ssum;
  }
}

template <int NCOL>
cudaError_t launch(const Planes& p, bool root, float* out, float* m,
                   float* s, cudaStream_t stream) {
  const int threads = ((p.H + 31) / 32) * 32;
  const size_t smem = (size_t)kTile * threads * sizeof(float);
  void (*kernel)(Planes, float*, float*, float*) =
      root ? &attn_pool_fwd_kernel<NCOL, true>
           : &attn_pool_fwd_kernel<NCOL, false>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<p.rows, threads, smem, stream>>>(p, out, m, s);
  return cudaGetLastError();
}

}  // namespace

extern "C" int attn_pool_fwd_launch(const void* kown, const void* kcross,
                                    const void* mask, const void* rown,
                                    const void* rcross, const void* u,
                                    const void* gv, void* out, void* m,
                                    void* s, int Q, int B, int L, int H,
                                    int ncol, int shift, void* stream) {
  const Planes p{(const uint32_t*)kown, (const uint32_t*)kcross,
                 (const uint8_t*)mask, (const int32_t*)rown,
                 (const int32_t*)rcross, (const float*)u, (const float*)gv,
                 Q * B, L, H, shift};
  const bool root = rown != nullptr;
  const cudaStream_t st = (cudaStream_t)stream;
  float* o = (float*)out;
  float* mm = (float*)m;
  float* ss = (float*)s;
  if (Q < 1 || B < 1 || L < 1 || H < 1 || H > 32 * kMaxWarps)
    return (int)cudaErrorInvalidValue;
  switch (ncol) {
    case 2: return (int)launch<2>(p, root, o, mm, ss, st);
    case 3: return (int)launch<3>(p, root, o, mm, ss, st);
    case 4: return (int)launch<4>(p, root, o, mm, ss, st);
    case 5: return (int)launch<5>(p, root, o, mm, ss, st);
    case 6: return (int)launch<6>(p, root, o, mm, ss, st);
    case 7: return (int)launch<7>(p, root, o, mm, ss, st);
    case 8: return (int)launch<8>(p, root, o, mm, ss, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
