// Fused key unpack + hidden layer + masked set sum, backward: the gradient
// of the forward (csrc/hidden_sum.cu) with respect to u_ext [ncol + 2, H],
// given the cotangent g [Q, B, H]:
//
//   dU = sum_{q,b,l} mask_own[q,b,l] * fext(kown[q,b,l])^T dz[q,b,l]
//      + sum_{b,l'}  fext(kcross[b,l'])^T dzc[b,l']
//   dz  = (z > 0) * g[q,b],  dzc = (zc > 0) * sum_q mask_cross[q,b,l'] g[q,b]
//
// with z = f(k) . U + b1 recomputed from the keys, and fext(k) = [f(k), 0,
// 1]: the masking row (ncol) of dU is always 0, the bias row (ncol + 1) is
// the sum of dz. Masked own slots never pass the relu (the masking row
// pushes them to -1e9), so they are skipped.
//
// Replaces the TPU kernel surel_plus_tpu/ops/pallas/hidden_sum_kernel.py
// (_bwd_kernel, launched by _pallas_bwd). The TPU kernel contracts
// fields^T @ dz on the MXU and routes a cross slot's cotangent through a
// group-selector matmul, carrying dU across its sequential grid; on the
// GPU blocks run in no order, so each block keeps a partial dU and a
// second pass adds the partials in a fixed order (no float atomics: two
// launches give the same bits).
//
// Bound on the H100: operations. At the bench width (Q=2, B=4096, L=301,
// Lc=602, H=96, ncol=4) it reads the forward's 30 MB of keys and masks
// and 3 MB of g (10 us at 3.35 TB/s), but for every selected slot and
// channel it recomputes z (ncol multiply-adds and a compare) and, where
// z > 0, adds ncol + 1 products into dU: on sampled sets some 2.5 GFLOP,
// about 38 us on the fp32 CUDA cores (chip_smoke.py counts it from its
// inputs). It stays in fp32: z must be recomputed exactly as the forward
// computes it (same fmaf order) so that the strict z > 0 agrees.
//
// Design: as the forward, one thread per hidden channel, U's column and
// the thread's ncol + 1 accumulators in registers. Block p walks the
// query rows p, p + P, p + 2P, ...; for each it loads its Q cotangents,
// stages a chunk of unpacked fields and a per-slot endpoint bitmask in
// shared memory, skips slots no endpoint selects, and sums the cotangents
// of the endpoints that select a slot. Partials go to part[(r * H + h) * P
// + p], so the reduction pass reads each entry's P partials contiguously.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 128;     // slots staged in shared memory per pass
constexpr int kMaxQ = 4;        // endpoints per query (link: 2, hyperedge: 4)
constexpr int kReduceThreads = 256;

struct Args {
  const uint32_t* kown;    // [Q, B, Lo]
  const uint8_t* mown;     // [Q, B, Lo] bool
  const uint32_t* kcross;  // [B, Lc]
  const uint8_t* mcross;   // [Q, B, Lc] bool
  const int32_t* rown;     // [Q, B, Lo] or null
  const int32_t* rcross;   // [B, Lc] or null
  const float* u;          // [ncol + 2, H]
  const float* g;          // [Q, B, H]
  float* part;             // [ncol + 1, H, P]
  int Q, B, Lo, Lc, H, shift, P;
};

template <int NCOL, bool ROOT>
__global__ void hidden_sum_bwd_kernel(Args a) {
  __shared__ float fs[kChunk][NCOL];
  __shared__ uint32_t sel[kChunk];
  const int h = threadIdx.x;
  const bool active = h < a.H;
  const uint32_t fmask = (1u << a.shift) - 1u;

  float uc[NCOL];
  float bias = 0.f;
#pragma unroll
  for (int i = 0; i < NCOL; ++i) uc[i] = active ? a.u[i * a.H + h] : 0.f;
  if (active) bias = a.u[(NCOL + 1) * a.H + h];
  float acc[NCOL + 1];  // field rows, then the bias row
#pragma unroll
  for (int i = 0; i <= NCOL; ++i) acc[i] = 0.f;

  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    float gq[kMaxQ];
#pragma unroll
    for (int q = 0; q < kMaxQ; ++q)
      gq[q] = (active && q < a.Q) ? a.g[((size_t)q * a.B + b) * a.H + h]
                                  : 0.f;
    // seg -1: the shared cross plane; seg 0..Q-1: endpoint seg's own row
    for (int seg = -1; seg < a.Q; ++seg) {
      const bool cross = seg < 0;
      const int L = cross ? a.Lc : a.Lo;
      const size_t row = cross ? (size_t)b * a.Lc
                               : ((size_t)seg * a.B + b) * a.Lo;
      const uint32_t* keys = (cross ? a.kcross : a.kown) + row;
      for (int base = 0; base < L; base += kChunk) {
        const int n = min(kChunk, L - base);
        __syncthreads();  // the previous chunk is consumed
        for (int s = threadIdx.x; s < n; s += blockDim.x) {
          const int l = base + s;
          uint32_t m = 0;
          if (cross) {
            for (int q = 0; q < a.Q; ++q)
              m |= (uint32_t)(a.mcross[((size_t)q * a.B + b) * a.Lc + l] != 0)
                   << q;
          } else {
            m = (uint32_t)(a.mown[row + l] != 0) << seg;
          }
          sel[s] = m;
          const uint32_t k = keys[l];
#pragma unroll
          for (int i = 0; i < NCOL; ++i) {
            float v;
            if (ROOT && i == NCOL - 1) {
              v = (float)(cross ? a.rcross : a.rown)[row + l];
            } else {
              const uint32_t fm = (!ROOT && i == NCOL - 1) ? 1u : fmask;
              v = (float)((k >> (i * a.shift)) & fm);
            }
            fs[s][i] = v;
          }
        }
        __syncthreads();
        if (active) {
          for (int s = 0; s < n; ++s) {
            const uint32_t m = sel[s];
            if (m == 0) continue;  // uniform across the block
            // z exactly as the forward computes it
            float z = bias;
#pragma unroll
            for (int i = 0; i < NCOL; ++i) z = fmaf(fs[s][i], uc[i], z);
            if (!(z > 0.f)) continue;
            float dz = 0.f;
#pragma unroll
            for (int q = 0; q < kMaxQ; ++q)
              if ((m >> q) & 1u) dz += gq[q];
#pragma unroll
            for (int i = 0; i < NCOL; ++i) acc[i] = fmaf(fs[s][i], dz, acc[i]);
            acc[NCOL] += dz;
          }
        }
      }
    }
  }
  if (active) {
#pragma unroll
    for (int i = 0; i <= NCOL; ++i)
      a.part[((size_t)i * a.H + h) * a.P + blockIdx.x] = acc[i];
  }
}

// One block per dU entry: the entry's P partials, summed in a fixed order
// (a strided pass per thread, then a tree over the block).
__global__ void hidden_sum_bwd_reduce(const float* part, float* du, int ncol,
                                      int H, int P) {
  __shared__ float red[kReduceThreads];
  const int e = blockIdx.x;  // entry r * H + h of du [ncol + 2, H]
  const int r = e / H;
  const int h = e % H;
  if (r == ncol) {  // the masking row: masked slots have zero gradient
    if (threadIdx.x == 0) du[e] = 0.f;
    return;
  }
  const int pr = r < ncol ? r : ncol;  // partial row of the bias: ncol
  const float* p = part + ((size_t)pr * H + h) * P;
  float s = 0.f;
  for (int i = threadIdx.x; i < P; i += kReduceThreads) s += p[i];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = kReduceThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) du[e] = red[0];
}

template <int NCOL>
void launch(const Args& a, bool root, cudaStream_t stream) {
  const int threads = ((a.H + 31) / 32) * 32;
  if (root)
    hidden_sum_bwd_kernel<NCOL, true><<<a.P, threads, 0, stream>>>(a);
  else
    hidden_sum_bwd_kernel<NCOL, false><<<a.P, threads, 0, stream>>>(a);
}

}  // namespace

// part: scratch of (ncol + 1) * H * P floats; P (1 <= P <= B) fixes the
// partition of the rows, and with it the bits of the result.
extern "C" int hidden_sum_bwd_launch(const void* kown, const void* mown,
                                     const void* kcross, const void* mcross,
                                     const void* rown, const void* rcross,
                                     const void* u, const void* g, void* part,
                                     void* du, int Q, int B, int Lo, int Lc,
                                     int H, int ncol, int shift, int P,
                                     void* stream) {
  const Args a{(const uint32_t*)kown, (const uint8_t*)mown,
               (const uint32_t*)kcross, (const uint8_t*)mcross,
               (const int32_t*)rown, (const int32_t*)rcross,
               (const float*)u, (const float*)g, (float*)part,
               Q, B, Lo, Lc, H, shift, P};
  const bool root = rown != nullptr;
  const cudaStream_t s = (cudaStream_t)stream;
  if (Q < 1 || Q > kMaxQ || H < 1 || H > 1024 || B < 1 || P < 1 || P > B)
    return (int)cudaErrorInvalidValue;
  switch (ncol) {
    case 2: launch<2>(a, root, s); break;
    case 3: launch<3>(a, root, s); break;
    case 4: launch<4>(a, root, s); break;
    case 5: launch<5>(a, root, s); break;
    case 6: launch<6>(a, root, s); break;
    case 7: launch<7>(a, root, s); break;
    case 8: launch<8>(a, root, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hidden_sum_bwd_reduce<<<(ncol + 2) * H, kReduceThreads, 0, s>>>(
      (const float*)part, (float*)du, ncol, H, P);
  return (int)cudaGetLastError();
}
