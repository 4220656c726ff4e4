// Fused key unpack + hidden layer + masked set sum, forward:
//
//   out[q,b,:] = sum_l  mask_own[q,b,l]   * relu(f(kown[q,b,l]) . U + b1)
//              + sum_l' mask_cross[q,b,l'] * relu(f(kcross[b,l']) . U + b1)
//
// f(k) unpacks a packed landing-count key into its ncol fields: field i is
// (k >> i*shift) & (2^shift - 1), the last field is the root bit, or comes
// from an int32 root plane for the layouts whose root bit lies outside the
// lo word. U = u_ext[0:ncol] (W1's rows permuted and scaled), b1 =
// u_ext[ncol+1]; u_ext[ncol] is the TPU kernel's masking row, which this
// kernel replaces by skipping unselected slots.
//
// Replaces the TPU kernel surel_plus_tpu/ops/pallas/hidden_sum_kernel.py
// (_fwd_kernel). The TPU kernel reaches the MXU by laying fields on
// sublanes and splits the shared cross plane per endpoint with a
// group-selector matmul; neither carries over.
//
// Bound on the H100: operations. At the bench width (Q=2, B=4096, L=301,
// Lc=602, H=96, ncol=4) the kernel reads about 30 MB (9 us at 3.35 TB/s)
// but does ncol multiply-adds and a max per hidden channel for every
// selected slot: on sampled sets (about 40% of the slots valid) some
// 1.9 GFLOP in fp32, which the CUDA cores (67 TFLOP/s) need about 28 us
// for (chip_smoke.py computes the bound from its inputs). The kernel stays
// in full fp32, with no tensor cores (TF32 would keep three decimal digits
// of the sums).
//
// Design: one block per query row b, one thread per hidden channel h; U's
// column h and b1[h] sit in registers. The block walks the shared cross
// plane once, then each endpoint's own row, in chunks of slots: the
// threads unpack a chunk's keys into float fields in shared memory (one
// unpack per slot, not per channel) with one selection bitmask per slot,
// then every thread reads them as broadcasts. A cross slot's activation
// is computed once and added to every endpoint that selects it. A slot
// that no endpoint selects is skipped by the whole block.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 128;  // slots staged in shared memory per pass
constexpr int kMaxQ = 4;     // endpoints per query (link: 2, hyperedge: 4)

struct Args {
  const uint32_t* kown;    // [Q, B, Lo]
  const uint8_t* mown;     // [Q, B, Lo] bool
  const uint32_t* kcross;  // [B, Lc]
  const uint8_t* mcross;   // [Q, B, Lc] bool
  const int32_t* rown;     // [Q, B, Lo] or null
  const int32_t* rcross;   // [B, Lc] or null
  const float* u;          // [ncol + 2, H]
  float* out;              // [Q, B, H]
  int Q, B, Lo, Lc, H, shift;
};

template <int NCOL, bool ROOT>
__global__ void hidden_sum_fwd_kernel(Args a) {
  __shared__ float fs[kChunk][NCOL];
  __shared__ uint32_t sel[kChunk];
  const int b = blockIdx.x;
  const int h = threadIdx.x;
  const bool active = h < a.H;
  const uint32_t fmask = (1u << a.shift) - 1u;

  float uc[NCOL];
  float bias = 0.f;
#pragma unroll
  for (int i = 0; i < NCOL; ++i) uc[i] = active ? a.u[i * a.H + h] : 0.f;
  if (active) bias = a.u[(NCOL + 1) * a.H + h];
  float acc[kMaxQ];
#pragma unroll
  for (int q = 0; q < kMaxQ; ++q) acc[q] = 0.f;

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
          float z = bias;
#pragma unroll
          for (int i = 0; i < NCOL; ++i) z = fmaf(fs[s][i], uc[i], z);
          z = fmaxf(z, 0.f);
#pragma unroll
          for (int q = 0; q < kMaxQ; ++q)
            if ((m >> q) & 1u) acc[q] += z;
        }
      }
    }
  }
  if (active) {
#pragma unroll
    for (int q = 0; q < kMaxQ; ++q)
      if (q < a.Q) a.out[((size_t)q * a.B + b) * a.H + h] = acc[q];
  }
}

template <int NCOL>
void launch(const Args& a, bool root, cudaStream_t stream) {
  const int threads = ((a.H + 31) / 32) * 32;
  if (root)
    hidden_sum_fwd_kernel<NCOL, true><<<a.B, threads, 0, stream>>>(a);
  else
    hidden_sum_fwd_kernel<NCOL, false><<<a.B, threads, 0, stream>>>(a);
}

}  // namespace

extern "C" int hidden_sum_fwd_launch(const void* kown, const void* mown,
                                     const void* kcross, const void* mcross,
                                     const void* rown, const void* rcross,
                                     const void* u, void* out, int Q, int B,
                                     int Lo, int Lc, int H, int ncol,
                                     int shift, void* stream) {
  const Args a{(const uint32_t*)kown, (const uint8_t*)mown,
               (const uint32_t*)kcross, (const uint8_t*)mcross,
               (const int32_t*)rown, (const int32_t*)rcross,
               (const float*)u, (float*)out, Q, B, Lo, Lc, H, shift};
  const bool root = rown != nullptr;
  const cudaStream_t s = (cudaStream_t)stream;
  if (Q < 1 || Q > kMaxQ || H < 1 || H > 1024 || B < 1)
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
  return (int)cudaGetLastError();
}
