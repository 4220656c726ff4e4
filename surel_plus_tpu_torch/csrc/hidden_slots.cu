// Fused key unpack + hidden layer, per slot, pair-summed (K7), forward:
//
//   out[q,b,l,:] = relu(f(kown[q,b,l]) . U + b1)
//                + relu(f(kcross[q,b,l]) . U + b1)
//
// f(k) unpacks a packed landing-count key into its ncol fields: field i is
// (k >> i*shift) & (2^shift - 1), the last field is the root bit, or comes
// from an int32 root plane for the layouts whose root bit lies outside the
// lo word. U = u_ext[0:ncol] (W1's rows permuted and scaled), b1 =
// u_ext[ncol+1]; u_ext[ncol] (the masking row) meets a zero column and is
// not read. kcross is slot-aligned (the join's kcross_al). Both sides are
// summed in fp32 and rounded once to the output type (fp32 or bf16). No
// slot is skipped: a key 0 (an absent partner, a padded slot) gives
// relu(b1), which is what the feature route gives for a zero feature row;
// the aggregators mask the padded slots.
//
// Replaces the TPU kernel surel_plus_tpu/ops/pallas/hidden_sum_kernel.py
// (_slots_fwd_kernel, launched by _slots_pallas_fwd). The TPU kernel lays
// the fields on sublanes to reach the MXU with fields^T @ U; with ncol <= 8
// a product that thin has no use for tensor cores here.
//
// Bound on the H100: bytes. At the bench width (Q=2, B=4096, L=301, H=96,
// ncol=4) it reads 20 MB of keys and writes the [Q, B, L, H] rows, 473 MB
// in bf16 (947 MB in fp32): about 0.15 ms at 3.35 TB/s, against some
// 4.5 GFLOP (0.07 ms on the fp32 CUDA cores). So the design serves the
// write: every warp stores 32 consecutive channels of one slot.
//
// Design: blocks of (H rounded up to 32) x kLanes threads (fewer lanes
// past H = 256), one thread per hidden channel in x, with U's column and
// b1[h] in registers. The slots are flattened (q, b, l) and a block takes
// a tile of kTile of them: its threads unpack the tile's keys, both sides,
// into float fields in shared memory (one unpack per slot, not per
// channel), then lane y computes the tile's slots y, y + kLanes, ...,
// reading the fields as broadcasts.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;  // slots a block stages in shared memory
constexpr int kLanes = 4;   // slot lanes of a block (threadIdx.y)

struct Args {
  const uint32_t* kown;   // [N] (N = Q * B * L slots)
  const uint32_t* kcross; // [N], slot-aligned
  const int32_t* rown;    // [N] or null
  const int32_t* rcross;  // [N] or null
  const float* u;         // [ncol + 2, H]
  void* out;              // [N, H] float or bf16
  size_t N;
  int H, shift;
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int NCOL, bool ROOT, typename T>
__global__ void hidden_slots_fwd_kernel(Args a) {
  __shared__ float fs[2][kTile][NCOL];
  const int h = threadIdx.x;
  const bool active = h < a.H;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const uint32_t fmask = (1u << a.shift) - 1u;

  float uc[NCOL];
  float bias = 0.f;
#pragma unroll
  for (int i = 0; i < NCOL; ++i) uc[i] = active ? a.u[i * a.H + h] : 0.f;
  if (active) bias = a.u[(NCOL + 1) * a.H + h];

  const size_t base = (size_t)blockIdx.x * kTile;
  const size_t rest = a.N - base;
  const int n = rest < (size_t)kTile ? (int)rest : kTile;
  for (int s = tid; s < 2 * n; s += nthreads) {
    const int side = s / n;
    const int j = s - side * n;
    const size_t slot = base + j;
    const uint32_t k = (side ? a.kcross : a.kown)[slot];
#pragma unroll
    for (int i = 0; i < NCOL; ++i) {
      float v;
      if (ROOT && i == NCOL - 1) {
        v = (float)(side ? a.rcross : a.rown)[slot];
      } else {
        const uint32_t fm = (!ROOT && i == NCOL - 1) ? 1u : fmask;
        v = (float)((k >> (i * a.shift)) & fm);
      }
      fs[side][j][i] = v;
    }
  }
  __syncthreads();
  if (!active) return;
  T* out = (T*)a.out;
  for (int j = threadIdx.y; j < n; j += blockDim.y) {
    float z0 = bias, z1 = bias;
#pragma unroll
    for (int i = 0; i < NCOL; ++i) {
      z0 = fmaf(fs[0][j][i], uc[i], z0);
      z1 = fmaf(fs[1][j][i], uc[i], z1);
    }
    store(out + (base + j) * a.H + h, fmaxf(z0, 0.f) + fmaxf(z1, 0.f));
  }
}

template <int NCOL>
void launch(const Args& a, bool root, bool bf16, cudaStream_t stream) {
  const int hx = ((a.H + 31) / 32) * 32;
  const dim3 block(hx, hx * kLanes <= 1024 ? kLanes : 1024 / hx);
  const unsigned grid = (unsigned)((a.N + kTile - 1) / kTile);
  if (root) {
    if (bf16)
      hidden_slots_fwd_kernel<NCOL, true, __nv_bfloat16>
          <<<grid, block, 0, stream>>>(a);
    else
      hidden_slots_fwd_kernel<NCOL, true, float>
          <<<grid, block, 0, stream>>>(a);
  } else {
    if (bf16)
      hidden_slots_fwd_kernel<NCOL, false, __nv_bfloat16>
          <<<grid, block, 0, stream>>>(a);
    else
      hidden_slots_fwd_kernel<NCOL, false, float>
          <<<grid, block, 0, stream>>>(a);
  }
}

}  // namespace

// out: [Q, B, L, H], bf16 when `bf16` is 1, else float.
extern "C" int hidden_slots_fwd_launch(const void* kown, const void* kcross,
                                       const void* rown, const void* rcross,
                                       const void* u, void* out, int Q, int B,
                                       int L, int H, int ncol, int shift,
                                       int bf16, void* stream) {
  const Args a{(const uint32_t*)kown, (const uint32_t*)kcross,
               (const int32_t*)rown, (const int32_t*)rcross, (const float*)u,
               out, (size_t)Q * B * L, H, shift};
  const bool root = rown != nullptr;
  const cudaStream_t s = (cudaStream_t)stream;
  if (Q < 1 || B < 1 || L < 1 || H < 1 || H > 1024 ||
      (root != (rcross != nullptr)))
    return (int)cudaErrorInvalidValue;
  switch (ncol) {
    case 2: launch<2>(a, root, bf16, s); break;
    case 3: launch<3>(a, root, bf16, s); break;
    case 4: launch<4>(a, root, bf16, s); break;
    case 5: launch<5>(a, root, bf16, s); break;
    case 6: launch<6>(a, root, bf16, s); break;
    case 7: launch<7>(a, root, bf16, s); break;
    case 8: launch<8>(a, root, bf16, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
