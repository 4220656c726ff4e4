// Fused key unpack + hidden layer, per slot, pair-summed (K7), backward:
// the gradient of the forward (csrc/hidden_slots.cu) with respect to
// u_ext [ncol + 2, H], given the cotangent g [Q, B, L, H]:
//
//   dU = sum over slots s and both sides k in {kown[s], kcross[s]} of
//        fext(k)^T (z(k) > 0) g[s],   z(k) = f(k) . U + b1
//
// with z recomputed from the keys and fext(k) = [f(k), 0, 1]: the masking
// row (ncol) of dU is always 0, the bias row (ncol + 1) the sum of the
// cotangents past the relu. g is read in its own type (fp32 or bf16) and
// every sum is taken in fp32.
//
// Replaces the TPU kernel surel_plus_tpu/ops/pallas/hidden_sum_kernel.py
// (_slots_bwd_kernel, launched by _slots_pallas_bwd). The TPU kernel
// contracts fields^T @ dz on the MXU and carries dU across its sequential
// grid; on the GPU blocks run in no order, so each block keeps a partial
// dU and a second pass adds the partials in a fixed order (no float
// atomics: two launches give the same bits).
//
// Bound on the H100: bytes, about evenly with the operations. At the bench
// width (Q=2, B=4096, L=301, H=96, ncol=4) it reads 20 MB of keys and g,
// 473 MB in bf16 (947 MB in fp32): about 0.15 ms at 3.35 TB/s. For every
// slot, side and channel it recomputes z (ncol multiply-adds and a
// compare) and, where z > 0, adds ncol + 1 products into dU: some 7-9
// GFLOP, 0.1-0.13 ms on the fp32 CUDA cores (chip_smoke.py counts both
// from its inputs). It stays in fp32: z must be recomputed exactly as the
// forward computes it (same fmaf order) so that the strict z > 0 agrees.
//
// Design: the forward's blocks (a thread per hidden channel, kLanes slot
// lanes, U's column and the ncol + 1 accumulators in registers, a tile of
// kTile flattened slots unpacked into shared memory). Block p walks the
// tiles p, p + P, p + 2P, ...; at the end its lanes' sums are added in
// lane order and written to part[(r * H + h) * P + p], so the reduction
// pass reads each entry's P partials contiguously.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;  // slots a block stages in shared memory
constexpr int kLanes = 4;   // slot lanes of a block (threadIdx.y)
constexpr int kReduceThreads = 256;

struct Args {
  const uint32_t* kown;   // [N] (N = Q * B * L slots)
  const uint32_t* kcross; // [N], slot-aligned
  const int32_t* rown;    // [N] or null
  const int32_t* rcross;  // [N] or null
  const float* u;         // [ncol + 2, H]
  const void* g;          // [N, H] float or bf16
  float* part;            // [ncol + 1, H, P]
  size_t N;
  int H, shift, P;
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <int NCOL, bool ROOT, typename T>
__global__ void hidden_slots_bwd_kernel(Args a) {
  __shared__ float fs[2][kTile][NCOL];
  extern __shared__ float red[];  // [lanes][NCOL + 1][blockDim.x]
  const int h = threadIdx.x;
  const bool active = h < a.H;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const uint32_t fmask = (1u << a.shift) - 1u;
  const T* g = (const T*)a.g;

  float uc[NCOL];
  float bias = 0.f;
#pragma unroll
  for (int i = 0; i < NCOL; ++i) uc[i] = active ? a.u[i * a.H + h] : 0.f;
  if (active) bias = a.u[(NCOL + 1) * a.H + h];
  float acc[NCOL + 1];  // field rows, then the bias row
#pragma unroll
  for (int i = 0; i <= NCOL; ++i) acc[i] = 0.f;

  const size_t ntiles = (a.N + kTile - 1) / kTile;
  for (size_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const size_t base = t * kTile;
    const size_t rest = a.N - base;
    const int n = rest < (size_t)kTile ? (int)rest : kTile;
    __syncthreads();  // the previous tile is consumed
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
    if (active) {
      for (int j = threadIdx.y; j < n; j += blockDim.y) {
        const float gv = load(g + (base + j) * a.H + h);
#pragma unroll
        for (int side = 0; side < 2; ++side) {
          // z exactly as the forward computes it
          float z = bias;
#pragma unroll
          for (int i = 0; i < NCOL; ++i) z = fmaf(fs[side][j][i], uc[i], z);
          if (!(z > 0.f)) continue;
#pragma unroll
          for (int i = 0; i < NCOL; ++i)
            acc[i] = fmaf(fs[side][j][i], gv, acc[i]);
          acc[NCOL] += gv;
        }
      }
    }
  }
  if (active) {
#pragma unroll
    for (int i = 0; i <= NCOL; ++i)
      red[(threadIdx.y * (NCOL + 1) + i) * blockDim.x + h] = acc[i];
  }
  __syncthreads();
  if (active && threadIdx.y == 0) {
#pragma unroll
    for (int i = 0; i <= NCOL; ++i) {
      float s = 0.f;
      for (int y = 0; y < (int)blockDim.y; ++y)
        s += red[(y * (NCOL + 1) + i) * blockDim.x + h];
      a.part[((size_t)i * a.H + h) * a.P + blockIdx.x] = s;
    }
  }
}

// One block per dU entry: the entry's P partials, summed in a fixed order
// (a strided pass per thread, then a tree over the block).
__global__ void hidden_slots_bwd_reduce(const float* part, float* du,
                                        int ncol, int H, int P) {
  __shared__ float red[kReduceThreads];
  const int e = blockIdx.x;  // entry r * H + h of du [ncol + 2, H]
  const int r = e / H;
  const int h = e % H;
  if (r == ncol) {  // the masking row meets a zero column
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

template <int NCOL, bool ROOT, typename T>
void launch_typed(const Args& a, cudaStream_t stream) {
  const int hx = ((a.H + 31) / 32) * 32;
  const dim3 block(hx, hx * kLanes <= 1024 ? kLanes : 1024 / hx);
  const size_t smem = sizeof(float) * block.y * (NCOL + 1) * hx;
  hidden_slots_bwd_kernel<NCOL, ROOT, T><<<a.P, block, smem, stream>>>(a);
}

template <int NCOL>
void launch(const Args& a, bool root, bool bf16, cudaStream_t stream) {
  if (root) {
    if (bf16) launch_typed<NCOL, true, __nv_bfloat16>(a, stream);
    else launch_typed<NCOL, true, float>(a, stream);
  } else {
    if (bf16) launch_typed<NCOL, false, __nv_bfloat16>(a, stream);
    else launch_typed<NCOL, false, float>(a, stream);
  }
}

}  // namespace

// g: [Q, B, L, H], bf16 when `bf16` is 1, else float. part: scratch of
// (ncol + 1) * H * P floats; P (1 <= P) fixes the partition of the slots,
// and with it the bits of the result.
extern "C" int hidden_slots_bwd_launch(const void* kown, const void* kcross,
                                       const void* rown, const void* rcross,
                                       const void* u, const void* g,
                                       void* part, void* du, int Q, int B,
                                       int L, int H, int ncol, int shift,
                                       int bf16, int P, void* stream) {
  const Args a{(const uint32_t*)kown, (const uint32_t*)kcross,
               (const int32_t*)rown, (const int32_t*)rcross, (const float*)u,
               g, (float*)part, (size_t)Q * B * L, H, shift, P};
  const bool root = rown != nullptr;
  const cudaStream_t s = (cudaStream_t)stream;
  if (Q < 1 || B < 1 || L < 1 || H < 1 || H > 1024 || P < 1 ||
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
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hidden_slots_bwd_reduce<<<(ncol + 2) * H, kReduceThreads, 0, s>>>(
      a.part, (float*)du, ncol, H, P);
  return (int)cudaGetLastError();
}
