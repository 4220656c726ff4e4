// Cross lookup of both key words (K6): for rows a, b [B, L] of node ids
// (int32, INT32_MAX padding) and the payload words hi_b, lo_b [B, L] of b's
// slots (uint32 bit patterns), for every row r and slot i
//
//   cross_hi[r, i] = sum over j with b[r, j] == a[r, i] of hi_b[r, j]
//   cross_lo[r, i] = the same over lo_b                       (mod 2^32)
//
// and 0 where a[r, i] is INT32_MAX. On sets (distinct nodes in a row, as the
// sampler makes them) that sum is the payload of a[r, i]'s slot in b, or 0
// when b lacks the node: the keys join's cross lookup.
//
// Replaces the TPU kernel surel_plus_tpu/ops/pallas/join_kernel.py
// _join_kernel (launched by pallas_cross_lookup_pair). That kernel builds
// the [L, L] equality mask in VMEM and contracts it on the MXU against the
// payload words split into 16-bit halves, so that the f32 sums stay exact.
// Here the comparisons run on the integer units and the sum is an integer
// one: no mask is formed and no halves are needed.
//
// Bound on the H100: bytes. Each row's four input planes are read once and
// its two output planes written once, 24 L bytes a row (about 30 MB at
// B = 4096, L = 301: 9 us at 3.35 TB/s), against a lookup that needs about
// L log2 L comparisons a row where b is sorted. This kernel does L^2: it
// scans the whole of b for every slot of a, which needs no order.
//
// Design: one block per row. The block stages b and its two payload words
// in shared memory (12 L bytes: 36 KB at L = 801), then each thread takes
// slots i, i + 128, ... of a and scans b; all lanes of a warp read the same
// b[j] at once (a broadcast). No atomics: two launches give the same bits.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
cross_lookup_kernel(const int32_t* a, const int32_t* b, const uint32_t* hi_b,
                    const uint32_t* lo_b, uint32_t* cross_hi,
                    uint32_t* cross_lo, int L) {
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* sb = smem;                                    // [L]
  uint32_t* shi = reinterpret_cast<uint32_t*>(smem + L);  // [L]
  uint32_t* slo = shi + L;                               // [L]
  const size_t base = (size_t)blockIdx.x * L;
  for (int j = threadIdx.x; j < L; j += kThreads) {
    sb[j] = b[base + j];
    shi[j] = hi_b[base + j];
    slo[j] = lo_b[base + j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < L; i += kThreads) {
    const int32_t node = a[base + i];
    uint32_t hi = 0u, lo = 0u;
    if (node != INT_MAX) {
#pragma unroll 4
      for (int j = 0; j < L; ++j) {
        if (sb[j] == node) {
          hi += shi[j];
          lo += slo[j];
        }
      }
    }
    cross_hi[base + i] = hi;
    cross_lo[base + i] = lo;
  }
}

}  // namespace

// a, b, hi_b, lo_b, cross_hi, cross_lo: [rows, L] 4-byte words.
extern "C" int cross_lookup_launch(const void* a, const void* b,
                                   const void* hi_b, const void* lo_b,
                                   void* cross_hi, void* cross_lo, int rows,
                                   int L, void* stream) {
  if (rows < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)3 * L * sizeof(int32_t);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cross_lookup_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  cross_lookup_kernel<<<rows, kThreads, bytes, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)b, (const uint32_t*)hi_b,
      (const uint32_t*)lo_b, (uint32_t*)cross_hi, (uint32_t*)cross_lo, L);
  return (int)cudaGetLastError();
}
