// Staging in shared memory: asynchronous copies from device memory
// (cp.async), a row of any width staged in 16-byte pieces, and the opt-in
// to more than 48 KB of dynamic shared memory. Shared by the hidden-layer
// kernels (hidden_tc.cuh), the merge (merge.cu) and the cross lookup
// (cross_lookup.cu).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace smem {

// A copy of BYTES (4 or 16) from device to shared memory, left in flight:
// 16-byte copies go through L2 only (cp.async.cg), and both addresses must
// then be 16-byte aligned.
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(BYTES)
                 : "memory");
}

// A 4-byte copy of which only the first `bytes` (0 to 4) are read from src
// (4-byte aligned); the rest of the 4 bytes in shared memory are zeroed.
__device__ __forceinline__ void copy_async_part(void* dst, const void* src,
                                                unsigned bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Words of shared memory an array of n words takes when staged: room for up
// to 3 words ahead of it (its device address modulo 16 bytes), a multiple
// of 4.
__host__ __device__ constexpr int region(int n) { return (n + 7) & ~3; }

// A 4-byte aligned address's offset in words from the 16 bytes below it.
__device__ __forceinline__ int misalign(const void* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// Copy n words from src (device) into the region at dst16 (16-byte
// aligned), at the offset matching src modulo 16 bytes, as thread t of T:
// 16-byte copies between a ragged head and tail of 4-byte ones. Returns
// where the copy starts; the copies are left in flight.
__device__ __forceinline__ uint32_t* stage(uint32_t* dst16,
                                           const uint32_t* src, int n, int t,
                                           int T) {
  uint32_t* dst = dst16 + misalign(src);
  const int head = min((4 - misalign(src)) & 3, n);
  const int body = (n - head) / 4;
  for (int i = t; i < head; i += T) copy_async<4>(dst + i, src + i);
  for (int i = t; i < body; i += T)
    copy_async<16>(dst + head + 4 * i, src + head + 4 * i);
  for (int i = head + 4 * body + t; i < n; i += T)
    copy_async<4>(dst + i, src + i);
  return dst;
}

// Dynamic shared memory above the default 48 KB needs an opt-in per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace smem
