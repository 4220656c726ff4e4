// Staging in shared memory: asynchronous copies from device memory
// (cp.async) and the opt-in to more than 48 KB of dynamic shared memory.
// Shared by the hidden-layer kernels (hidden_tc.cuh) and the merge
// (merge.cu).

#pragma once

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

// Dynamic shared memory above the default 48 KB needs an opt-in per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace smem
