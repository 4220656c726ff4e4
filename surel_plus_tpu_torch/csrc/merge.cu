// Merge of two ascending rows of unsigned 32-bit keys, each key carrying
// one 32-bit payload: out = a stable sort of concat(a, b) per row.
//
// Replaces the TPU kernel surel_plus_tpu/ops/pallas/bitonic_merge.py
// (_merge_kernel) and its XLA twin merge_net.py:merge_pairs_xor, the
// merge at the heart of the keys join (ops/join.py).
//
// Bound on the H100: bytes. Each output element is one comparison search
// away from its inputs, so the work is a few integer ops per element
// against 8 bytes read and 8 written; at [4096, 301] + [4096, 301] the
// function moves 39.5 MB, about 12 us at 3.35 TB/s.
//
// Design: one block per row. The row's keys are staged in shared memory;
// each thread takes elements and finds its output rank by binary search
// in the other row (merge by rank): a[i] lands at i + #{b < a[i]} and
// b[j] at j + #{a <= b[j]}, which puts a before b on ties and so equals a
// stable sort. There is no power-of-two padding and no compare-exchange
// network, so rows of any width merge in one pass. Keys compare unsigned.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void merge_pairs_kernel(const uint32_t* __restrict__ ka,
                                   const uint32_t* __restrict__ pa,
                                   const uint32_t* __restrict__ kb,
                                   const uint32_t* __restrict__ pb,
                                   uint32_t* __restrict__ ko,
                                   uint32_t* __restrict__ po,
                                   int la, int lb) {
  extern __shared__ uint32_t smem[];
  uint32_t* sa = smem;
  uint32_t* sb = smem + la;
  const size_t row = blockIdx.x;
  const uint32_t* ra = ka + row * la;
  const uint32_t* rb = kb + row * lb;
  for (int i = threadIdx.x; i < la; i += blockDim.x) sa[i] = ra[i];
  for (int j = threadIdx.x; j < lb; j += blockDim.x) sb[j] = rb[j];
  __syncthreads();

  const size_t out = row * (la + lb);
  for (int i = threadIdx.x; i < la; i += blockDim.x) {
    const uint32_t k = sa[i];
    int lo = 0, hi = lb;  // lower bound: #{b < k}
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (sb[mid] < k) lo = mid + 1; else hi = mid;
    }
    ko[out + i + lo] = k;
    po[out + i + lo] = pa[row * la + i];
  }
  for (int j = threadIdx.x; j < lb; j += blockDim.x) {
    const uint32_t k = sb[j];
    int lo = 0, hi = la;  // upper bound: #{a <= k}
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (sa[mid] <= k) lo = mid + 1; else hi = mid;
    }
    ko[out + j + lo] = k;
    po[out + j + lo] = pb[row * lb + j];
  }
}

}  // namespace

extern "C" int merge_pairs_launch(const void* ka, const void* pa,
                                  const void* kb, const void* pb, void* ko,
                                  void* po, int rows, int la, int lb,
                                  void* stream) {
  if (rows > 0) {
    const size_t smem = sizeof(uint32_t) * (size_t)(la + lb);
    merge_pairs_kernel<<<rows, kThreads, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)ka, (const uint32_t*)pa, (const uint32_t*)kb,
        (const uint32_t*)pb, (uint32_t*)ko, (uint32_t*)po, la, lb);
  }
  return (int)cudaGetLastError();
}
