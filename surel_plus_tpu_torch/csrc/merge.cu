// Merge of two ascending rows of unsigned 32-bit keys, each key carrying
// one 32-bit payload: out = a stable sort of concat(a, b) per row (a
// before b on equal keys).
//
// Replaces the TPU kernel surel_plus_tpu/ops/pallas/bitonic_merge.py
// (_merge_kernel) and its XLA twin merge_net.py:merge_pairs_xor, the
// merge at the heart of the keys join (ops/join.py).
//
// Bound on the H100: bytes. The work is a few integer operations an
// element against 8 bytes read and 8 written; at [4096, 301] + [4096, 301]
// the function moves 39.5 MB, about 12 us at 3.35 TB/s. The first version
// (a block of 256 threads a row, a binary search of the other row for each
// element, then its payload read from device memory) exposed two memory
// latencies a row and left a third of its threads idle: 3.8x the bound.
//
// Design: a merge path. A warp takes a row (four rows a block) while four
// rows fit 48 KB of shared memory (la + lb up to about 760), else a block of 128
// threads takes one (up to MAX_ROW = 12288, with the opt-in above 48 KB).
// The row's keys and payloads, both sides, are copied to shared memory up
// front with asynchronous copies (16 bytes where the device address
// allows: each array lies in shared memory at the offset that matches its
// device address modulo 16 bytes, so rows of any width, 301 words among
// them, copy in 16-byte pieces between a ragged head and tail), so no
// payload read waits behind a search. Thread t of T takes outputs
// [t P, (t + 1) P), P = ceil((la + lb) / T): one co-rank search finds how
// many of a's entries precede output t P (`merge_path_corank` in
// ops/kernels/merge.py mirrors it), then the thread merges its run
// sequentially from shared memory into a shared-memory output tile, taking
// a[i] before b[j] while a[i] <= b[j]: the tie rule of a stable sort. The
// tile (keys and payloads, laid out like the inputs) is stored coalesced,
// 16 bytes a thread where aligned. Keys compare unsigned.

#include <cstdint>
#include <cuda_runtime.h>

#include "smem.cuh"

namespace {

using smem::copies_commit;
using smem::copies_wait;
using smem::misalign;
using smem::region;
using smem::stage;

constexpr int kThreads = 128;  // a block: four warps
constexpr int kWarpRows = 4;   // rows a block when a warp takes a row

// Words of shared memory a row takes: keys and payloads of a and b, and the
// output tile's keys and payloads.
__host__ __device__ constexpr int row_words(int la, int lb) {
  return 2 * region(la) + 2 * region(lb) + 2 * region(la + lb);
}

// Store n words of a tile laid out like dst (modulo 16 bytes) to dst.
__device__ __forceinline__ void unstage(uint32_t* dst, const uint32_t* src,
                                        int n, int t, int T) {
  const int head = min((4 - misalign(dst)) & 3, n);
  const int body = (n - head) / 4;
  for (int i = t; i < head; i += T) dst[i] = src[i];
  for (int i = t; i < body; i += T)
    *reinterpret_cast<uint4*>(dst + head + 4 * i) =
        *reinterpret_cast<const uint4*>(src + head + 4 * i);
  for (int i = head + 4 * body + t; i < n; i += T) dst[i] = src[i];
}

// The number of a's entries among the first d outputs: the least i with
// a[i] > b[d - 1 - i] (a[i] then follows b's first d - i entries).
__device__ __forceinline__ int corank(const uint32_t* a, int la,
                                      const uint32_t* b, int lb, int d) {
  int lo = max(0, d - lb), hi = min(d, la);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= b[d - 1 - mid])
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

template <bool WARP_ROW>
__global__ void __launch_bounds__(kThreads)
merge_pairs_kernel(const uint32_t* __restrict__ ka,
                   const uint32_t* __restrict__ pa,
                   const uint32_t* __restrict__ kb,
                   const uint32_t* __restrict__ pb, uint32_t* __restrict__ ko,
                   uint32_t* __restrict__ po, int rows, int la, int lb) {
  extern __shared__ __align__(16) uint32_t sm[];
  constexpr int T = WARP_ROW ? 32 : kThreads;
  const int t = WARP_ROW ? threadIdx.x % 32 : threadIdx.x;
  const int slot = WARP_ROW ? threadIdx.x / 32 : 0;
  const size_t row = (size_t)blockIdx.x * (WARP_ROW ? kWarpRows : 1) + slot;
  if (row >= (size_t)rows) return;  // a whole warp (WARP_ROW only)
  auto sync = [] {
    if constexpr (WARP_ROW)
      __syncwarp();
    else
      __syncthreads();
  };
  const int n = la + lb;
  const int ra = region(la), rb = region(lb);
  uint32_t* base = sm + (size_t)slot * row_words(la, lb);
  const uint32_t* sa = stage(base, ka + row * la, la, t, T);
  const uint32_t* sb = stage(base + ra, kb + row * lb, lb, t, T);
  const uint32_t* spa = stage(base + ra + rb, pa + row * la, la, t, T);
  const uint32_t* spb = stage(base + 2 * ra + rb, pb + row * lb, lb, t, T);
  uint32_t* gk = ko + row * n;
  uint32_t* gp = po + row * n;
  uint32_t* ok = base + 2 * ra + 2 * rb + misalign(gk);
  uint32_t* op = base + 2 * ra + 2 * rb + region(n) + misalign(gp);
  copies_commit();
  copies_wait<0>();
  sync();  // every thread's copies have landed

  const int P = (n + T - 1) / T;
  int d = min(t * P, n);
  const int end = min(d + P, n);
  int i = corank(sa, la, sb, lb, d), j = d - i;
  uint32_t x = i < la ? sa[i] : 0u, y = j < lb ? sb[j] : 0u;
  for (; d < end; ++d) {
    const bool take_a = j >= lb || (i < la && x <= y);
    if (take_a) {
      ok[d] = x;
      op[d] = spa[i];
      ++i;
      x = i < la ? sa[i] : 0u;
    } else {
      ok[d] = y;
      op[d] = spb[j];
      ++j;
      y = j < lb ? sb[j] : 0u;
    }
  }
  sync();  // the tile is whole
  unstage(gk, ok, n, t, T);
  unstage(gp, op, n, t, T);
}

}  // namespace

extern "C" int merge_pairs_launch(const void* ka, const void* pa,
                                  const void* kb, const void* pb, void* ko,
                                  void* po, int rows, int la, int lb,
                                  void* stream) {
  if (rows > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    const size_t bytes = sizeof(uint32_t) * (size_t)row_words(la, lb);
    const auto k_a = (const uint32_t*)ka, p_a = (const uint32_t*)pa;
    const auto k_b = (const uint32_t*)kb, p_b = (const uint32_t*)pb;
    if (kWarpRows * bytes <= 48 * 1024) {
      merge_pairs_kernel<true>
          <<<(rows + kWarpRows - 1) / kWarpRows, kThreads, kWarpRows * bytes,
             s>>>(k_a, p_a, k_b, p_b, (uint32_t*)ko, (uint32_t*)po, rows, la,
                  lb);
    } else {
      const cudaError_t err = smem::allow_smem(merge_pairs_kernel<false>,
                                               bytes);
      if (err != cudaSuccess) return (int)err;
      merge_pairs_kernel<false><<<rows, kThreads, bytes, s>>>(
          k_a, p_a, k_b, p_b, (uint32_t*)ko, (uint32_t*)po, rows, la, lb);
    }
  }
  return (int)cudaGetLastError();
}
