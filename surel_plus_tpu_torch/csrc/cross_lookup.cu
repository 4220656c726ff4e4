// Cross lookup of both key words in both directions of a join (K6): for
// rows u, v [B, L] of node ids (int32, INT32_MAX padding) and the payload
// words hi_u, lo_u, hi_v, lo_v [B, L] of their slots (uint32 bit patterns),
// for every row r and slot i
//
//   cross_hi_u[r, i] = sum over j with v[r, j] == u[r, i] of hi_v[r, j]
//   cross_lo_u[r, i] = the same over lo_v                     (mod 2^32)
//   cross_hi_v[r, i], cross_lo_v[r, i]: the same with u and v swapped
//
// and 0 where the slot's node is INT32_MAX. On sets (distinct nodes in a
// row, as the sampler makes them) that sum is the payload of the node's
// slot in the other row, or 0 when that row lacks the node: the keys
// join's cross lookup.
//
// Precondition: every row ascending as int32, so INT32_MAX padding comes
// last, as SpGKeys rows are (the sampler sorts each set by node). Repeated
// nodes are allowed and summed over their run.
//
// Replaces the TPU kernel surel_plus_tpu/ops/pallas/join_kernel.py
// _join_kernel (pallas_cross_lookup_pair, called once a direction). That
// kernel builds the [L, L] equality mask in VMEM and contracts it on the
// MXU against the payload words split into 16-bit halves, which needs no
// order. Here the comparisons run on the integer units and the sums are
// integer ones: no mask is formed and no halves are needed.
//
// Bound on the H100: bytes. A join writes four output planes (16 L bytes a
// row), and it needs each node row only up to its end and, of the four
// payload planes, only the slots it finds: on the sampler's sets at
// B = 4096, L = 301, 0.39 of the slots are valid and about two a row pair
// are found each way (chip_smoke.py:k6_bound counts those 32-byte sectors
// from the run's data; PERF.md gives the figure). One binary search of the
// other row a valid slot is far below it. The first version took one
// direction a launch and scanned all of the other row for every slot (L^2
// compares a row, issue-bound on integer and shared-memory instructions:
// 8.6x its one-direction bound of whole planes at L = 301, and growing
// with L).
//
// Design: one launch a join, one block a row pair: 128 threads while
// L < 512, 256 from there (on the sampler's sets, with 0.39, 0.41 and
// 0.33 of the slots valid at L = 301, 801 and 4001, about 1.8, 2.6 and 10
// valid slots a thread; on an H100, of 64, 128 and 256 threads a row
// pair, 128 was the fastest at L = 301 and 256 at L = 801 and 4001, and a
// warp a row pair, all of a 4096-row join in one wave, was slower at
// L = 301 than a block of 256). The block stages the pair's two node rows
// in shared memory with asynchronous copies (8 L bytes, 16-byte pieces
// between a ragged head and tail), and every thread finds each row's
// valid length nu, nv by one search for INT32_MAX. The pair's nu + nv valid slots (u's first) are
// dealt to the T threads in turn: thread t takes items t, t + T, ...; for
// a slot of one row it runs a lower-bound search of the other row's valid
// prefix (ceil(log2(n + 1)) steps: 9 at L = 301, 12 at L = 4001) and walks
// the run of equal nodes from there, summing both payload words, which are
// read from device memory only at a hit. Consecutive items are consecutive
// slots, so each warp's output stores are coalesced; padding slots are
// zeroed by a strided pass and cost no search. No atomics: two launches
// give the same bits.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "smem.cuh"

namespace {

using smem::copies_commit;
using smem::copies_wait;
using smem::region;
using smem::stage;

// threads a row pair: kNarrow while L < kWideFrom, else kWide
constexpr int kNarrow = 128, kWide = 256, kWideFrom = 512;

// The least j in [0, n) with row[j] >= x, else n: ceil(log2(n + 1))
// halving steps.
__device__ __forceinline__ int lower_bound(const int32_t* row, int n,
                                           int32_t x) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    if (row[lo + half] < x) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kWide)
cross_lookup_pair_kernel(const int32_t* __restrict__ nodes_u,
                         const int32_t* __restrict__ nodes_v,
                         const uint32_t* __restrict__ hi_u,
                         const uint32_t* __restrict__ lo_u,
                         const uint32_t* __restrict__ hi_v,
                         const uint32_t* __restrict__ lo_v,
                         uint32_t* __restrict__ cross_hi_u,
                         uint32_t* __restrict__ cross_lo_u,
                         uint32_t* __restrict__ cross_hi_v,
                         uint32_t* __restrict__ cross_lo_v, int L) {
  extern __shared__ __align__(16) uint32_t sm[];
  const int t = threadIdx.x, T = blockDim.x;
  const size_t base = (size_t)blockIdx.x * L;
  const int32_t* su = reinterpret_cast<const int32_t*>(stage(
      sm, reinterpret_cast<const uint32_t*>(nodes_u + base), L, t, T));
  const int32_t* sv = reinterpret_cast<const int32_t*>(
      stage(sm + region(L), reinterpret_cast<const uint32_t*>(nodes_v + base),
            L, t, T));
  copies_commit();
  copies_wait<0>();
  __syncthreads();  // both rows have landed

  const int nu = lower_bound(su, L, INT_MAX);
  const int nv = lower_bound(sv, L, INT_MAX);
  for (int k = t; k < nu + nv; k += T) {
    const bool in_u = k < nu;
    const int i = in_u ? k : k - nu;
    const int32_t node = in_u ? su[i] : sv[i];
    const int32_t* other = in_u ? sv : su;
    const int n = in_u ? nv : nu;
    const uint32_t* phi = (in_u ? hi_v : hi_u) + base;
    const uint32_t* plo = (in_u ? lo_v : lo_u) + base;
    uint32_t hi = 0u, lo = 0u;
    for (int j = lower_bound(other, n, node); j < n && other[j] == node;
         ++j) {
      hi += __ldg(phi + j);
      lo += __ldg(plo + j);
    }
    (in_u ? cross_hi_u : cross_hi_v)[base + i] = hi;
    (in_u ? cross_lo_u : cross_lo_v)[base + i] = lo;
  }
  for (int i = nu + t; i < L; i += T) {
    cross_hi_u[base + i] = 0u;
    cross_lo_u[base + i] = 0u;
  }
  for (int i = nv + t; i < L; i += T) {
    cross_hi_v[base + i] = 0u;
    cross_lo_v[base + i] = 0u;
  }
}

}  // namespace

// nodes_u, nodes_v, hi_u, lo_u, hi_v, lo_v (inputs) and cross_hi_u,
// cross_lo_u, cross_hi_v, cross_lo_v (outputs): [rows, L] 4-byte words.
extern "C" int cross_lookup_pair_launch(
    const void* nodes_u, const void* nodes_v, const void* hi_u,
    const void* lo_u, const void* hi_v, const void* lo_v, void* cross_hi_u,
    void* cross_lo_u, void* cross_hi_v, void* cross_lo_v, int rows, int L,
    void* stream) {
  if (rows < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const size_t bytes = sizeof(uint32_t) * 2 * (size_t)region(L);
  const cudaError_t err = smem::allow_smem(cross_lookup_pair_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  cross_lookup_pair_kernel<<<rows, L < kWideFrom ? kNarrow : kWide, bytes,
                             (cudaStream_t)stream>>>(
      (const int32_t*)nodes_u, (const int32_t*)nodes_v,
      (const uint32_t*)hi_u, (const uint32_t*)lo_u, (const uint32_t*)hi_v,
      (const uint32_t*)lo_v, (uint32_t*)cross_hi_u, (uint32_t*)cross_lo_u,
      (uint32_t*)cross_hi_v, (uint32_t*)cross_lo_v, L);
  return (int)cudaGetLastError();
}
