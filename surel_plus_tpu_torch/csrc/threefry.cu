// Threefry-2x32 with 20 rounds (Salmon et al., "Parallel random numbers:
// as easy as 1, 2, 3", the Random123 generator) over a run of 64-bit
// counters: out[i] = w0 ^ w1 of threefry2x32(key; (c >> 32, c & 0xffffffff))
// for c = offset + i, as int64 values in [0, 2^32).
//
// This is jax.random.bits(key, shape, uint32) under the partitionable
// layout (jax_threefry_partitionable, on in JAX 0.9): the draw of flat
// index i hashes the counter i, so a row block of a larger draw is the
// same run at an offset. It replaces no Pallas kernel: the JAX package
// draws its walk bits, its riffle shuffle's sort keys and its dropout
// masks with jax.random, which XLA computes (surel_plus_tpu/ops/walk.py:
// 183, train/device.py:51-53, flax's Dropout); the port draws the same
// words here, so that a seed gives the JAX package's sets, batch order
// and dropout masks. ops/prng.py holds the key API around it
// (prng_key, fold_in, split on the host), ops/kernels/threefry.py the
// wrapper and the plain version.
//
// Bound on the H100: bytes, nearly tied with the instruction issue. A
// counter costs 20 rounds of an add, a rotate and a xor, 12 key additions,
// the counter's split and the final xor (75 32-bit operations) against 8
// bytes written: at the sampler's block of 65,536 seeds x 100 walks
// (6,553,600 words a step) 15.6 us for the 52 MB at 3.35 TB/s, 14.7 us for
// the 4.9e8 operations at the 33.5e12 instructions a second that the SMs
// issue (four warp instructions a clock an SM).
//
// Design: the simplest one (1.8x its bound on the card, PERF.md §6). A
// thread takes counters i, i + T, i + 2T, ... (T threads in all, at most
// 16 blocks of 256 an SM), keeps the key schedule in registers, and writes
// each word as one coalesced 8-byte store. The rotates are funnel shifts. The
// 64-bit counter is split into its words on the device, so an offset may
// cross 2^32.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

__device__ __forceinline__ void round4(uint32_t& x0, uint32_t& x1, int r0,
                                       int r1, int r2, int r3) {
  x0 += x1; x1 = __funnelshift_l(x1, x1, r0); x1 ^= x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, r1); x1 ^= x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, r2); x1 ^= x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, r3); x1 ^= x0;
}

__global__ void __launch_bounds__(kThreads)
threefry_bits_kernel(uint32_t k0, uint32_t k1, uint64_t offset, int64_t n,
                     int64_t* __restrict__ out) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint64_t c = offset + (uint64_t)i;
    uint32_t x0 = (uint32_t)(c >> 32) + k0;
    uint32_t x1 = (uint32_t)c + k1;
    round4(x0, x1, 13, 15, 26, 6);
    x0 += k1; x1 += k2 + 1u;
    round4(x0, x1, 17, 29, 16, 24);
    x0 += k2; x1 += k0 + 2u;
    round4(x0, x1, 13, 15, 26, 6);
    x0 += k0; x1 += k1 + 3u;
    round4(x0, x1, 17, 29, 16, 24);
    x0 += k1; x1 += k2 + 4u;
    round4(x0, x1, 13, 15, 26, 6);
    x0 += k2; x1 += k0 + 5u;
    out[i] = (int64_t)(x0 ^ x1);
  }
}

}  // namespace

extern "C" int threefry_bits_launch(unsigned int k0, unsigned int k1,
                                    unsigned long long offset, long long n,
                                    void* out, void* stream) {
  if (n > 0) {
    const long long want = (n + kThreads - 1) / kThreads;
    const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
    threefry_bits_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        k0, k1, (uint64_t)offset, (int64_t)n, (int64_t*)out);
  }
  return (int)cudaGetLastError();
}
