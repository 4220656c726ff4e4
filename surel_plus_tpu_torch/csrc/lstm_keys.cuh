// The keys-LSTM's step code, used by its forward (lstm_keys.cu) and kept
// apart for its backward, which has to recompute the forward from the keys:
// the operands, the block layout, the field extraction, the hidden rows, the
// gate sums and the cell update. Both directions computing a step with this
// one code get the same values bit for bit (same fmaf order).

#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace lstm {

constexpr int kRows = 8;          // rows per thread (a row group's rows)
constexpr int kMaxGroups = 4;     // row groups per block
constexpr int kMaxThreads = 512;  // hp * groups
constexpr int kMaxH = 256;        // LSTM width H and input width h
constexpr int kChunk = 32;        // slots staged per chunk
// dynamic shared memory a block may have: 227 KB less the static arrays
constexpr int kMaxSmem = 232448 - 1024;

struct Operands {
  const uint32_t* kown;    // [R, L] own lo keys
  const uint32_t* kcross;  // [R, L] slot-aligned partner lo keys
  const uint8_t* mask;     // [R, L] bool
  const int32_t* rown;     // [R, L] root planes, or null
  const int32_t* rcross;   // [R, L] or null
  const int32_t* order;    // [R] row processed i-th, or null (identity)
  const float* u;          // [ncol + 2, h]: U rows | NEG row | b1 row
  const float* wi;         // [h, 4H] input weights (projection folded in)
  const float* wh;         // [H, 4H]
  const float* bh;         // [4H]
  int rows, L, h, H, shift;
};

// One thread per hidden unit j < hp (H rounded up to whole warps) and row
// group g; a block holds rb = groups * kRows rows. x and h of the block's
// rows live in shared memory transposed, [channel][row] with row stride ld,
// so a thread reads its kRows rows of one channel as float4s, and all the
// lanes of a warp read the same address (a broadcast).
struct Layout {
  int hp, groups, rb, ld;
};

__host__ __device__ inline Layout layout_for(int H) {
  Layout l;
  l.hp = ((H + 31) / 32) * 32;
  l.groups = kMaxThreads / l.hp < kMaxGroups ? kMaxThreads / l.hp
                                             : kMaxGroups;
  l.rb = l.groups * kRows;
  l.ld = l.rb + 4;  // a multiple of 4 (float4), off the bank period
  return l;
}

// Offsets, in 4-byte words, of the dynamic shared memory: x and h double
// buffered ([2][h][ld], [2][H][ld]), then a chunk of staged key, mask and
// root planes ([kChunk][rb + 1] each), U, and wh [H][4H] where it fits
// (`wh_smem`: at H = 96 it takes 147,456 of the 226,176 bytes).
struct Smem {
  int xs, hs, ko, kc, mk, ro, rc, u, wh, words;
};

__host__ __device__ inline Smem smem_for(const Layout& l, int h, int H,
                                         int ncol, bool wh_smem) {
  Smem s;
  const int plane = kChunk * (l.rb + 1);
  s.xs = 0;
  s.hs = s.xs + 2 * h * l.ld;
  s.ko = s.hs + 2 * H * l.ld;
  s.kc = s.ko + plane;
  s.mk = s.kc + plane;
  s.ro = s.mk + plane;
  s.rc = s.ro + plane;
  s.u = s.rc + plane;
  s.wh = s.u + (ncol + 2) * h;
  s.words = s.wh + (wh_smem ? 4 * H * H : 0);
  return s;
}

// The key's ncol count fields, in `_fields_ext`'s order: the shift-wide
// fields from bit 0 up, the last one the root bit (lo-only layout) or the
// root plane's value (lead-in-hi layout).
template <int NCOL, bool ROOT>
__device__ __forceinline__ void fields(uint32_t key, int32_t root, int shift,
                                       float (&f)[NCOL]) {
  const uint32_t fmask = (1u << shift) - 1u;
#pragma unroll
  for (int i = 0; i < NCOL; ++i) {
    if (ROOT && i == NCOL - 1) {
      f[i] = (float)root;
    } else {
      const uint32_t fm = (!ROOT && i == NCOL - 1) ? 1u : fmask;
      f[i] = (float)((key >> (i * shift)) & fm);
    }
  }
}

// Pre-relu hidden value of one side for channel k: b1 + f . U[:, k]. The
// invalid field is 0 on both sides of the keys-LSTM (a masked slot only
// leaves the carry as it is), so the NEG row adds nothing and is skipped.
template <int NCOL>
__device__ __forceinline__ float side_z(const float (&f)[NCOL],
                                        const float* u, int h, int k) {
  float acc = u[(NCOL + 1) * h + k];
#pragma unroll
  for (int i = 0; i < NCOL; ++i) acc = fmaf(f[i], u[i * h + k], acc);
  return acc;
}

// x[k] = relu(z_own) + relu(z_cross)
template <int NCOL>
__device__ __forceinline__ float hidden(const float (&fo)[NCOL],
                                        const float (&fc)[NCOL],
                                        const float* u, int h, int k) {
  return fmaxf(side_z(fo, u, h, k), 0.f) + fmaxf(side_z(fc, u, h, k), 0.f);
}

// acc[q][i] += sum_k v[k][r0 + i] * w[k][q H + j], k = 0..n-1 in order:
// gate q (i, f, g, o) of unit j for the thread's kRows rows. v is x or h in
// shared memory ([n][ld]); w is in shared memory (W_SMEM) or read through
// the read-only cache.
template <bool W_SMEM>
__device__ __forceinline__ void gate_sum(float (&acc)[4][kRows],
                                         const float* __restrict__ w,
                                         const float* v, int n, int H,
                                         int ld, int j, bool on, int r0) {
  const size_t h4 = 4 * (size_t)H;
#pragma unroll 4
  for (int k = 0; k < n; ++k) {
    const float* wk = w + k * h4 + j;
    float wq[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      wq[q] = on ? (W_SMEM ? wk[q * H] : __ldg(wk + q * H)) : 0.f;
    const float4* vr = reinterpret_cast<const float4*>(v + k * ld + r0);
#pragma unroll
    for (int i4 = 0; i4 < kRows / 4; ++i4) {
      const float4 x4 = vr[i4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[q][4 * i4 + 0] = fmaf(x4.x, wq[q], acc[q][4 * i4 + 0]);
        acc[q][4 * i4 + 1] = fmaf(x4.y, wq[q], acc[q][4 * i4 + 1]);
        acc[q][4 * i4 + 2] = fmaf(x4.z, wq[q], acc[q][4 * i4 + 2]);
        acc[q][4 * i4 + 3] = fmaf(x4.w, wq[q], acc[q][4 * i4 + 3]);
      }
    }
  }
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// c' = sigmoid(f) c + sigmoid(i) tanh(g), h' = sigmoid(o) tanh(c')
__device__ __forceinline__ void cell(float gi, float gf, float gg, float go,
                                     float& c, float& h) {
  c = fmaf(sigmoid(gf), c, sigmoid(gi) * tanhf(gg));
  h = sigmoid(go) * tanhf(c);
}

// Dynamic shared memory above the default 48 KB needs an opt-in per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace lstm
