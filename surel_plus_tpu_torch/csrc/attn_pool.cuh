// Shared by the attention pool's forward (attn_pool.cu) and backward
// (attn_pool_bwd.cu): the operands, the per-channel weights, the staging of
// a tile of slots, the hidden row z and the warp's transposed reduction.
// Both directions compute z and the gate with this one code, so the
// backward recomputes exactly the forward's values (same fmaf order).

#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace attn {

constexpr int kTile = 32;       // slots per tile: one per lane of a warp
constexpr int kMaxWarps = 32;   // H <= 1024 channels, one thread each
constexpr float kNeg = -1e9f;   // gate offset of a masked slot

struct Planes {
  const uint32_t* kown;    // [Q, B, L] own keys
  const uint32_t* kcross;  // [Q, B, L] slot-aligned partner keys
  const uint8_t* mask;     // [Q, B, L] bool
  const int32_t* rown;     // [Q, B, L] root planes, or null
  const int32_t* rcross;   // [Q, B, L] or null
  const float* u;          // [ncol + 2, H]: U rows | NEG row | b1 row
  const float* gv;         // [H + 1]: gate vector | gconst
  int rows, L, H, shift;   // rows = Q * B
};

// One hidden channel's weights (zero for the padding threads h >= H, whose
// hidden rows are then exactly 0 and add nothing to the reductions).
template <int NCOL>
struct Channel {
  float uc[NCOL];
  float uneg, bias, gvec;

  __device__ void load(const Planes& p, int h) {
    const bool on = h < p.H;
#pragma unroll
    for (int i = 0; i < NCOL; ++i) uc[i] = on ? p.u[i * p.H + h] : 0.f;
    uneg = on ? p.u[NCOL * p.H + h] : 0.f;
    bias = on ? p.u[(NCOL + 1) * p.H + h] : 0.f;
    gvec = on ? p.gv[h] : 0.f;
  }

  // z = [fields | inv | 1] . [U | NEG | b1] for this channel
  __device__ __forceinline__ float z(const float* f, float inv) const {
    float acc = bias;
#pragma unroll
    for (int i = 0; i < NCOL; ++i) acc = fmaf(f[i], uc[i], acc);
    return fmaf(inv, uneg, acc);
  }
};

// The fields of a tile's slots in shared memory: fo / fc the own and the
// partner key's, inv = 1 - mask. Thread s < kTile stages slot s; slots past
// the row's end (s >= n) are zero.
template <int NCOL>
struct Tile {
  float fo[kTile][NCOL];
  float fc[kTile][NCOL];
  float inv[kTile];
};

template <int NCOL, bool ROOT>
__device__ void stage(const Planes& p, size_t off, int n, Tile<NCOL>& t) {
  const int s = threadIdx.x;
  if (s >= kTile) return;
  const uint32_t fmask = (1u << p.shift) - 1u;
  const bool in = s < n;
  const uint32_t ko = in ? p.kown[off + s] : 0u;
  const uint32_t kc = in ? p.kcross[off + s] : 0u;
#pragma unroll
  for (int i = 0; i < NCOL; ++i) {
    float vo, vc;
    if (ROOT && i == NCOL - 1) {
      vo = in ? (float)p.rown[off + s] : 0.f;
      vc = in ? (float)p.rcross[off + s] : 0.f;
    } else {
      const uint32_t fm = (!ROOT && i == NCOL - 1) ? 1u : fmask;
      vo = (float)((ko >> (i * p.shift)) & fm);
      vc = (float)((kc >> (i * p.shift)) & fm);
    }
    t.fo[s][i] = vo;
    t.fc[s][i] = vc;
  }
  t.inv[s] = (in && p.mask[off + s] == 0) ? 1.f : 0.f;
}

// Slot s's hidden row for channel c: relu(z_own) + relu(z_cross)
template <int NCOL>
__device__ __forceinline__ float hidden(const Tile<NCOL>& t, int s,
                                        const Channel<NCOL>& c) {
  return fmaxf(c.z(t.fo[s], t.inv[s]), 0.f) + fmaxf(c.z(t.fc[s], 0.f), 0.f);
}

// v[s] holds this lane's term for slot s. Returns, in lane l, the sum over
// the warp's lanes of the terms for slot l: 31 shuffles for 32 sums. At each
// step a lane keeps the half of its slots selected by its lane bit k and
// sends the other half to its partner lane ^ k. The order of the additions
// is fixed, so the result is too.
__device__ __forceinline__ float warp_transpose_sum(float (&v)[kTile]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const int k = 16 >> j;
    const bool up = (lane & k) != 0;
#pragma unroll
    for (int i = 0; i < k; ++i) {
      const float send = up ? v[i] : v[i + k];
      const float keep = up ? v[i + k] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, k);
    }
  }
  return v[0];
}

// The gate of slot s from the warps' partial dot products red[w][s]:
// hs . gvec + NEG * inv + gconst, summed over the warps in order.
__device__ __forceinline__ float gate_of(const float (*red)[kTile], int s,
                                         int nwarps, float inv,
                                         float gconst) {
  float dot = 0.f;
  for (int w = 0; w < nwarps; ++w) dot += red[w][s];
  return fmaf(inv, kNeg, dot) + gconst;
}

// Dynamic shared memory above the default 48 KB needs an opt-in per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace attn
