// Shared by the attention pool's forward (attn_pool.cu) and backward
// (attn_pool_bwd.cu): the operands, the per-channel weight records in
// shared memory, a slot's unpacked fields, the hidden row z, the gate, the
// walk over a row's tiles and the warp reductions. Both directions compute
// z and the gate with this one code, so the backward recomputes exactly
// the forward's values (same fmaf order).
//
// A row is one warp's work. Its slots go in tiles of 32, one slot a lane.
// Only the tiles that hold a valid slot are walked, and within a tile only
// its valid slots are pooled: when a row has a valid slot, a masked slot's
// gate lies about 1e9 below the row's max, so exp(gate - m) is exactly 0
// in fp32 and the slot adds exactly 0 to every sum (its gradient terms
// are exact zeros too). A row with no valid slot has uniform weights over
// all L slots (the plain version's softmax of equal gates), so every slot
// of such a row is walked.

#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace attn {

constexpr int kTile = 32;           // slots per tile: one per lane of a warp
constexpr float kNeg = -1e9f;       // gate offset of a masked slot
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 232448; // dynamic shared memory of a block

__host__ __device__ constexpr int pad32(int n) { return (n + 31) / 32 * 32; }
__host__ __device__ constexpr int pad4(int n) { return (n + 3) / 4 * 4; }

// floats of a channel's weight record: U's ncol field rows, the NEG row,
// the b1 row and gvec, padded to whole float4s
template <int NCOL>
__host__ __device__ constexpr int rec_k() { return pad4(NCOL + 3); }
// floats of a slot's record: own fields, inv, partner fields and two
// per-slot values (the forward's weight e; the backward's a and dgate),
// padded to whole float4s
template <int NCOL>
__host__ __device__ constexpr int rec_s() { return pad4(2 * NCOL + 3); }

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

// Every channel's weight record into shared memory, urec[h * rec_k + k]:
// k < NCOL U's field rows, NCOL the NEG row, NCOL + 1 b1, NCOL + 2 gvec;
// zero for the padding k and the padding channels H <= h < pad32(H),
// whose hidden rows are then exactly 0. The whole block stores.
template <int NCOL>
__device__ void load_urec(const Planes& p, float* urec) {
  constexpr int K = rec_k<NCOL>();
  const int hp = pad32(p.H);
  for (int i = threadIdx.x; i < hp * K; i += blockDim.x) {
    const int h = i / K, k = i - h * K;
    float v = 0.f;
    if (h < p.H) {
      if (k < NCOL + 2) v = p.u[k * p.H + h];
      else if (k == NCOL + 2) v = p.gv[h];
    }
    urec[i] = v;
  }
}

template <int N>
__device__ __forceinline__ void load4(const float* src, float (&dst)[N]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 v = reinterpret_cast<const float4*>(src)[i];
    dst[4 * i] = v.x;
    dst[4 * i + 1] = v.y;
    dst[4 * i + 2] = v.z;
    dst[4 * i + 3] = v.w;
  }
}

template <int N>
__device__ __forceinline__ void store4(float* dst, const float (&src)[N]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i)
    reinterpret_cast<float4*>(dst)[i] =
        make_float4(src[4 * i], src[4 * i + 1], src[4 * i + 2],
                    src[4 * i + 3]);
}

// One slot's fields, unpacked once by its lane: the own and the partner
// key's ncol count fields and inv = 1 - mask. Slots past the row's end
// (in false) are zero.
template <int NCOL>
struct Slot {
  float fo[NCOL], fc[NCOL], inv;
};

template <int NCOL, bool ROOT>
__device__ Slot<NCOL> unpack(const Planes& p, size_t idx, bool in) {
  Slot<NCOL> f;
  const uint32_t fmask = (1u << p.shift) - 1u;
  const uint32_t ko = in ? p.kown[idx] : 0u;
  const uint32_t kc = in ? p.kcross[idx] : 0u;
#pragma unroll
  for (int i = 0; i < NCOL; ++i) {
    if (ROOT && i == NCOL - 1) {
      f.fo[i] = in ? (float)p.rown[idx] : 0.f;
      f.fc[i] = in ? (float)p.rcross[idx] : 0.f;
    } else {
      const uint32_t fm = (!ROOT && i == NCOL - 1) ? 1u : fmask;
      f.fo[i] = (float)((ko >> (i * p.shift)) & fm);
      f.fc[i] = (float)((kc >> (i * p.shift)) & fm);
    }
  }
  f.inv = (in && p.mask[idx] == 0) ? 1.f : 0.f;
  return f;
}

// z_own = [fo | inv | 1] . [U | NEG | b1] and z_cross = [fc | 0 | 1] . U
// for the channel whose record is w (the partner side's inv is 0: its NEG
// term adds exactly 0 and is left out)
template <int NCOL, int K>
__device__ __forceinline__ void z_pair(const float* fo, const float* fc,
                                       float inv, const float (&w)[K],
                                       float& zo, float& zc) {
  zo = w[NCOL + 1];
  zc = w[NCOL + 1];
#pragma unroll
  for (int i = 0; i < NCOL; ++i) {
    zo = fmaf(fo[i], w[i], zo);
    zc = fmaf(fc[i], w[i], zc);
  }
  zo = fmaf(inv, w[NCOL], zo);
}

__device__ __forceinline__ float hidden(float zo, float zc) {
  return fmaxf(zo, 0.f) + fmaxf(zc, 0.f);
}

// A slot's dot products over the channels are summed in blocks of 8
// channels, each block as a tree, into kChains chains (block b to chain
// b % kChains), the chains again as a tree: over H = 96 channels a term
// meets at most 9 roundings, about as many as a warp butterfly gives.
constexpr int kBlock = 8;
constexpr int kChains = 4;

template <int N>
__device__ __forceinline__ float tree_sum(const float (&v)[N]) {
  static_assert(N == 4 || N == 8, "tree of 4 or 8");
  const float lo = (v[0] + v[1]) + (v[2] + v[3]);
  if constexpr (N == 4) return lo;
  else return lo + ((v[4] + v[5]) + (v[6] + v[7]));
}

// The slot's gate logit hs . gvec + NEG * inv + gconst, summed over the
// channels by the slot's own lane (the records are broadcasts). With DA
// also da = hs . g for the cotangent row g (shared memory, zero past H),
// in the same loop; the gate's bits do not depend on DA.
template <int NCOL, bool DA>
__device__ float slot_gate(const Slot<NCOL>& f, const float* urec, int H,
                           float gconst, const float* g, float* da) {
  constexpr int K = rec_k<NCOL>();
  float dot[kChains], dda[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) dot[c] = dda[c] = 0.f;
  const int hp = pad32(H);  // the padding channels add exact zeros
  for (int h0 = 0; h0 < hp; h0 += kBlock * kChains) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      float pd[kBlock], pa[kBlock];
#pragma unroll
      for (int i = 0; i < kBlock; ++i) {
        const int h = h0 + c * kBlock + i;
        float w[K];
        load4(urec + h * K, w);
        float zo, zc;
        z_pair<NCOL>(f.fo, f.fc, f.inv, w, zo, zc);
        const float hs = hidden(zo, zc);
        pd[i] = hs * w[NCOL + 2];
        pa[i] = DA ? hs * g[h] : 0.f;
      }
      dot[c] += tree_sum(pd);
      if (DA) dda[c] += tree_sum(pa);
    }
  }
  if (DA) *da = tree_sum(dda);
  return fmaf(f.inv, kNeg, tree_sum(dot)) + gconst;
}

// The slot record rec[s * rec_s + ...] = [fo | inv | fc | x0 | x1] that
// the lanes over channels read as broadcasts.
template <int NCOL>
__device__ __forceinline__ void put_slot(float* rec, const Slot<NCOL>& f,
                                         float x0, float x1) {
  constexpr int S = rec_s<NCOL>();
  float r[S];
#pragma unroll
  for (int i = 0; i < S; ++i) r[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NCOL; ++i) {
    r[i] = f.fo[i];
    r[NCOL + 1 + i] = f.fc[i];
  }
  r[NCOL] = f.inv;
  r[2 * NCOL + 1] = x0;
  r[2 * NCOL + 2] = x1;
  store4(rec + (threadIdx.x & 31) * S, r);
}

// Sum and max over the warp by a butterfly: a + b == b + a in IEEE, so
// every lane ends with the same bits, and the order is fixed.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int k = 16; k > 0; k >>= 1) v += __shfl_xor_sync(kFull, v, k);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int k = 16; k > 0; k >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, k));
  return v;
}

// Whether the row at off has a valid slot (warp-uniform).
__device__ __forceinline__ bool row_has_valid(const Planes& p, size_t off) {
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < p.L; base += kTile) {
    const int s = base + lane;
    if (__ballot_sync(kFull, s < p.L && p.mask[off + s] != 0)) return true;
  }
  return false;
}

// The tile's slots to walk, one bit a lane: its valid slots, or every
// slot of the tile if the row has none (any false).
__device__ __forceinline__ unsigned walk_bits(const Planes& p, size_t off,
                                              int base, bool any) {
  const int s = base + (threadIdx.x & 31);
  const bool in = s < p.L;
  return __ballot_sync(kFull, in && (!any || p.mask[off + s] != 0));
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
