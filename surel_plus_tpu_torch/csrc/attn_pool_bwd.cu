// Fused attention pool, backward: the gradient of the forward
// (csrc/attn_pool.cu) with respect to u_ext [ncol + 2, H] and
// gv = [gvec | gconst] [H + 1], given the cotangent g [Q, B, H] and the
// forward's residuals m, s [Q, B]. Per row, with hs, gate recomputed from
// the keys exactly as the forward computes them:
//
//   a     = exp(gate - m) / s                 the forward's softmax weights
//   da    = hs . g,    t = sum_l a * da
//   dgate = a * (da - t)                      the softmax's VJP
//   dhs   = a * g + dgate * gvec
//   dU   += fext_own^T (z_own > 0) dhs + fext_cross^T (z_cross > 0) dhs
//   dgvec += hs * dgate,   dgconst += dgate
//
// Replaces the TPU kernels surel_plus_tpu/ops/pallas/hidden_sum_kernel.py
// _attn_bwd_kernel (monolithic) and _attn_ct_kernel + _attn_cbwd_kernel
// (the slot-chunked t-pass and gradient pass). The TPU kernels carry dU and
// dgv across their sequential grid; on the GPU blocks run in no order, so
// each block keeps partial sums and a second pass adds the partials in a
// fixed order (no float atomics: two launches give the same bits).
//
// Bound on the H100: operations. At the bench width (Q=2, B=4096, L=301,
// H=96, ncol=4) it reads the forward's 22 MB of keys and masks and 3 MB of
// g, but needs, per valid slot and channel, the hidden row again, the
// gate's and da's multiply-adds, dhs and dgvec's multiply-add, and where
// a side's z > 0 its 2 ncol + 1 operations into dU: some 3.6 GFLOP in
// fp32, 53 us on the CUDA cores (chip_smoke.py counts it from its inputs).
//
// Design: as the forward, a warp per row and no block barrier between the
// records' store and the partials' sum. Block p's warps take the rows
// w + W p, w + W (p + P), ... (P blocks of W warps, W as shared memory
// allows, at most kWarps). Per row, over the tiles that hold a slot to
// walk (attn_pool.cuh):
//   A. lanes over slots: the gate and da = hs . g in one loop over the
//      channels (g's row in the warp's shared memory), a = exp(gate - m)/s;
//      a and da of each walked slot go to the warp's shared memory, t by a
//      warp butterfly, then dgate = a (da - t) replaces da;
//   B. lanes over channels (kJ chunks of 32 channels at a time): each
//      channel's dU column, dgvec entry sum over the tile's walked slots,
//      the hidden row formed again from the slot's record; the tile's
//      sums go into its group's (kGroup tiles), the group's into the
//      warp's.
// The warps' sums stay in their shared memory across rows; at the end the
// block adds its warps' sums in order into part[(e * P) + p] for the entry
// e of out = [dU (row-major) | dgvec | dgconst], so the reduction pass
// reads each entry's P partials contiguously.

#include <algorithm>

#include "attn_pool.cuh"

namespace {

using namespace attn;

constexpr int kWarps = 2;         // most warps a block
constexpr int kJ = 3;             // channel chunks of 32 a lane holds at once
constexpr int kGroup = 32;        // walked tiles whose sums are added first
constexpr int kReduceThreads = 256;

// A lane's sum over a row's walked tiles (one term a tile), taken in
// groups of kGroup tiles, each group's sum added to the total: a row of
// 10^4 valid slots gives a term at most some 2 kGroup roundings.
struct TileSum {
  float total = 0.f, group = 0.f;
  int n = 0;
  __device__ void next_tile() {
    if (n++ == kGroup) {
      total += group;
      group = 0.f;
      n = 1;
    }
  }
  __device__ float done() {
    total += group;
    group = 0.f;
    n = 0;
    return total;
  }
};

// The warp's shared memory, in floats: slot records, the sums and the
// current group's sums [(ncol + 3) x pad32(H)] each, g's row, a and dgate
// [pad4(L)] each, the walked bits of each tile and dgconst's sum.
template <int NCOL>
struct WarpLayout {
  int hp, lp, tp;
  __host__ __device__ explicit WarpLayout(int H, int L)
      : hp(pad32(H)), lp(pad4(L)), tp(pad4((L + kTile - 1) / kTile)) {}
  __host__ __device__ int rec() const { return 0; }
  __host__ __device__ int acc() const { return kTile * rec_s<NCOL>(); }
  __host__ __device__ int grp() const { return acc() + (NCOL + 3) * hp; }
  __host__ __device__ int g() const { return grp() + (NCOL + 3) * hp; }
  __host__ __device__ int a() const { return g() + hp; }
  __host__ __device__ int d() const { return a() + lp; }
  __host__ __device__ int bits() const { return d() + lp; }
  __host__ __device__ int c() const { return bits() + tp; }
  __host__ __device__ int floats() const { return c() + 4; }
};

template <int NCOL, bool ROOT>
__global__ void __launch_bounds__(kWarps * 32)
attn_pool_bwd_kernel(Planes p, const float* g, const float* m_in,
                     const float* s_in, float* part) {
  constexpr int K = rec_k<NCOL>();
  constexpr int S = rec_s<NCOL>();
  constexpr int NA = NCOL + 3;  // sums per channel: U rows, NEG, b1, gvec
  extern __shared__ float4 smem4[];
  float* urec = reinterpret_cast<float*>(smem4);
  const WarpLayout<NCOL> lay(p.H, p.L);
  const int hp = lay.hp;
  const int nw = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* base_w = urec + hp * K;
  float* ws = base_w + warp * lay.floats();
  float* rec = ws + lay.rec();
  float* acc = ws + lay.acc();  // acc[k * hp + h]: lane h % 32's entries
  float* grp = ws + lay.grp();  // the same entries, this group's tiles
  float* gsh = ws + lay.g();
  float* a_sh = ws + lay.a();
  float* d_sh = ws + lay.d();
  unsigned* wb = reinterpret_cast<unsigned*>(ws + lay.bits());
  load_urec<NCOL>(p, urec);
  for (int i = lane; i < NA * hp; i += 32) acc[i] = grp[i] = 0.f;
  // the group's sums into the warp's: a tile's sums meet at most kGroup
  // additions before they join the total (rows of 10^4 valid slots stay
  // within fp32's reach)
  auto flush = [&]() {
    for (int i = lane; i < NA * hp; i += 32) {
      acc[i] += grp[i];
      grp[i] = 0.f;
    }
  };
  __syncthreads();

  const float gconst = p.gv[p.H];
  const int nch = hp / 32;
  const int nt = (p.L + kTile - 1) / kTile;
  const int P = gridDim.x;
  TileSum acc_c;  // this lane's part of dgconst
  for (int row = warp + nw * blockIdx.x; row < p.rows; row += nw * P) {
    const size_t off = (size_t)row * p.L;
    for (int h = lane; h < hp; h += 32)
      gsh[h] = h < p.H ? g[(size_t)row * p.H + h] : 0.f;
    __syncwarp();
    const float m = m_in[row];
    const float s_row = s_in[row];
    const bool any = row_has_valid(p, off);

    // A: a and da of every walked slot, and t
    TileSum tp;
    for (int t = 0; t < nt; ++t) {
      const int base = t * kTile;
      const unsigned walk = walk_bits(p, off, base, any);
      if (lane == 0) wb[t] = walk;
      if (walk == 0) continue;
      tp.next_tile();
      const int s = base + lane;
      const Slot<NCOL> f = unpack<NCOL, ROOT>(p, off + s, s < p.L);
      float da;
      const float gate = slot_gate<NCOL, true>(f, urec, p.H, gconst, gsh,
                                               &da);
      if ((walk >> lane) & 1u) {
        const float a = expf(gate - m) / s_row;
        a_sh[s] = a;
        d_sh[s] = da;
        tp.group = fmaf(a, da, tp.group);
      }
    }
    const float tsum = warp_sum(tp.done());
    __syncwarp();  // wb is stored
    for (int t = 0; t < nt; ++t) {
      const unsigned walk = wb[t];
      if (walk == 0) continue;
      acc_c.next_tile();
      const int s = t * kTile + lane;
      if ((walk >> lane) & 1u) {
        const float dg = a_sh[s] * (d_sh[s] - tsum);
        d_sh[s] = dg;
        acc_c.group += dg;
      }
    }
    acc_c.done();

    // B: the gradients, lanes over channels
    int walked = 0;
    for (int t = 0; t < nt; ++t) {
      const unsigned walk = wb[t];
      if (walk == 0) continue;
      if (walked++ == kGroup) {
        flush();
        walked = 1;
      }
      const int s = t * kTile + lane;
      const bool on = (walk >> lane) & 1u;
      const Slot<NCOL> f = unpack<NCOL, ROOT>(p, off + s, s < p.L);
      put_slot<NCOL>(rec, f, on ? a_sh[s] : 0.f, on ? d_sh[s] : 0.f);
      __syncwarp();
      for (int c0 = 0; c0 < nch; c0 += kJ) {
        float w[kJ][K];
        float gj[kJ];
        float su[kJ][NA];
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const int h = (c0 + j) * 32 + lane;
          if (c0 + j < nch) {
            load4(urec + h * K, w[j]);
            gj[j] = gsh[h];
#pragma unroll
            for (int k = 0; k < NA; ++k) su[j][k] = 0.f;
          }
        }
        for (unsigned bits = walk; bits; bits &= bits - 1) {
          float r[S];
          load4(rec + (__ffs(bits) - 1) * S, r);
          const float* fo = r;
          const float* fc = r + NCOL + 1;
          const float inv = r[NCOL];
          const float a = r[2 * NCOL + 1];
          const float dg = r[2 * NCOL + 2];
#pragma unroll
          for (int j = 0; j < kJ; ++j) {
            if (c0 + j < nch) {
              float zo, zc;
              z_pair<NCOL>(fo, fc, inv, w[j], zo, zc);
              const float hs = hidden(zo, zc);
              const float dhs = fmaf(dg, w[j][NCOL + 2], a * gj[j]);
              const float dzo = zo > 0.f ? dhs : 0.f;
              const float dzc = zc > 0.f ? dhs : 0.f;
#pragma unroll
              for (int i = 0; i < NCOL; ++i) {
                su[j][i] = fmaf(fo[i], dzo, su[j][i]);
                su[j][i] = fmaf(fc[i], dzc, su[j][i]);
              }
              su[j][NCOL] = fmaf(inv, dzo, su[j][NCOL]);
              su[j][NCOL + 1] += dzo;
              su[j][NCOL + 1] += dzc;
              su[j][NCOL + 2] = fmaf(hs, dg, su[j][NCOL + 2]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const int h = (c0 + j) * 32 + lane;
          if (c0 + j < nch) {
#pragma unroll
            for (int k = 0; k < NA; ++k) grp[k * hp + h] += su[j][k];
          }
        }
      }
      __syncwarp();  // the records are read before the next tile's
    }
    flush();
  }
  const float dgconst = warp_sum(acc_c.total);
  if (lane == 0) ws[lay.c()] = dgconst;
  __syncthreads();

  // the block's partials: its warps' sums, added in warp order
  const int E = NA * p.H + 1;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const int idx = e < NA * p.H ? (e / p.H) * hp + e % p.H : -1;
    float v = 0.f;
    for (int w = 0; w < nw; ++w) {
      const float* wsw = base_w + w * lay.floats();
      v += idx >= 0 ? wsw[lay.acc() + idx] : wsw[lay.c()];
    }
    part[(size_t)e * P + blockIdx.x] = v;
  }
}

// One block per entry of out: the entry's P partials, summed in a fixed
// order (a strided pass per thread, then a tree over the block).
__global__ void attn_pool_bwd_reduce(const float* part, float* out, int P) {
  __shared__ float red[kReduceThreads];
  const float* q = part + (size_t)blockIdx.x * P;
  float s = 0.f;
  for (int i = threadIdx.x; i < P; i += kReduceThreads) s += q[i];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = kReduceThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = red[0];
}

template <int NCOL>
cudaError_t launch(const Planes& p, bool root, const float* g,
                   const float* m, const float* s, float* part, int P,
                   cudaStream_t stream) {
  const WarpLayout<NCOL> lay(p.H, p.L);
  const size_t fixed = (size_t)lay.hp * rec_k<NCOL>() * sizeof(float);
  const size_t per_warp = (size_t)lay.floats() * sizeof(float);
  if (fixed + per_warp > kMaxSmem) return cudaErrorInvalidValue;
  const int warps = (int)std::min<size_t>(kWarps,
                                          (kMaxSmem - fixed) / per_warp);
  const size_t smem = fixed + warps * per_warp;
  void (*kernel)(Planes, const float*, const float*, const float*, float*) =
      root ? &attn_pool_bwd_kernel<NCOL, true>
           : &attn_pool_bwd_kernel<NCOL, false>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<P, warps * 32, smem, stream>>>(p, g, m, s, part);
  return cudaGetLastError();
}

}  // namespace

// part: scratch of ((ncol + 3) * H + 1) * P floats; out: (ncol + 3) * H + 1
// floats, [dU (ncol + 2) x H | dgvec H | dgconst]. P (1 <= P <= Q * B)
// fixes the partition of the rows, and with it the bits of the result.
extern "C" int attn_pool_bwd_launch(const void* kown, const void* kcross,
                                    const void* mask, const void* rown,
                                    const void* rcross, const void* u,
                                    const void* gv, const void* g,
                                    const void* m, const void* s, void* part,
                                    void* out, int Q, int B, int L, int H,
                                    int ncol, int shift, int P,
                                    void* stream) {
  const Planes p{(const uint32_t*)kown, (const uint32_t*)kcross,
                 (const uint8_t*)mask, (const int32_t*)rown,
                 (const int32_t*)rcross, (const float*)u, (const float*)gv,
                 Q * B, L, H, shift};
  const bool root = rown != nullptr;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* gg = (const float*)g;
  const float* mm = (const float*)m;
  const float* ss = (const float*)s;
  float* pp = (float*)part;
  if (Q < 1 || B < 1 || L < 1 || H < 1 || H > 1024 || P < 1 || P > Q * B)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  switch (ncol) {
    case 2: err = launch<2>(p, root, gg, mm, ss, pp, P, st); break;
    case 3: err = launch<3>(p, root, gg, mm, ss, pp, P, st); break;
    case 4: err = launch<4>(p, root, gg, mm, ss, pp, P, st); break;
    case 5: err = launch<5>(p, root, gg, mm, ss, pp, P, st); break;
    case 6: err = launch<6>(p, root, gg, mm, ss, pp, P, st); break;
    case 7: err = launch<7>(p, root, gg, mm, ss, pp, P, st); break;
    case 8: err = launch<8>(p, root, gg, mm, ss, pp, P, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  attn_pool_bwd_reduce<<<(ncol + 3) * H + 1, kReduceThreads, 0, st>>>(
      pp, (float*)out, P);
  return (int)cudaGetLastError();
}
