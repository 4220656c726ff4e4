// Fused attention pool, forward: for every endpoint q and query row b,
//
//   hs[l]   = relu(fext(kown[l], 1 - mask[l]) . U)
//             + relu(fext(kcross[l], 0) . U)
//   gate[l] = hs[l] . gvec + NEG * (1 - mask[l]) + gconst
//   out     = sum_l softmax_l(gate)[l] * hs[l]                    [Q, B, H]
//
// with fext(k, inv) = [f(k) | inv | 1], f(k) the key's ncol count fields
// (csrc/hidden_sum.cu), U = u_ext [ncol + 2, H] (W1's rows, the NEG row, b1)
// and gv = [gvec | gconst] [H + 1]. A masked slot's gate sits 1e9 below the
// others, so its weight is exactly 0. Also writes the softmax's residuals
// per row: m = max_l gate[l] and s = sum_l exp(gate[l] - m).
//
// Replaces the TPU kernels surel_plus_tpu/ops/pallas/hidden_sum_kernel.py
// _attn_fwd_kernel (monolithic) and _attn_cstats_kernel with its XLA
// combine (slot-chunked, for the wide shapes whose planes overflow the
// TPU's scoped VMEM). A warp streams its row's tiles with an online
// softmax and keeps no per-slot state, so one kernel serves every L.
//
// Bound on the H100: operations. At the bench width (Q=2, B=4096, L=301,
// H=96, ncol=4) it reads about 22 MB of keys and masks (7 us at 3.35 TB/s)
// but needs, for every valid slot and channel, two hidden rows (ncol
// multiply-adds, a bias add and a max each), the gate's multiply-add and
// the pool's: on sampled sets (about 40% of the slots valid) some
// 2.3 GFLOP, 35 us on the fp32 CUDA cores (chip_smoke.py counts it from its
// inputs). It stays in fp32.
//
// Design: a warp per (q, b) row, 2 rows a block, the channels' weight
// records in shared memory (attn_pool.cuh). No block barrier after the
// records are stored. Per tile of 32 slots that holds a slot to walk:
//   1. lanes over slots: each lane unpacks its slot's fields once and sums
//      its gate over the H channels, the records read as broadcasts; the
//      tile's max and sum of exp(gate - m) take warp butterflies, and the
//      lane writes its slot's fields and weight e to the warp's records;
//   2. lanes over channels (kJ chunks of 32 channels at a time): each
//      channel sums e * hs over the walked slots, the hidden row formed
//      again from the slot's record, and adds that to its rescaled
//      running sum (a fresh sum a tile keeps long rows accurate).
// The hidden row is formed twice, about 2 (ncol + 1) multiply-adds more
// per slot and channel; that buys the cross-lane reduction of the gates
// and every block barrier.

#include "attn_pool.cuh"

namespace {

using namespace attn;

constexpr int kWarps = 2;   // rows a block
constexpr int kJ = 3;       // channel chunks of 32 a lane holds at once

// floats of dynamic shared memory: the records, then per warp its slot
// records and its channels' running sums
template <int NCOL>
size_t fwd_smem_floats(int H) {
  return (size_t)pad32(H) * rec_k<NCOL>()
         + (size_t)kWarps * (kTile * rec_s<NCOL>() + pad32(H));
}

template <int NCOL, bool ROOT>
__global__ void __launch_bounds__(kWarps * 32)
attn_pool_fwd_kernel(Planes p, float* out, float* m_out, float* s_out) {
  constexpr int K = rec_k<NCOL>();
  constexpr int S = rec_s<NCOL>();
  extern __shared__ float4 smem4[];
  float* urec = reinterpret_cast<float*>(smem4);
  const int hp = pad32(p.H);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* rec = urec + hp * K + warp * (kTile * S + hp);
  float* acc = rec + kTile * S;  // acc[h]: lane h % 32's own entries
  load_urec<NCOL>(p, urec);
  __syncthreads();

  const int row = blockIdx.x * kWarps + warp;
  if (row >= p.rows) return;
  const size_t off = (size_t)row * p.L;
  const float gconst = p.gv[p.H];
  const int nch = hp / 32;
  for (int h = lane; h < hp; h += 32) acc[h] = 0.f;
  const bool any = row_has_valid(p, off);

  float m = -INFINITY;  // running max of the walked gates (every lane)
  float ssum = 0.f;     // running sum of exp(gate - m)
  for (int base = 0; base < p.L; base += kTile) {
    const unsigned walk = walk_bits(p, off, base, any);
    if (walk == 0) continue;
    const int s = base + lane;
    const Slot<NCOL> f = unpack<NCOL, ROOT>(p, off + s, s < p.L);
    const float gate = slot_gate<NCOL, false>(f, urec, p.H, gconst, nullptr,
                                              nullptr);
    const bool on = (walk >> lane) & 1u;
    const float mt = fmaxf(m, warp_max(on ? gate : -INFINITY));
    const float scale = expf(m - mt);  // 0 on the first walked tile
    const float e = on ? expf(gate - mt) : 0.f;
    ssum = fmaf(ssum, scale, warp_sum(e));
    m = mt;
    put_slot<NCOL>(rec, f, e, 0.f);
    __syncwarp();
    for (int c0 = 0; c0 < nch; c0 += kJ) {
      float w[kJ][K];
      float a[kJ];
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int h = (c0 + j) * 32 + lane;
        if (c0 + j < nch) {
          load4(urec + h * K, w[j]);
          a[j] = 0.f;  // the tile's own sum, added to the running one
        }
      }
      for (unsigned bits = walk; bits; bits &= bits - 1) {
        float r[S];
        load4(rec + (__ffs(bits) - 1) * S, r);
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          if (c0 + j < nch) {
            float zo, zc;
            z_pair<NCOL>(r, r + NCOL + 1, r[NCOL], w[j], zo, zc);
            a[j] = fmaf(r[2 * NCOL + 1], hidden(zo, zc), a[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        float* r = acc + (c0 + j) * 32 + lane;
        if (c0 + j < nch) *r = fmaf(*r, scale, a[j]);
      }
    }
    __syncwarp();  // the records are read before the next tile's
  }
  for (int h = lane; h < p.H; h += 32)
    out[(size_t)row * p.H + h] = acc[h] / ssum;
  if (lane == 0) {
    m_out[row] = m;
    s_out[row] = ssum;
  }
}

template <int NCOL>
cudaError_t launch(const Planes& p, bool root, float* out, float* m,
                   float* s, cudaStream_t stream) {
  const size_t smem = fwd_smem_floats<NCOL>(p.H) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  void (*kernel)(Planes, float*, float*, float*) =
      root ? &attn_pool_fwd_kernel<NCOL, true>
           : &attn_pool_fwd_kernel<NCOL, false>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (p.rows + kWarps - 1) / kWarps;
  kernel<<<blocks, kWarps * 32, smem, stream>>>(p, out, m, s);
  return cudaGetLastError();
}

}  // namespace

extern "C" int attn_pool_fwd_launch(const void* kown, const void* kcross,
                                    const void* mask, const void* rown,
                                    const void* rcross, const void* u,
                                    const void* gv, void* out, void* m,
                                    void* s, int Q, int B, int L, int H,
                                    int ncol, int shift, void* stream) {
  const Planes p{(const uint32_t*)kown, (const uint32_t*)kcross,
                 (const uint8_t*)mask, (const int32_t*)rown,
                 (const int32_t*)rcross, (const float*)u, (const float*)gv,
                 Q * B, L, H, shift};
  const bool root = rown != nullptr;
  const cudaStream_t st = (cudaStream_t)stream;
  float* o = (float*)out;
  float* mm = (float*)m;
  float* ss = (float*)s;
  if (Q < 1 || B < 1 || L < 1 || H < 1 || H > 1024)
    return (int)cudaErrorInvalidValue;
  switch (ncol) {
    case 2: return (int)launch<2>(p, root, o, mm, ss, st);
    case 3: return (int)launch<3>(p, root, o, mm, ss, st);
    case 4: return (int)launch<4>(p, root, o, mm, ss, st);
    case 5: return (int)launch<5>(p, root, o, mm, ss, st);
    case 6: return (int)launch<6>(p, root, o, mm, ss, st);
    case 7: return (int)launch<7>(p, root, o, mm, ss, st);
    case 8: return (int)launch<8>(p, root, o, mm, ss, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
