// Fused key unpack + hidden layer + masked set sum, backward: the gradient
// of the forward (csrc/hidden_sum.cu) with respect to u_ext [ncol + 2, H],
// given the cotangent g [Q, B, H]:
//
//   dU = sum_{q,b,l} mask_own[q,b,l] * fext(kown[q,b,l])^T dz[q,b,l]
//      + sum_{b,l'}  fext(kcross[b,l'])^T dzc[b,l']
//   dz  = (z > 0) * g[q,b],  dzc = (zc > 0) * sum_q mask_cross[q,b,l'] g[q,b]
//
// with z = f(k) . U + b1 recomputed from the keys, and fext(k) = [f(k), 0,
// 1]: the masking row (ncol) of dU is always 0, the bias row (ncol + 1) is
// the sum of dz. Masked own slots never pass the relu (the masking row
// pushes them to -1e9), so they are skipped.
//
// Replaces the TPU kernel surel_plus_tpu/ops/pallas/hidden_sum_kernel.py
// (_bwd_kernel, launched by _pallas_bwd), which contracts fields^T @ dz on
// the MXU and routes a cross slot's cotangent through a group-selector
// matmul; here the contraction runs on the tensor cores too
// (csrc/hidden_tc.cuh).
//
// Bound on the H100: operations. At the bench width (Q=2, B=4096, L=301,
// Lc=602, H=96, ncol=4) it reads the forward's 30 MB of keys and masks and
// 3 MB of g (10 us at 3.35 TB/s), and for every selected slot and channel
// recomputes z on the CUDA cores (ncol fmaf and a compare, in the
// forward's order, so that the relu decisions are the forward's); the
// products into dU go to the tensor cores (two TF32 products: dz is a sum
// of fp32 cotangents, split in big and small parts).
//
// Design: a warp per query row (kWarps rows a block; warp w of block p
// takes rows p * kWarps + w, + P * kWarps, ...: a fixed partition). For
// its row the warp writes the table of the cotangent sums of every
// endpoint subset, G[m] = sum of g[q, b] over the bits q of m (q
// ascending, as the per-slot sums were taken before), to its own shared
// memory. It then walks the shared cross plane and each endpoint's own
// row in 32-slot tiles, the next tile's keys and masks loaded while the
// current one is processed. Each lane reads its slot's endpoint bits once
// (Q mask bytes of a cross slot, one of an own slot); a ballot marks the
// selected slots and they are appended, compacted, to the warp's queue of
// (key, root, bits). Each time the queue holds whole k-steps of 8 slots
// they are contracted (lane (g, c) takes queue entries c and c + 4: its K
// entries), dz = (z > 0) * G[bits] formed in registers, into a fresh
// accumulator that is then added to the warp's sums; the rest of the queue
// moves to its front. At the row's end the queue is padded with empty
// entries (bits 0, G[0] = 0). Only the warp's own barrier is taken inside
// the walk. At the end a block adds its warps' sums in warp order into one
// partial, and a second pass adds the P partials in a fixed order (no
// float atomics: two launches give the same bits).

#include <cstdint>
#include <cuda_runtime.h>

#include "hidden_tc.cuh"

namespace {

using namespace htc;

struct Args {
  SumRows r;
  const float* u;          // [ncol + 2, H]
  const float* g;          // [Q, B, H]
  float* part;             // [ncol + 1, H, P]
  int H, shift, P;
};

// The layout of one instance: m-tiles of a slab, slab channels, the
// combination table's row stride (floats) and a warp's shared memory for
// Q endpoints (the table, then the queue's keys, roots and bits).
template <int NCOL>
struct Layout {
  static constexpr int kMS = slab_mtiles(NCOL, false);
  static constexpr int kNT = n_tiles(NCOL);
  static constexpr int kCS = 16 * kMS;
  static constexpr int kGS = kCS + 8;
  __host__ __device__ static constexpr int warp_bytes(int q) {
    return (1 << q) * kGS * 4 + 3 * kQueue * 4;
  }
};

template <int NCOL, bool ROOT>
__global__ void __launch_bounds__(kWarps * 32)
hidden_sum_bwd_kernel(Args a) {
  using Lay = Layout<NCOL>;
  constexpr int MS = Lay::kMS, NT = Lay::kNT, CS = Lay::kCS, GS = Lay::kGS;
  constexpr int kCh = (CS + 31) / 32;  // table channels a lane writes
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int c0 = blockIdx.y * CS;  // the slab's first channel
  const bool fsplit = a.shift > kExactShift;
  const SumRows r = a.r;
  float* tab = reinterpret_cast<float*>(smem + (size_t)warp *
                                                   Lay::warp_bytes(r.Q));
  uint32_t* qk = reinterpret_cast<uint32_t*>(tab + (1 << r.Q) * GS);
  int32_t* qr = reinterpret_cast<int32_t*>(qk + kQueue);
  uint32_t* qs = qk + 2 * kQueue;

  Cols<NCOL, MS> cols;
  load_cols(cols, a.u, a.H, c0, g);

  float run[MS][NT][4], acc[MS][NT][4];
#pragma unroll
  for (int m = 0; m < MS; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) run[m][n][e] = acc[m][n][e] = 0.f;

  const int ntiles = r.cross_tiles() + r.Q * r.own_tiles();
  const uint32_t lt = (1u << lane) - 1u;

  // the k-step of queue entries e0 + c (K entry c) and e0 + c + 4 (K c + 4)
  auto kstep = [&](int e0) {
    const int i0 = e0 + c, i1 = e0 + c + 4;
    float f0[NCOL], f1[NCOL];
    fields<NCOL, ROOT>(qk[i0], qr[i0], a.shift, f0);
    fields<NCOL, ROOT>(qk[i1], qr[i1], a.shift, f1);
    BFrag<NT> bf;
    b_frag(bf, f0, f1, g);
    const float* t0 = tab + qs[i0] * GS + 2 * g;
    const float* t1 = tab + qs[i1] * GS + 2 * g;
#pragma unroll
    for (int m = 0; m < MS; ++m) {
      const float2 g0 = *reinterpret_cast<const float2*>(t0 + 16 * m);
      const float2 g1 = *reinterpret_cast<const float2*>(t1 + 16 * m);
      const float z00 = zed(f0, cols.u[2 * m], cols.b[2 * m]);
      const float z01 = zed(f0, cols.u[2 * m + 1], cols.b[2 * m + 1]);
      const float z10 = zed(f1, cols.u[2 * m], cols.b[2 * m]);
      const float z11 = zed(f1, cols.u[2 * m + 1], cols.b[2 * m + 1]);
      contract<NT, true>(acc[m], z00 > 0.f ? g0.x : 0.f,
                         z01 > 0.f ? g0.y : 0.f, z10 > 0.f ? g1.x : 0.f,
                         z11 > 0.f ? g1.y : 0.f, bf, fsplit);
    }
  };

  for (int b = blockIdx.x * kWarps + warp; b < r.B;
       b += gridDim.x * kWarps) {
    // the cotangent sums of every endpoint subset, for the slab's channels
    float gq[kMaxQ][kCh];
#pragma unroll
    for (int q = 0; q < kMaxQ; ++q)
#pragma unroll
      for (int j = 0; j < kCh; ++j) {
        const int ch = c0 + lane + 32 * j;
        gq[q][j] = q < r.Q && lane + 32 * j < CS && ch < a.H
                       ? __ldg(a.g + ((size_t)q * r.B + b) * a.H + ch)
                       : 0.f;
      }
    Slot nxt = row_slot<ROOT>(r, b, 0, lane);
    __syncwarp();  // the previous row's reads of the table are done
    for (int m = 0; m < (1 << r.Q); ++m)
#pragma unroll
      for (int j = 0; j < kCh; ++j) {
        if (lane + 32 * j >= CS) continue;
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < kMaxQ; ++q)
          if ((m >> q) & 1) s += gq[q][j];
        tab[m * GS + lane + 32 * j] = s;
      }

    int n = 0;  // entries in the queue
    for (int ti = 0; ti < ntiles; ++ti) {
      const Slot cur = nxt;
      if (ti + 1 < ntiles) nxt = row_slot<ROOT>(r, b, ti + 1, lane);
      const uint32_t sel = __ballot_sync(0xffffffffu, cur.bits != 0);
      if (cur.bits) {
        const int at = n + __popc(sel & lt);
        qk[at] = cur.key;
        qr[at] = cur.root;
        qs[at] = cur.bits;
      }
      n += __popc(sel);
      __syncwarp();  // the queue (and the table) written
      const int nk = n / 8;
      if (nk == 0) continue;
      for (int j = 0; j < nk; ++j) kstep(8 * j);
      fold(run, acc);
      const int rest = n - 8 * nk;
      Slot s{0u, 0u, 0};
      if (lane < rest) {
        s.key = qk[8 * nk + lane];
        s.root = qr[8 * nk + lane];
        s.bits = qs[8 * nk + lane];
      }
      __syncwarp();
      if (lane < rest) {
        qk[lane] = s.key;
        qr[lane] = s.root;
        qs[lane] = s.bits;
      }
      __syncwarp();
      n = rest;
    }
    if (n > 0) {  // the row's last entries, padded with empty ones
      if (lane >= n && lane < 8) {
        qk[lane] = 0u;
        qr[lane] = 0;
        qs[lane] = 0u;
      }
      __syncwarp();
      kstep(0);
      fold(run, acc);
    }
  }
  store_partial<NCOL, MS, NT>(run, reinterpret_cast<float*>(smem), a.part,
                              a.H, a.P, blockIdx.x, c0);
}

template <int NCOL, bool ROOT>
cudaError_t launch_typed(const Args& a, cudaStream_t stream) {
  using Lay = Layout<NCOL>;
  const size_t red = sizeof(float) * kWarps * Lay::kMS * Lay::kNT * 4 * 32;
  const size_t ring = (size_t)kWarps * Lay::warp_bytes(a.r.Q);
  const size_t smem = ring > red ? ring : red;
  auto kernel = hidden_sum_bwd_kernel<NCOL, ROOT>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.P, (a.H + Lay::kCS - 1) / Lay::kCS);
  kernel<<<grid, kWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int NCOL>
cudaError_t launch(const Args& a, bool root, cudaStream_t stream) {
  return root ? launch_typed<NCOL, true>(a, stream)
              : launch_typed<NCOL, false>(a, stream);
}

}  // namespace

// part: scratch of (ncol + 1) * H * P floats; P (1 <= P <= B) fixes the
// partition of the rows, and with it the bits of the result.
extern "C" int hidden_sum_bwd_launch(const void* kown, const void* mown,
                                     const void* kcross, const void* mcross,
                                     const void* rown, const void* rcross,
                                     const void* u, const void* g, void* part,
                                     void* du, int Q, int B, int Lo, int Lc,
                                     int ldc, int H, int ncol, int shift,
                                     int P, void* stream) {
  const Args a{SumRows{(const uint32_t*)kown, (const uint8_t*)mown,
                       (const uint32_t*)kcross, (const uint8_t*)mcross,
                       (const int32_t*)rown, (const int32_t*)rcross, Q, B,
                       Lo, Lc, ldc},
               (const float*)u, (const float*)g, (float*)part, H, shift, P};
  const bool root = rown != nullptr;
  const cudaStream_t s = (cudaStream_t)stream;
  if (Q < 1 || Q > kMaxQ || H < 1 || H > 1024 || B < 1 || P < 1 || P > B
      || ldc < Lc)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  switch (ncol) {
    case 2: err = launch<2>(a, root, s); break;
    case 3: err = launch<3>(a, root, s); break;
    case 4: err = launch<4>(a, root, s); break;
    case 5: err = launch<5>(a, root, s); break;
    case 6: err = launch<6>(a, root, s); break;
    case 7: err = launch<7>(a, root, s); break;
    case 8: err = launch<8>(a, root, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  reduce_partials<<<(ncol + 2) * H, kReduceThreads, 0, s>>>(
      (const float*)part, (float*)du, ncol, H, P);
  return (int)cudaGetLastError();
}
