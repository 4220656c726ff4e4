// Fused key unpack + hidden layer, per slot, pair-summed (K7), backward:
// the gradient of the forward (csrc/hidden_slots.cu) with respect to
// u_ext [ncol + 2, H], given the cotangent g [Q, B, L, H]:
//
//   dU = sum over slots s and both sides k in {kown[s], kcross[s]} of
//        fext(k)^T (z(k) > 0) g[s],   z(k) = f(k) . U + b1
//
// with z recomputed from the keys and fext(k) = [f(k), 0, 1]: the masking
// row (ncol) of dU is always 0, the bias row (ncol + 1) the sum of the
// cotangents past the relu. g is read in its own type (fp32 or bf16).
//
// Replaces the TPU kernel surel_plus_tpu/ops/pallas/hidden_sum_kernel.py
// (_slots_bwd_kernel, launched by _slots_pallas_bwd), which contracts
// fields^T @ dz on the MXU; here the contraction runs on the tensor cores
// too (csrc/hidden_tc.cuh).
//
// Bound on the H100: bytes. At the bench width (Q=2, B=4096, L=301, H=96,
// ncol=4) it reads 20 MB of keys and g, 473 MB in bf16 (947 MB in fp32):
// about 0.15 ms at 3.35 TB/s. On the CUDA cores it recomputes z for every
// slot, side and channel (ncol fmaf and a compare, in the forward's order,
// so that the relu decisions are the forward's); the products into dU go
// to the tensor cores (one TF32 product for a bf16 g, exact; two for an
// fp32 g, split in big and small parts).
//
// Design: every warp of the grid is a worker of its own. The flattened
// slots are cut into tiles of `tile_slots` slots (a whole number of
// k-steps of 4 slots, a few KB of g); warp w of block p takes the tiles
// p * kWarps + w, + P * kWarps, ... (a fixed partition: the bits do not
// depend on the card). Each warp streams its tiles' cotangent rows (the
// slab's channels) and keys through a ring of kStages stages in its own
// shared memory with cp.async: the next tile is in flight while it
// computes the current one, and the only barrier in the loop is the
// warp's own. Three blocks of four warps fill an SM (registers bound
// them), so the grid of P = 396 blocks is one wave on an H100. Two stages
// of 6 KB measured faster there than three of 4 KB: fewer, longer tiles.
// In a k-step lane (g, c) takes slot 4 ks + c: its own side is K entry c,
// its partner side K entry c + 4, so the lane reads one pair of
// cotangent values per m-tile (channels 16 mt + 2 g, + 1, shared by both
// sides), forms the four dZ of its A fragment in registers and unpacks its
// B fragment from the same two keys. Each tile's products go into a fresh
// accumulator added to the warp's sums in fp32; at the end a block adds
// its warps' sums in warp order into one partial, and a second pass adds
// the P partials in a fixed order (no float atomics: two launches give the
// same bits).

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hidden_tc.cuh"

namespace {

using namespace htc;

struct Args {
  const uint32_t* kown;   // [N] (N = Q * B * L slots)
  const uint32_t* kcross; // [N], slot-aligned
  const int32_t* rown;    // [N] or null
  const int32_t* rcross;  // [N] or null
  const float* u;         // [ncol + 2, H]
  const void* g;          // [N, H] float or bf16
  float* part;            // [ncol + 1, H, P]
  size_t N;
  int H, shift, P;
  int unit;               // bytes of a cotangent copy: 16, 4 or 2
};

// The layout of one instance: m-tiles of a slab, slab channels, slots of a
// tile, staged row stride (elements) and the bytes of a stage.
template <int NCOL, bool BF16>
struct Layout {
  static constexpr int kES = BF16 ? 2 : 4;
  static constexpr int kMS = slab_mtiles(NCOL, true);
  static constexpr int kNT = n_tiles(NCOL);
  static constexpr int kCS = 16 * kMS;
  static constexpr int kTS = tile_slots(kMS, kES);
  static constexpr int kRS = kCS + kRowPad / kES;
  static constexpr int kGBytes = kTS * kRS * kES;
  static constexpr int kStage = kGBytes + 4 * kTS * 4;  // g, then 4 key planes
  static constexpr int kSmem = kWarps * kStages * kStage;
};

// The two cotangent values of a lane's channel pair in a staged row.
__device__ __forceinline__ float2 pair_at(const float* row, int j) {
  return *reinterpret_cast<const float2*>(row + j);
}
__device__ __forceinline__ float2 pair_at(const __nv_bfloat16* row, int j) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(row + j);
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}

template <int NCOL, bool ROOT, bool BF16>
__global__ void __launch_bounds__(kWarps * 32, 3)
hidden_slots_bwd_kernel(Args a) {
  using Lay = Layout<NCOL, BF16>;
  using T = std::conditional_t<BF16, __nv_bfloat16, float>;
  constexpr int MS = Lay::kMS, NT = Lay::kNT, CS = Lay::kCS, TS = Lay::kTS,
                RS = Lay::kRS, ES = Lay::kES;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int c0 = blockIdx.y * CS;  // the slab's first channel
  const int cw = min(CS, a.H - c0);
  unsigned char* ring = smem + (size_t)warp * kStages * Lay::kStage;
  const bool fsplit = a.shift > kExactShift;

  Cols<NCOL, MS> cols;
  load_cols(cols, a.u, a.H, c0, g);

  // the copy plan of a tile's cotangent rows: `upr` units a row; a lane
  // takes rows r0, r0 + rstep, ... and units k0, k0 + kstep, ...
  const int upr = cw * ES / a.unit;
  int r0, rstep, k0, kstep;
  bool copier = true;
  if (upr >= 32) {
    r0 = 0, rstep = 1, k0 = lane, kstep = 32;
  } else {
    const int rpp = 32 / upr;
    r0 = lane / upr, rstep = rpp, k0 = lane % upr, kstep = upr;
    copier = lane < rpp * upr;
  }
  const unsigned char* gb = static_cast<const unsigned char*>(a.g);

  const size_t ntiles = (a.N + TS - 1) / TS;
  const size_t first = (size_t)blockIdx.x * kWarps + warp;
  const size_t step = (size_t)gridDim.x * kWarps;

  // tile t into stage s: g rows, keys and roots; rows of the last tile's
  // final k-step past N are zeroed (their dZ must be 0)
  auto issue = [&](size_t t, int s) {
    if (t >= ntiles) return;
    unsigned char* st = ring + s * Lay::kStage;
    const size_t base = t * TS;
    const int n = a.N - base < (size_t)TS ? (int)(a.N - base) : TS;
    if (copier) {
      for (int r = r0; r < n; r += rstep) {
        const unsigned char* src = gb + ((base + r) * a.H + c0) * ES;
        unsigned char* dst = st + r * RS * ES;
        for (int k = k0; k < upr; k += kstep) {
          if (a.unit == 16)
            copy_async<16>(dst + 16 * k, src + 16 * k);
          else if (a.unit == 4)
            copy_async<4>(dst + 4 * k, src + 4 * k);
          else
            *reinterpret_cast<uint16_t*>(dst + 2 * k) =
                *reinterpret_cast<const uint16_t*>(src + 2 * k);
        }
      }
    }
    const int nz = (n + 3) / 4 * 4;
    for (int i = n * RS + lane; i < nz * RS; i += 32)
      reinterpret_cast<T*>(st)[i] = T(0.f);
    uint32_t* keys = reinterpret_cast<uint32_t*>(st + Lay::kGBytes);
    if (lane < n) {
      copy_async<4>(keys + lane, a.kown + base + lane);
      copy_async<4>(keys + TS + lane, a.kcross + base + lane);
      if (ROOT) {
        copy_async<4>(keys + 2 * TS + lane, a.rown + base + lane);
        copy_async<4>(keys + 3 * TS + lane, a.rcross + base + lane);
      }
    }
  };

  float run[MS][NT][4], acc[MS][NT][4];
#pragma unroll
  for (int m = 0; m < MS; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) run[m][n][e] = acc[m][n][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    issue(first + s * step, s);
    copies_commit();
  }
  int it = 0;
  for (size_t t = first; t < ntiles; t += step, ++it) {
    copies_wait<kStages - 2>();  // tile `it` has landed (this lane's part)
    __syncwarp();                // every lane's part, and the stage freed
    issue(t + (kStages - 1) * step, (it + kStages - 1) % kStages);
    copies_commit();

    const unsigned char* st = ring + (it % kStages) * Lay::kStage;
    const T* gs = reinterpret_cast<const T*>(st);
    const uint32_t* keys = reinterpret_cast<const uint32_t*>(st + Lay::kGBytes);
    const int n = a.N - t * TS < (size_t)TS ? (int)(a.N - t * TS) : TS;
    const int nk = (n + 3) / 4;
    for (int ks = 0; ks < nk; ++ks) {
      const int r = 4 * ks + c;
      const bool live = r < n;  // keys past N were not copied
      float fo[NCOL], fc[NCOL];
      fields<NCOL, ROOT>(live ? keys[r] : 0u,
                         ROOT && live ? (int32_t)keys[2 * TS + r] : 0,
                         a.shift, fo);
      fields<NCOL, ROOT>(live ? keys[TS + r] : 0u,
                         ROOT && live ? (int32_t)keys[3 * TS + r] : 0,
                         a.shift, fc);
      BFrag<NT> bf;
      b_frag(bf, fo, fc, g);
      const T* row = gs + r * RS + 2 * g;
#pragma unroll
      for (int m = 0; m < MS; ++m) {
        const float2 gv = pair_at(row, 16 * m);
        const float zo0 = zed(fo, cols.u[2 * m], cols.b[2 * m]);
        const float zo1 = zed(fo, cols.u[2 * m + 1], cols.b[2 * m + 1]);
        const float zc0 = zed(fc, cols.u[2 * m], cols.b[2 * m]);
        const float zc1 = zed(fc, cols.u[2 * m + 1], cols.b[2 * m + 1]);
        contract<NT, !BF16>(acc[m], zo0 > 0.f ? gv.x : 0.f,
                            zo1 > 0.f ? gv.y : 0.f, zc0 > 0.f ? gv.x : 0.f,
                            zc1 > 0.f ? gv.y : 0.f, bf, fsplit);
      }
    }
    fold(run, acc);
  }
  copies_wait<0>();
  store_partial<NCOL, MS, NT>(run, reinterpret_cast<float*>(smem), a.part,
                              a.H, a.P, blockIdx.x, c0);
}

template <int NCOL, bool ROOT, bool BF16>
cudaError_t launch_typed(const Args& a, cudaStream_t stream) {
  using Lay = Layout<NCOL, BF16>;
  const size_t red = sizeof(float) * kWarps * Lay::kMS * Lay::kNT * 4 * 32;
  const size_t smem = Lay::kSmem > red ? Lay::kSmem : red;
  auto kernel = hidden_slots_bwd_kernel<NCOL, ROOT, BF16>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.P, (a.H + Lay::kCS - 1) / Lay::kCS);
  kernel<<<grid, kWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int NCOL>
cudaError_t launch(const Args& a, bool root, bool bf16, cudaStream_t s) {
  if (root)
    return bf16 ? launch_typed<NCOL, true, true>(a, s)
                : launch_typed<NCOL, true, false>(a, s);
  return bf16 ? launch_typed<NCOL, false, true>(a, s)
              : launch_typed<NCOL, false, false>(a, s);
}

}  // namespace

// g: [Q, B, L, H], bf16 when `bf16` is 1, else float. part: scratch of
// (ncol + 1) * H * P floats; P (1 <= P) fixes the partition of the slots,
// and with it the bits of the result.
extern "C" int hidden_slots_bwd_launch(const void* kown, const void* kcross,
                                       const void* rown, const void* rcross,
                                       const void* u, const void* g,
                                       void* part, void* du, int Q, int B,
                                       int L, int H, int ncol, int shift,
                                       int bf16, int P, void* stream) {
  const bool root = rown != nullptr;
  const cudaStream_t s = (cudaStream_t)stream;
  if (Q < 1 || B < 1 || L < 1 || H < 1 || H > 1024 || P < 1 ||
      (root != (rcross != nullptr)))
    return (int)cudaErrorInvalidValue;
  // the widest copy the rows' alignment allows
  const int es = bf16 ? 2 : 4;
  const uintptr_t gp = reinterpret_cast<uintptr_t>(g);
  const int unit = (H * es) % 16 == 0 && gp % 16 == 0   ? 16
                   : (H * es) % 4 == 0 && gp % 4 == 0 ? 4
                                                       : 2;
  const Args a{(const uint32_t*)kown, (const uint32_t*)kcross,
               (const int32_t*)rown, (const int32_t*)rcross, (const float*)u,
               g, (float*)part, (size_t)Q * B * L, H, shift, P, unit};
  cudaError_t err;
  switch (ncol) {
    case 2: err = launch<2>(a, root, bf16, s); break;
    case 3: err = launch<3>(a, root, bf16, s); break;
    case 4: err = launch<4>(a, root, bf16, s); break;
    case 5: err = launch<5>(a, root, bf16, s); break;
    case 6: err = launch<6>(a, root, bf16, s); break;
    case 7: err = launch<7>(a, root, bf16, s); break;
    case 8: err = launch<8>(a, root, bf16, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  reduce_partials<<<(ncol + 2) * H, kReduceThreads, 0, s>>>(
      a.part, (float*)du, ncol, H, P);
  return (int)cudaGetLastError();
}
