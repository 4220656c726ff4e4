// The hidden layer z = relu(f(k) . U + b1) on the tensor cores, shared by
// the set sum K1 (hidden_sum.cu: z itself) and the two backwards, K7 bwd
// (hidden_slots_bwd.cu: a per-slot cotangent) and K1 bwd
// (hidden_sum_bwd.cu: a slot's cotangent summed over the endpoints that
// select it). The backwards compute the gradient with respect to u_ext
// [ncol + 2, H]:
//
//   dU^T [H x (ncol + 1)] = dZ^T [H x slots] . F_ext [slots x (ncol + 1)]
//
// with dZ = (z > 0) * (the slot's cotangent), F_ext = [f(k), 1]: the field
// rows, then the bias row (dU row ncol + 1); dU's masking row (ncol) is 0.
// The backwards differ only in how a slot's cotangent is formed. This
// header holds the rest:
//
// - `fields`, `field`: the key's ncol count fields, as the kernels unpack
//   them. `SumRows`: K1's and K1 bwd's operands, a query row's shared
//   cross plane and its endpoints' own rows; `row_slot`: K1 bwd's walk over
//   them, a lane a slot (K1 stages its tiles through shared memory, and
//   reads a tile again with `row_slot` in its recheck).
// - `zed`: z in the fmaf order (b1 first, then field 0, 1, ...). Every
//   strict z > 0 decision of the three kernels is that of this order: K7
//   computes z so on the CUDA cores, the backwards recompute it so, and K1,
//   which forms z on the tensor cores, recomputes it so wherever its
//   tensor-core z lies within the products' error bound of 0
//   (`kNearShift`, hidden_sum.cu).
// - The contraction on mma.sync.m16n8k8 in TF32: M = channels (m-tiles of
//   16), N = the field columns and the bias column (one n-tile while
//   ncol <= 7, two at ncol = 8), K = slots. A lane (g = lane / 4, c =
//   lane % 4) holds rows g, g + 8 of each m-tile, which are the slab
//   channels 16 mt + 2 g and 16 mt + 2 g + 1 (adjacent, so one 4- or
//   8-byte load of a cotangent row gives both), and the K entries c and
//   c + 4 of each k-step, which the kernels fill with the slots whose z
//   the lane computes: the dZ a lane forms is its own A fragment, and the
//   fields it unpacked are its B fragment (no shared-memory exchange).
// - TF32: the fields are integers below 2^shift, exact in TF32 while
//   shift <= 11 (num_walks < 2048). dZ is split in two TF32 parts (big =
//   dZ truncated to TF32, small = dZ - big, which the tensor core reads
//   truncated in turn): two products, as accurate as fp32. A bf16 dZ is
//   exact in TF32 and takes one product. Past shift 11 the fields are
//   split too (big and small parts of an integer below 2^22 are exact),
//   one more product each. K1 splits U the same way (hidden_sum.cu).
// - Each slab of slots (a K7 bwd tile, a K1 bwd batch of at most 4
//   k-steps, a K1 k-step) goes into a fresh accumulator that is then added
//   to the running sums in fp32: the tensor cores' own accumulation over
//   long K drifted past 1e-4 in the LSTM backwards (lstm_tc.cuh).
// - `store_partial`: a block adds its warps' sums in warp order and writes
//   one partial dU; `reduce_partials` adds the P partials of each entry in
//   a fixed order. No float atomics: two launches give the same bits.
//
// Channel slabs: a warp holds U's columns for its lane's channels in
// registers (2 per m-tile), so a slab has `slab_mtiles` m-tiles (96
// channels for the bench's keys, fewer for wider keys); wider H runs more
// slabs (the grid's y). K1's slab is K1 bwd's. The layout constants
// and `slab_mtiles`, `tile_slots` are mirrored in
// ops/kernels/hidden_sum.py (TC_*, `slab_mtiles`, `tile_slots`) and held
// to this file by
// tests/test_torch_port_hidden_bwd_tc.py and
// tests/test_torch_port_hidden_fwd_tc.py.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "smem.cuh"

namespace htc {

using smem::allow_smem;
using smem::copies_commit;
using smem::copies_wait;
using smem::copy_async;

constexpr int kWarps = 4;            // warps of a block: K1, both backwards
constexpr int kStages = 2;           // K7 bwd: tiles in a warp's ring
constexpr int kStageBytes = 6144;    // K7 bwd: cotangent bytes a stage holds
constexpr int kRowPad = 32;          // bytes past a staged row (banks)
constexpr int kMaxQ = 4;             // endpoints per query (K1, K1 bwd)
constexpr int kQueue = 64;           // K1 bwd: compacted slots a warp holds
constexpr int kExactShift = 11;      // fields below 2^11 are exact in TF32
constexpr int kNearShift = 16;       // K1: |z| < S / 2^16 is rechecked
constexpr int kReduceThreads = 256;

// m-tiles (16 channels) of a channel slab for keys of ncol fields, for K7
// bwd (`slots`) or K1 bwd and K1. A warp keeps its slab's U columns and
// sums in registers, and a slab narrower than H walks the slots once more.
// On an H100 at H = 96 one slab of 96 channels was the fastest for all
// three at four fields, and for K7 bwd at five; K1 bwd, whose warps also
// keep a queue, ran faster at five fields in two slabs of 48 (more warps
// an SM).
__host__ __device__ constexpr int slab_mtiles(int ncol, bool slots) {
  return slots ? (ncol <= 5 ? 6 : (ncol <= 6 ? 4 : 3)) : (ncol <= 4 ? 6 : 3);
}

// n-tiles (8 columns) of the field columns and the bias column
__host__ __device__ constexpr int n_tiles(int ncol) { return (ncol + 8) / 8; }

// K7 bwd: slots of a tile, as many whole k-steps (4 slots, both sides) of a
// slab's cotangent rows as kStageBytes holds, 4 to 32
__host__ __device__ constexpr int tile_slots(int ms, int es) {
  return (kStageBytes / (16 * ms * es)) / 4 * 4 < 4
             ? 4
             : ((kStageBytes / (16 * ms * es)) / 4 * 4 > 32
                    ? 32
                    : (kStageBytes / (16 * ms * es)) / 4 * 4);
}

// ------------------------------------------------------- fields and z

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

// Field i alone (i < NCOL, known at run time).
template <int NCOL, bool ROOT>
__device__ __forceinline__ float field(uint32_t key, int32_t root, int shift,
                                       int i) {
  if (i == NCOL - 1)
    return ROOT ? (float)root : (float)((key >> (i * shift)) & 1u);
  return (float)((key >> (i * shift)) & ((1u << shift) - 1u));
}

// The operands of K1 and K1 bwd: a query row b is the shared cross plane
// [B, Lc] (selected per endpoint by mcross) and each endpoint's own row.
// The cross planes' rows lie ldc >= Lc elements apart (a mask plane B ldc
// apart): HONet's halves of its [B, 4L] plane are such row-strided views.
struct SumRows {
  const uint32_t* kown;    // [Q, B, Lo]
  const uint8_t* mown;     // [Q, B, Lo] bool
  const uint32_t* kcross;  // [B, Lc], rows ldc apart
  const uint8_t* mcross;   // [Q, B, Lc] bool, rows ldc apart
  const int32_t* rown;     // [Q, B, Lo] or null
  const int32_t* rcross;   // [B, Lc], rows ldc apart, or null
  int Q, B, Lo, Lc, ldc;
  __device__ int cross_tiles() const { return (Lc + 31) / 32; }
  __device__ int own_tiles() const { return (Lo + 31) / 32; }
};

// A lane's slot of a tile: its key, root and endpoint bits (0: unselected).
struct Slot {
  uint32_t key, bits;
  int32_t root;
};

// Tile ti of row b, slot lane of it: the cross plane's tiles first (bit q
// set where endpoint q selects the slot), then each endpoint's own row
// (its bit where unmasked).
template <bool ROOT>
__device__ __forceinline__ Slot row_slot(const SumRows& r, int b, int ti,
                                         int lane) {
  Slot s{0u, 0u, 0};
  const int ncross = r.cross_tiles();
  if (ti < ncross) {
    const int l = 32 * ti + lane;
    if (l < r.Lc) {
      const size_t at = (size_t)b * r.ldc + l;
      for (int q = 0; q < r.Q; ++q)
        s.bits |= (uint32_t)(r.mcross[((size_t)q * r.B + b) * r.ldc + l] != 0)
                  << q;
      s.key = r.kcross[at];
      if (ROOT) s.root = r.rcross[at];
    }
  } else {
    const int nown = r.own_tiles();
    const int seg = (ti - ncross) / nown;
    const int l = 32 * (ti - ncross - seg * nown) + lane;
    if (l < r.Lo) {
      const size_t at = ((size_t)seg * r.B + b) * r.Lo + l;
      s.bits = (uint32_t)(r.mown[at] != 0) << seg;
      s.key = r.kown[at];
      if (ROOT) s.root = r.rown[at];
    }
  }
  return s;
}

// Column n of F_ext = [f, 1, 0 ...]: the B fragment value of a lane.
template <int NCOL>
__device__ __forceinline__ float ext_col(const float (&f)[NCOL], int n) {
  float v = n == NCOL ? 1.f : 0.f;
#pragma unroll
  for (int i = 0; i < NCOL; ++i)
    if (n == i) v = f[i];
  return v;
}

// z = b1 + f . U[:, h] exactly as the forwards compute it.
template <int NCOL>
__device__ __forceinline__ float zed(const float (&f)[NCOL],
                                     const float (&u)[NCOL], float bias) {
  float z = bias;
#pragma unroll
  for (int i = 0; i < NCOL; ++i) z = fmaf(f[i], u[i], z);
  return z;
}

// A lane's U columns and biases: slab channels 16 mt + 2 g + e (j = 2 mt +
// e), 0 past H (their z is 0, so their dZ is 0 whatever the cotangent).
template <int NCOL, int MS>
struct Cols {
  float u[2 * MS][NCOL];
  float b[2 * MS];
};

template <int NCOL, int MS>
__device__ __forceinline__ void load_cols(Cols<NCOL, MS>& c,
                                          const float* __restrict__ u, int H,
                                          int c0, int g) {
#pragma unroll
  for (int j = 0; j < 2 * MS; ++j) {
    const int ch = c0 + 16 * (j / 2) + 2 * g + (j % 2);
    const bool on = ch < H;
#pragma unroll
    for (int i = 0; i < NCOL; ++i) c.u[j][i] = on ? __ldg(u + i * H + ch) : 0.f;
    c.b[j] = on ? __ldg(u + (NCOL + 1) * H + ch) : 0.f;
  }
}

// ----------------------------------------------------------- TF32 mma

// x = big + small: big is x truncated to TF32 (its low 13 mantissa bits
// cleared), small = x - big exactly, which the tensor core reads truncated
// to TF32 in turn.
struct Split {
  uint32_t big, small;
};

__device__ __forceinline__ Split split(float x) {
  const uint32_t b = __float_as_uint(x) & 0xffffe000u;
  return Split{b, __float_as_uint(x - __uint_as_float(b))};
}

__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d = A B + c, with c in registers of its own (K1: b1 starts the sum).
__device__ __forceinline__ void mma_to(float (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1, float c0,
                                       float c1, float c2, float c3) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c0), "f"(c1), "f"(c2), "f"(c3));
}

// The B fragments of a k-step: column 8 nt + g of the lane's K entries c
// (f0) and c + 4 (f1), in two TF32 parts (small 0 where the fields are
// exact).
template <int NT>
struct BFrag {
  Split b0[NT], b1[NT];
};

template <int NCOL, int NT>
__device__ __forceinline__ void b_frag(BFrag<NT>& b,
                                       const float (&f0)[NCOL],
                                       const float (&f1)[NCOL], int g) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    b.b0[nt] = split(ext_col(f0, 8 * nt + g));
    b.b1[nt] = split(ext_col(f1, 8 * nt + g));
  }
}

// acc[nt] += dZ^T F for one m-tile and k-step. The A fragment: a0 (row g,
// K c), a1 (row g + 8, K c), a2 (row g, K c + 4), a3 (row g + 8, K c + 4).
// ASPLIT: dZ in two TF32 parts (an fp32 cotangent), else dZ is exact in
// TF32 (bf16). fsplit: the fields' small parts too (shift > 11). The small
// terms go first.
template <int NT, bool ASPLIT>
__device__ __forceinline__ void contract(float (&acc)[NT][4], float a0,
                                         float a1, float a2, float a3,
                                         const BFrag<NT>& b, bool fsplit) {
  if (ASPLIT) {
    const Split s0 = split(a0), s1 = split(a1), s2 = split(a2),
                s3 = split(a3);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mma(acc[nt], s0.small, s1.small, s2.small, s3.small, b.b0[nt].big,
          b.b1[nt].big);
      if (fsplit)
        mma(acc[nt], s0.big, s1.big, s2.big, s3.big, b.b0[nt].small,
            b.b1[nt].small);
      mma(acc[nt], s0.big, s1.big, s2.big, s3.big, b.b0[nt].big,
          b.b1[nt].big);
    }
  } else {
    const uint32_t r0 = __float_as_uint(a0), r1 = __float_as_uint(a1),
                   r2 = __float_as_uint(a2), r3 = __float_as_uint(a3);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (fsplit)
        mma(acc[nt], r0, r1, r2, r3, b.b0[nt].small, b.b1[nt].small);
      mma(acc[nt], r0, r1, r2, r3, b.b0[nt].big, b.b1[nt].big);
    }
  }
}

// run += acc, and acc fresh for the next slab.
template <int MS, int NT>
__device__ __forceinline__ void fold(float (&run)[MS][NT][4],
                                     float (&acc)[MS][NT][4]) {
#pragma unroll
  for (int m = 0; m < MS; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        run[m][n][e] += acc[m][n][e];
        acc[m][n][e] = 0.f;
      }
}

// ------------------------------------------------------ partials of dU

// The block's partial dU: after every warp is done with shared memory, each
// warp's sums go to `red` (kWarps * MS * NT * 4 * 32 floats), warp 0 adds
// them in warp order and writes part[(r * H + h) * P + p] for the field
// rows r < ncol and the bias row (r = ncol), channels c0 + ... < H.
template <int NCOL, int MS, int NT>
__device__ __forceinline__ void store_partial(const float (&run)[MS][NT][4],
                                              float* red, float* part, int H,
                                              int P, int p, int c0) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  constexpr int kE = MS * NT * 4;
  __syncthreads();
#pragma unroll
  for (int m = 0; m < MS; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(warp * kE + (m * NT + n) * 4 + e) * 32 + lane] = run[m][n][e];
  __syncthreads();
  if (warp != 0) return;
  const int g = lane / 4, c = lane % 4;
#pragma unroll
  for (int m = 0; m < MS; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = 0.f;
        for (int w = 0; w < kWarps; ++w)
          s += red[(w * kE + (m * NT + n) * 4 + e) * 32 + lane];
        const int ch = c0 + 16 * m + 2 * g + (e >> 1);
        const int col = 8 * n + 2 * c + (e & 1);
        if (ch < H && col <= NCOL)
          part[((size_t)col * H + ch) * P + p] = s;
      }
}

// One block per dU entry: the entry's P partials, summed in a fixed order
// (a strided pass per thread, then a tree over the block). The masking row
// is 0.
__global__ void reduce_partials(const float* part, float* du, int ncol,
                                int H, int P) {
  __shared__ float red[kReduceThreads];
  const int e = blockIdx.x;  // entry r * H + h of du [ncol + 2, H]
  const int r = e / H;
  const int h = e % H;
  if (r == ncol) {
    if (threadIdx.x == 0) du[e] = 0.f;
    return;
  }
  const int pr = r < ncol ? r : ncol;  // partial row of the bias: ncol
  const float* p = part + ((size_t)pr * H + h) * P;
  float s = 0.f;
  for (int i = threadIdx.x; i < P; i += kReduceThreads) s += p[i];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = kReduceThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) du[e] = red[0];
}

}  // namespace htc
