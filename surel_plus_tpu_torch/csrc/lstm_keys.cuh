// The LSTM's forward step loop on the tensor cores, shared by K4
// (lstm_keys.cu: x from the keys) and K5 (lstm.cu: x given), with the
// pieces the backwards (lstm_tc.cuh) share with it: the operands, the field
// extraction, the hidden rows, the cell, the stash and the 3xTF32 product.
// Serving and training run this one code and get the same values bit for
// bit; the training instance also stashes each step's gates and carries for
// the backward, which runs no forward of its own.
//
// The step loop (`forward_kernel`). A row group of 16 rows (one m16 tile)
// runs to its rows' last valid slot INDEX at least, so a masked slot
// anywhere leaves the carry (t1's contract) and an empty row stays exactly
// 0. Per step it forms gates = [x_t | h] [wi; wh] + bh with
// mma.sync.m16n8k8 in 3xTF32 (`split_rn`; each k-step's products in a
// fresh accumulator, added in fp32), on two warps: each takes half of the
// unit tiles (8 units, all four gates) and runs their cells.
// - n-tile (gate q, unit tile n) holds gate q of units 8n .. 8n + 7, so a
//   lane's accumulators hold all four gates of its (row, unit) pairs (rows
//   g, g + 8 and units 8n + 2c, 8n + 2c + 1 of each unit tile; g = lane /
//   4, c = lane % 4): the cell runs in the lane;
// - the K axis is permuted (k-step kk: channels 8kk + 2c and 8kk + 2c + 1
//   at fragment k c and c + 4), so the h' a lane produces is, word for
//   word, the A fragment that the same lane of both warps reads at the next
//   step: h passes through shared memory in lane order, with no shuffle.
// A block's 4 row groups step together, to the block's last valid slot (a
// group past its own rows' last slot only leaves its carries as they
// are), so that they share the weights in shared memory. The weights come
// in fragment order (the wrapper's `fragment_order`: a lane's B fragments
// of both gates of a pair as one float4, a warp's as 512 contiguous
// bytes). At H = 96 (12 unit tiles, the resident path) wh stays in shared
// memory (147,456 bytes) and c in registers; wi does not fit beside it
// (295 KB together), so it streams through a ring of two k-steps (24 KB,
// cp.async, one block barrier a k-step), for which h is updated in place
// (a barrier after the products, a second after the x products). Two
// warps on each of the SM's four schedulers hide the latencies. Other
// widths (H <= 256) read both weights from L2, keep h double buffered and
// c in shared memory, with as many row groups a block as their state
// allows.

#pragma once

#include <cmath>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace lstm {

constexpr int kMaxH = 256;          // LSTM width H and input width h
constexpr int kMaxNcol = 8;         // count fields of a key
constexpr int kWarpRows = 16;       // rows of a row group (an m16 tile)
constexpr int kFwdGroups = 4;       // row groups (two warps each) a block
constexpr int kChunkUnits = 6;      // unit tiles (8 units x 4 gates) a chunk
constexpr int kResidentUnits = 12;  // unit tiles of the resident path
constexpr int kStashRows = 32;      // rows of a stash block
// dynamic shared memory a block may have: 227 KB less the static arrays
constexpr int kMaxSmem = 232448 - 1024;
// NCOL of the backward kernels that read the input rows x [R, L, h] (K5)
// instead of computing them from keys of NCOL count fields (K4)
constexpr int kXRows = 0;

struct Operands {
  const uint32_t* kown;    // [R, L] own lo keys
  const uint32_t* kcross;  // [R, L] slot-aligned partner lo keys
  const uint8_t* mask;     // [R, L] bool
  const int32_t* rown;     // [R, L] root planes, or null
  const int32_t* rcross;   // [R, L] or null
  const int32_t* order;    // [rows] row processed i-th, or null (identity)
  const float* u;          // [ncol + 2, h]: U rows | NEG row | b1 row
  const float* wi;         // [h, 4H] input weights (projection folded in)
  const float* wh;         // [H, 4H]
  const float* bh;         // [4H]
  int rows, L, h, H, shift;
  const float* x;          // [R, L, h] input rows (K5), else null
};

// The forward's operands: the weights in fragment order, each row's end.
struct FwdOperands : Operands {
  const int32_t* ends;     // [R] each row's last valid slot index + 1
  const float* wif;        // wi in fragment order
  const float* whf;        // wh in fragment order
  int ncol;                // count fields of a key (K4), else 0
};

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Fragment order of a weight W [K][4H] (the forward's wi and wh): floats
// [K / 8 up][H / 8 up][2][32 lanes][4], the lane's float4 of (k-step kk,
// unit tile n, gate pair p) being (b0, b1) of gate 2p, then of gate 2p +
// 1, with b0 = W[8kk + 2c][q H + 8n + g] and b1 = W[8kk + 2c + 1][q H + 8n +
// g], 0 outside W (g = lane / 4, c = lane % 4).

// ------------------------------------------------ fields and hidden rows

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

// `fields` with ncol <= kMaxNcol given at run time (the forward's), the
// entries past ncol 0.
template <bool ROOT>
__device__ __forceinline__ void fields_n(uint32_t key, int32_t root,
                                         int shift, int ncol,
                                         float (&f)[kMaxNcol]) {
  const uint32_t fmask = (1u << shift) - 1u;
#pragma unroll
  for (int i = 0; i < kMaxNcol; ++i) {
    float v = 0.f;
    if (i < ncol - 1)
      v = (float)((key >> (i * shift)) & fmask);
    else if (i == ncol - 1)
      v = ROOT ? (float)root : (float)((key >> (i * shift)) & 1u);
    f[i] = v;
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

// x[k] = relu(z_own) + relu(z_cross), the fields given at run time (ncol
// of them), in `side_z`'s order.
__device__ __forceinline__ float hidden_n(const float (&fo)[kMaxNcol],
                                          const float (&fc)[kMaxNcol],
                                          const float* u, int h, int ncol,
                                          int k) {
  float zo = u[(ncol + 1) * h + k], zc = zo;
#pragma unroll
  for (int i = 0; i < kMaxNcol; ++i) {
    if (i < ncol) {
      const float w = u[i * h + k];
      zo = fmaf(fo[i], w, zo);
      zc = fmaf(fc[i], w, zc);
    }
  }
  return fmaxf(zo, 0.f) + fmaxf(zc, 0.f);
}

// ------------------------------------------------------------- the cell

// Exact expf / tanhf: the fast exponential (ex2.approx, with tanh as
// 2 sigmoid(2x) - 1) cut the forward by a ninth at the bench width on an
// H100, but moved parameters after 4 Adam steps by up to 1.6x the
// card-vs-CPU training tolerance (exact: 0.1x).
__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// The gates after their activations: sigmoid(i), sigmoid(f), tanh(g),
// sigmoid(o).
struct Gates {
  float i, f, g, o;
};

__device__ __forceinline__ Gates activate(float gi, float gf, float gg,
                                          float go) {
  return Gates{sigmoid(gi), sigmoid(gf), tanhf(gg), sigmoid(go)};
}

// c' = sigmoid(f) c + sigmoid(i) tanh(g), h' = sigmoid(o) tanh(c')
__device__ __forceinline__ void cell(const Gates& a, float& c, float& h) {
  c = fmaf(a.f, c, a.i * a.g);
  h = a.o * tanhf(c);
}

// ------------------------------------------------------------ the stash

// What the training forward keeps for the backward's sweep, per stash
// block b of kStashRows rows and step t < tend[b], rows in the processing
// order, channels contiguous: the gates after their activations [rb][4H]
// (0 where the slot is masked), and the carries entering the step, c and h
// [rb][H]. All null in serving.
struct Stash {
  float* gates;  // [blocks][L][rb][4H]
  float* cprev;  // [blocks][L][rb][H]
  float* hprev;  // [blocks][L][rb][H]
  int* tend;     // [blocks]: the block's last valid slot index + 1
};

// Offset of (block b, step t, row r, channel 0) in a stash plane of nch
// channels.
__host__ __device__ inline size_t stash_at(int b, int L, int t, int r,
                                           int rb, int nch) {
  return (((size_t)b * L + t) * rb + r) * nch;
}

// ------------------------------------------------------- 3xTF32 products

// x = big + small: big is x truncated to TF32 (its low 13 mantissa bits
// cleared: one LOP3, where cvt.rna.tf32.f32 costs a dozen integer
// instructions on sm_90), small = x - big exactly, which the tensor core
// reads truncated to TF32 in turn.
struct Split {
  uint32_t big, small;
};

__device__ __forceinline__ Split split(float x) {
  const uint32_t b = __float_as_uint(x) & 0xffffe000u;
  return Split{b, __float_as_uint(x - __uint_as_float(b))};
}

// The forward's split: big = x rounded to the nearest TF32 value (ties
// away; two integer instructions), so that small = x - big takes either
// sign and neither the dropped small x small term nor the tensor core's
// truncation of small leans one way over a step's 192-term sums. With
// `split` the forward's final h was 6x further from fp32 on an H100.
__device__ __forceinline__ Split split_rn(float x) {
  const uint32_t b = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
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

// c[n] += a b[n] in 3xTF32 for the first nc of NT n-tiles, for the A
// fragment a (a0: row g, k c; a1: row g + 8, k c; a2: row g, k c + 4; a3:
// row g + 8, k c + 4; g = lane / 4, c = lane % 4) and the B fragments (b0:
// k c, column g; b1: k c + 4, column g). One pass a term, so that the
// products in flight are on different accumulators.
template <int NT>
__device__ __forceinline__ void mma3(float (&c)[NT][4], const Split (&a)[4],
                                     const Split (&b0)[NT],
                                     const Split (&b1)[NT], int nc = NT) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
    if (n < nc)
      mma(c[n], a[0].small, a[1].small, a[2].small, a[3].small, b0[n].big,
          b1[n].big);
#pragma unroll
  for (int n = 0; n < NT; ++n)
    if (n < nc)
      mma(c[n], a[0].big, a[1].big, a[2].big, a[3].big, b0[n].small,
          b1[n].small);
#pragma unroll
  for (int n = 0; n < NT; ++n)
    if (n < nc)
      mma(c[n], a[0].big, a[1].big, a[2].big, a[3].big, b0[n].big,
          b1[n].big);
}

// ---------------------------------------------------------- the forward

// A 4-byte copy from device to shared memory that runs while the thread goes
// on (cp.async); `copies_wait` waits for the thread's copies.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// A 16-byte copy from device to shared memory through L2 (cp.async.cg).
__device__ __forceinline__ void copy_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Dynamic shared memory above the default 48 KB needs an opt-in per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The forward's blocks and shared memory (offsets in floats). A block
// holds `groups` row groups of kWarpRows rows, two warps each: warp u of a
// group takes unit tiles [u0, u1), the first (nu + 1) / 2 for u = 0. On
// the resident path shared memory holds wh in fragment order, a ring of
// two of wi's k-steps (`stage`, [2][nu][2][32][4]), U (K4), the bias in
// lane order [nu][4][8], then each group's words: h [nu][32][4], updated in
// place, and x [nkx][32][4]. On the other path: U, the bias, and each
// group's h [2][nu][32][4] (double buffered), x and c [nu][32][4]. A lane's
// float4 of unit tile (or k-step) n is (row g: channels 8n + 2c, 8n + 2c +
// 1; row g + 8: the same), the accumulator fragment's order.
struct FwdLayout {
  int nu, nkx;   // unit tiles (H / 8 up), k-steps of x (h / 8 up)
  int groups;    // row groups a block
  int resident;  // wh resident, wi staged, c in registers (nu = 12)
  int stage, u, bias, state, per_group, words;
};

__host__ __device__ inline FwdLayout fwd_layout_for(int h, int H, int ncol) {
  FwdLayout f;
  f.nu = (H + 7) / 8;
  f.nkx = (h + 7) / 8;
  const int wh = f.nu * f.nu * 256;
  const int ring = 2 * f.nu * 256;
  const int u = ncol ? round_up((ncol + 2) * h, 4) : 0;
  const int bias = f.nu * 32;
  const int limit = kMaxSmem / 4;
  const int resident_group = 128 * (f.nu + f.nkx);
  f.resident = f.nu == kResidentUnits &&
               wh + ring + u + bias + kFwdGroups * resident_group <= limit;
  if (f.resident) {
    f.per_group = resident_group;
    f.groups = kFwdGroups;
  } else {
    f.per_group = 128 * (3 * f.nu + f.nkx);
    const int g = (limit - u - bias) / f.per_group;
    f.groups = g < kFwdGroups ? g : kFwdGroups;
  }
  f.stage = f.resident ? wh : 0;
  f.u = f.resident ? wh + ring : 0;
  f.bias = f.u + u;
  f.state = f.bias + bias;
  f.words = f.state + f.groups * f.per_group;
  return f;
}

// A lane's two rows at one slot: valid where the row is live and the slot
// unmasked, and (K4) their keys and root values.
struct SlotIn {
  bool valid[2];
  uint32_t ko[2], kc[2];
  int32_t ro[2], rc[2];
};

template <bool KEYS, bool ROOT>
__device__ __forceinline__ SlotIn slot_in(const Operands& p,
                                          const int (&srow)[2],
                                          const bool (&live)[2], int t) {
  SlotIn s;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t off = (size_t)srow[i] * p.L + t;
    s.valid[i] = live[i] && p.mask[off] != 0;
    s.ko[i] = s.kc[i] = 0u;
    s.ro[i] = s.rc[i] = 0;
    if (KEYS && live[i]) {
      s.ko[i] = p.kown[off];
      s.kc[i] = p.kcross[off];
      if (ROOT) {
        s.ro[i] = p.rown[off];
        s.rc[i] = p.rcross[off];
      }
    }
  }
  return s;
}

// The lane's float4 of item n in a lane-ordered buffer [n][32][4].
__device__ __forceinline__ float4* lane4(float* buf, int n, int lane) {
  return reinterpret_cast<float4*>(buf + (n * 32 + lane) * 4);
}

// Channels j0, j0 + 1 of a row, those from n on dropped.
__device__ __forceinline__ void put2(float* row, int j0, int n, float a,
                                     float b) {
  if (j0 + 1 < n && (reinterpret_cast<size_t>(row + j0) & 7) == 0) {
    *reinterpret_cast<float2*>(row + j0) = make_float2(a, b);
  } else {
    if (j0 < n) row[j0] = a;
    if (j0 + 1 < n) row[j0 + 1] = b;
  }
}

// Slot t's hidden rows (K4) into the lane's words of xb [nkx][32][4] for
// the k-steps kk = kk0, kk0 + 2, ...: rows g, g + 8 at channels 8kk + 2c,
// 8kk + 2c + 1 from the slot's keys (s) and U, 0 past h or for a row not
// live; the fields extracted once.
template <bool ROOT>
__device__ __forceinline__ void form_x(const FwdOperands& p, const SlotIn& s,
                                       const bool (&live)[2], const float* su,
                                       float* xb, int nkx, int kk0, int lane) {
  const int gc = lane % 4;
  float fo[2][kMaxNcol], fc[2][kMaxNcol];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    fields_n<ROOT>(s.ko[i], s.ro[i], p.shift, p.ncol, fo[i]);
    fields_n<ROOT>(s.kc[i], s.rc[i], p.shift, p.ncol, fc[i]);
  }
  for (int kk = kk0; kk < nkx; kk += 2) {
    float v[4];
#pragma unroll
    for (int e4 = 0; e4 < 4; ++e4) {
      const int i = e4 / 2;
      const int k = 8 * kk + 2 * gc + e4 % 2;
      v[e4] = live[i] && k < p.h
                  ? hidden_n(fo[i], fc[i], su, p.h, p.ncol, k) : 0.f;
    }
    *lane4(xb, kk, lane) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// Slot t's x rows (K5) into the lane's words of xb for k-step kk, copied
// with cp.async (0 past h or for a row not live).
__device__ __forceinline__ void copy_x(const FwdOperands& p,
                                       const int (&srow)[2],
                                       const bool (&live)[2], int t,
                                       float* xb, int kk, int lane) {
  const int gc = lane % 4;
  float* dst = xb + (kk * 32 + lane) * 4;
#pragma unroll
  for (int e4 = 0; e4 < 4; ++e4) {
    const int i = e4 / 2;
    const int k = 8 * kk + 2 * gc + e4 % 2;
    if (live[i] && k < p.h)
      copy_async(dst + e4, p.x + ((size_t)srow[i] * p.L + t) * p.h + k);
    else
      dst[e4] = 0.f;
  }
}

// Slot t's x, the k-steps kk0, kk0 + 2, ... (the two warps of a row group
// alternate).
template <bool KEYS, bool ROOT>
__device__ __forceinline__ void put_x(const FwdOperands& p, const SlotIn& s,
                                      const int (&srow)[2],
                                      const bool (&live)[2], int t,
                                      const float* su, float* xb, int nkx,
                                      int kk0, int lane) {
  if constexpr (KEYS)
    form_x<ROOT>(p, s, live, su, xb, nkx, kk0, lane);
  else
    for (int kk = kk0; kk < nkx; kk += 2)
      copy_x(p, srow, live, t, xb, kk, lane);
}

// acc[n] += A W for one k-step and unit tiles c0 .. c0 + nc - 1 (nc <=
// NC), in 3xTF32 (`split_rn`): A from the lane's words at a (a k-step's
// [32][4]), W the k-step's fragments of those tiles (wk, from unit tile
// c0 on, [nc][2][32][4]) in device memory (GLOBAL: read through the
// read-only path) or in shared memory. The B fragments are all loaded
// before the products.
template <bool GLOBAL, int NC>
__device__ __forceinline__ void kstep(float (&acc)[NC][4][4], const float* a,
                                      const float* wk, int nc, int lane) {
  float4 w01[NC], w23[NC];
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    if (n < nc) {
      const float4* wp = reinterpret_cast<const float4*>(wk + n * 256) + lane;
      w01[n] = GLOBAL ? __ldg(wp) : wp[0];
      w23[n] = GLOBAL ? __ldg(wp + 32) : wp[32];
    }
  }
  const float4 av = *reinterpret_cast<const float4*>(a + lane * 4);
  const Split s[4] = {split_rn(av.x), split_rn(av.z), split_rn(av.y),
                      split_rn(av.w)};
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    if (n < nc) {
      const Split b0[4] = {split_rn(w01[n].x), split_rn(w01[n].z),
                           split_rn(w23[n].x), split_rn(w23[n].z)};
      const Split b1[4] = {split_rn(w01[n].y), split_rn(w01[n].w),
                           split_rn(w23[n].y), split_rn(w23[n].w)};
      // a fresh accumulator a k-step, added in round-to-nearest fp32: the
      // tensor core's own accumulation over a step's 72 products drifted
      // (4x the fp32 error on an H100)
      float part[4][4] = {};
      mma3<4>(part, s, b0, b1);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][q][e] += part[q][e];
    }
  }
}

// `kstep` over k-steps kk < nk: A from abuf [nk][32][4], W in fragment
// order (nu unit tiles a k-step).
template <bool GLOBAL, int NC>
__device__ __forceinline__ void products(float (&acc)[NC][4][4],
                                         const float* abuf, const float* w,
                                         int nk, int nu, int c0, int nc,
                                         int lane) {
  for (int kk = 0; kk < nk; ++kk)
    kstep<GLOBAL, NC>(acc, abuf + kk * 128,
                      w + ((size_t)kk * nu + c0) * 256, nc, lane);
}

// wi's k-step kk (fragment order, all nu unit tiles: nu KB) into dst in
// shared memory with cp.async, spread over the block's threads.
__device__ __forceinline__ void stage_wi(const float* wif, int kk, int nu,
                                         float* dst, int tid, int nt) {
  const float* src = wif + (size_t)kk * nu * 256;
  for (int i = tid; i < nu * 64; i += nt)
    copy_async16(dst + 4 * i, src + 4 * i);
}

// The forward. Row group r of block b (warps 2r, 2r + 1) takes the
// processing positions (b groups + r) 16 .. + 15; the block runs to its
// rows' last valid slot. Both instances write the final h to out[order[i]];
// the training instance (STASH) also writes the stash and each stash
// block's own step count (its rows' last valid slot). KEYS: x from the keys
// (K4), else copied from p.x (K5). RES: the resident path (nu =
// kResidentUnits: a warp's 6 unit tiles in one chunk, wh resident, wi
// staged a k-step at a time, h updated in place, c in registers); else a
// warp's tiles run in chunks of kChunkUnits, wi and wh from L2.
template <bool KEYS, bool ROOT, bool STASH, bool RES>
__global__ void __launch_bounds__(64 * kFwdGroups, 1)
forward_kernel(FwdOperands p, FwdLayout fl, float* out, Stash st) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kHalf = kResidentUnits / 2;  // a warp's unit tiles (RES)
  constexpr int NC = RES ? kHalf : kChunkUnits;  // unit tiles a chunk
  __shared__ int sends[2 * kFwdGroups];  // each warp's rows' last slot
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gr = lane / 4;
  const int gc = lane % 4;
  const int grp = warp / 2;
  const int uh = warp % 2;
  const int H = p.H;
  const int nu = RES ? kResidentUnits : fl.nu;
  const int nkx = fl.nkx;
  const int half0 = (nu + 1) / 2;
  const int u0 = uh ? half0 : 0;
  const int u1 = uh ? nu : half0;
  const int nch =
      RES ? 1 : max(1, (u1 - u0 + kChunkUnits - 1) / kChunkUnits);
  float* whs = smem;               // RES
  float* ring = smem + fl.stage;   // RES: [2][nu][2][32][4]
  float* su = smem + fl.u;
  float* sb = smem + fl.bias;
  float* hbuf = smem + fl.state + grp * fl.per_group;  // [1 or 2][nu][32][4]
  float* xb = hbuf + (RES ? 1 : 2) * nu * 128;         // [nkx][32][4]
  float* cb = xb + nkx * 128;                          // [nu][32][4], !RES

  if (RES) {
    const float4* src = reinterpret_cast<const float4*>(p.whf);
    float4* dst = reinterpret_cast<float4*>(whs);
    for (int i = tid; i < nu * nu * 64; i += nt) dst[i] = __ldg(src + i);
  }
  if (KEYS)
    for (int i = tid; i < (p.ncol + 2) * p.h; i += nt) su[i] = p.u[i];
  for (int i = tid; i < nu * 32; i += nt) {
    const int n = i / 32, c = (i / 8) % 4, q = (i % 8) / 2, e = i % 2;
    const int j = 8 * n + 2 * c + e;
    sb[i] = j < H ? p.bh[q * H + j] : 0.f;
  }

  const int pos0 = (blockIdx.x * fl.groups + grp) * kWarpRows;
  int srow[2];
  bool live[2];
  int end = 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pos = pos0 + gr + 8 * i;
    live[i] = pos < p.rows;
    srow[i] = live[i] ? (p.order ? p.order[pos] : pos) : 0;
    if (live[i]) end = max(end, p.ends[srow[i]]);
  }
  end = __reduce_max_sync(0xffffffffu, end);
  const int fb = pos0 / kStashRows;
  const bool stash = STASH && fb < (p.rows + kStashRows - 1) / kStashRows;
  if (stash) {
    // the stash block's step count, its rows' last valid slot: every row
    // of the block is stashed that far (a block of 3 row groups holds
    // parts of two stash blocks)
    const int pos = fb * kStashRows + lane;
    const int e = pos < p.rows ? p.ends[p.order ? p.order[pos] : pos] : 0;
    const int tend = __reduce_max_sync(0xffffffffu, e);
    if (lane == 0 && uh == 0 && pos0 % kStashRows == 0) st.tend[fb] = tend;
    end = max(end, tend);
  }
  if (lane == 0) sends[warp] = end;
  __syncthreads();
  // the block's row groups step together (they share wi's ring, or its
  // lines in L2), to the block's last valid slot (in training, its stash
  // blocks'): a group past its rows' last slot leaves its carries as they
  // are
  int steps = 0;
  for (int w = 0; w < nt / 32; ++w) steps = max(steps, sends[w]);
  const int rs[2] = {(pos0 + gr) % kStashRows, (pos0 + gr + 8) % kStashRows};

  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 creg[RES ? kHalf : 1];
#pragma unroll
  for (int n = 0; n < (RES ? kHalf : 1); ++n) creg[n] = zero4;
  for (int n = u0; n < u1; ++n) {
    *lane4(hbuf, n, lane) = zero4;
    if (!RES) *lane4(cb, n, lane) = zero4;
  }
  SlotIn s = slot_in<KEYS, ROOT>(p, srow, live, 0);
  if (steps > 0) {
    put_x<KEYS, ROOT>(p, s, srow, live, 0, su, xb, nkx, uh, lane);
    if (RES) stage_wi(p.wif, 0, nu, ring, tid, nt);
  }
  copies_wait();
  __syncthreads();  // x of slot 0, h = 0 (and wi's first k-step) in place

  int cur = 0;  // !RES: the h buffer of this step
  int ks = 0;   // RES: wi's k-steps staged so far (the ring's position)
  for (int t = 0; t < steps; ++t) {
    SlotIn nx = s;
    if (t + 1 < steps) nx = slot_in<KEYS, ROOT>(p, srow, live, t + 1);
    float* hold = hbuf + (RES ? 0 : cur * nu * 128);
    float* hnew = RES ? hold : hbuf + (cur ^ 1) * nu * 128;
#pragma unroll 1
    for (int ch = 0; ch < nch; ++ch) {
      const int c0 = u0 + ch * NC;
      const int nc = RES ? NC : max(0, min(NC, u1 - c0));
      float acc[NC][4][4];  // [unit tile][gate][fragment]
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        if (n < nc) {
          const float* bn = sb + (c0 + n) * 32 + gc * 8;
          const float4 b01 = *reinterpret_cast<const float4*>(bn);
          const float4 b23 = *reinterpret_cast<const float4*>(bn + 4);
          const float bq[4][2] = {{b01.x, b01.y}, {b01.z, b01.w},
                                  {b23.x, b23.y}, {b23.z, b23.w}};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[n][q][0] = acc[n][q][2] = bq[q][0];
            acc[n][q][1] = acc[n][q][3] = bq[q][1];
          }
        }
      }
      if constexpr (RES) {
        // x_t wi, wi's k-steps through the ring: a k-step is multiplied
        // while the next one is copied in
        for (int kk = 0; kk < nkx; ++kk, ++ks) {
          copies_wait();
          __syncthreads();  // k-step ks in place; the other slot read
          if (kk + 1 < nkx || t + 1 < steps)
            stage_wi(p.wif, kk + 1 < nkx ? kk + 1 : 0, nu,
                     ring + ((ks + 1) & 1) * nu * 256, tid, nt);
          kstep<false, NC>(acc, xb + kk * 128,
                           ring + (ks & 1) * nu * 256 + c0 * 256, nc, lane);
        }
        const bool more = t + 1 < steps;
        if constexpr (KEYS) {
          // h wh, wh resident, then slot t + 1's hidden rows
          products<false, NC>(acc, hold, whs, nu, nu, c0, nc, lane);
          __syncthreads();  // every warp has read slot t's x and h
          if (more) form_x<ROOT>(p, nx, live, su, xb, nkx, uh, lane);
        } else {
          __syncthreads();  // every warp has read slot t's x
          // h wh, wh resident; slot t + 1's x copied in beside it, a
          // k-step at a time (the two warps alternate)
          for (int kk = 0; kk < nu; ++kk) {
            kstep<false, NC>(acc, hold + kk * 128,
                             whs + ((size_t)kk * nu + c0) * 256, nc, lane);
            if (more && kk < nkx && kk % 2 == uh)
              copy_x(p, srow, live, t + 1, xb, kk, lane);
          }
          for (int kk = nu + ((nu + uh) & 1); more && kk < nkx; kk += 2)
            copy_x(p, srow, live, t + 1, xb, kk, lane);
          __syncthreads();  // every warp has read slot t's h
        }
      } else {
        // x_t wi (wi from L2)
        products<true, NC>(acc, xb, p.wif, nkx, nu, c0, nc, lane);
        if (ch == nch - 1) {
          __syncthreads();  // every warp has read slot t's x
          if (t + 1 < steps)
            put_x<KEYS, ROOT>(p, nx, srow, live, t + 1, su, xb, nkx, uh,
                              lane);
        }
        // h wh (wh from L2)
        products<true, NC>(acc, hold, p.whf, nu, nu, c0, nc, lane);
      }
      // the cell of the chunk's (row, unit) pairs, a row at a time, its
      // stash written at once; the loop comes in two copies, with the
      // stores and without (a test inside it cost the training instance
      // 1.5-2 ms at the bench width on an H100)
      size_t so[2];  // the rows' offsets in the carry planes of the stash
#pragma unroll
      for (int i = 0; i < 2; ++i)
        so[i] = stash_at(fb, p.L, t, rs[i], kStashRows, H);
      // store: std::true_type to write the stash
      auto cells = [&](auto store) {
  #pragma unroll
        for (int n = 0; n < NC; ++n) {
          if (n < nc) {
            const int un = c0 + n;
            const int j0 = 8 * un + 2 * gc;
            const float4 hv = *lane4(hold, un, lane);
            const float4 cv = RES ? creg[RES ? n : 0] : *lane4(cb, un, lane);
            float cc[4] = {cv.x, cv.y, cv.z, cv.w};
            float hh[4] = {hv.x, hv.y, hv.z, hv.w};
  #pragma unroll
            for (int i = 0; i < 2; ++i) {
              Gates a[2] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
              if (s.valid[i]) {
  #pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int e4 = 2 * i + e;
                  a[e] = activate(acc[n][0][e4], acc[n][1][e4], acc[n][2][e4],
                                  acc[n][3][e4]);
                  cell(a[e], cc[e4], hh[e4]);
                }
              }
              if constexpr (decltype(store)::value) {
                float* g = st.gates + 4 * so[i];
                put2(g, j0, H, a[0].i, a[1].i);
                put2(g + H, j0, H, a[0].f, a[1].f);
                put2(g + 2 * H, j0, H, a[0].g, a[1].g);
                put2(g + 3 * H, j0, H, a[0].o, a[1].o);
                put2(st.cprev + so[i], j0, H, i ? cv.z : cv.x,
                     i ? cv.w : cv.y);
                put2(st.hprev + so[i], j0, H, i ? hv.z : hv.x,
                     i ? hv.w : hv.y);
              }
            }
            const float4 cn = make_float4(cc[0], cc[1], cc[2], cc[3]);
            if (RES)
              creg[RES ? n : 0] = cn;
            else
              *lane4(cb, un, lane) = cn;
            *lane4(hnew, un, lane) = make_float4(hh[0], hh[1], hh[2], hh[3]);
          }
        }
      };
      if (stash)
        cells(std::true_type{});
      else
        cells(std::false_type{});
    }
    if (!RES) {
      if (!KEYS) copies_wait();
      __syncthreads();  // h of step t + 1 and slot t + 1's x in place
      cur ^= 1;
    }
    // RES: the next step's first k-step barrier orders them
    s = nx;
  }
  float* hfin = hbuf + (RES ? 0 : cur * nu * 128);
  for (int n = u0; n < u1; ++n) {
    const float4 hv = *lane4(hfin, n, lane);
    const int j0 = 8 * n + 2 * gc;
    if (live[0]) put2(out + (size_t)srow[0] * H, j0, H, hv.x, hv.y);
    if (live[1]) put2(out + (size_t)srow[1] * H, j0, H, hv.z, hv.w);
  }
}

// The forward: the resident path where H has kResidentUnits unit tiles and
// its words fit, else the other, in blocks of fl.groups row groups.
template <bool KEYS, bool ROOT, bool STASH>
cudaError_t launch_forward(const FwdOperands& p, float* out, const Stash& st,
                           cudaStream_t stream) {
  const FwdLayout fl = fwd_layout_for(p.h, p.H, KEYS ? p.ncol : 0);
  if (fl.groups < 1) return cudaErrorInvalidValue;
  void (*kernel)(FwdOperands, FwdLayout, float*, Stash) =
      fl.resident ? &forward_kernel<KEYS, ROOT, STASH, true>
                  : &forward_kernel<KEYS, ROOT, STASH, false>;
  const size_t bytes = (size_t)fl.words * sizeof(float);
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const int rows = kWarpRows * fl.groups;
  kernel<<<(p.rows + rows - 1) / rows, 64 * fl.groups, bytes, stream>>>(
      p, fl, out, st);
  return cudaGetLastError();
}

}  // namespace lstm
