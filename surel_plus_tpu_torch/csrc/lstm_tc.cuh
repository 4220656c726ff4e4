// The LSTM's backward on the tensor cores, shared by K4 bwd
// (lstm_keys_bwd.cu, x from the keys) and K5 bwd (lstm_bwd.cu, x given).
// Both start from the stash that the training forward kept (`forward_kernel`
// with STASH, lstm_keys.cuh): every step's activated gates and entering
// carries (c, h), per stash block of rb = kStashRows rows, in the rows'
// processing order. Three kernels and a fixed-order reduction:
//
// 1. `sweep_kernel`, the reverse sweep. A warp owns 16 rows, a block 4
//    warps (64 rows; 128 blocks at R = 8192, one wave on 132 SMs). Per
//    step it forms dgates from the stash and dh_prev = dgates wh^T with
//    mma.sync.m16n8k8 in 3xTF32. Each lane forms the dgates of exactly the
//    (row, unit) pairs that its accumulator fragment holds (rows g, g + 8,
//    units 8n + 2c, 8n + 2c + 1), and the product's K axis is permuted
//    (k-step (q, n): gate q, units 8n .. 8n + 7) so that those dgates ARE
//    the lane's A fragment, as FlashAttention-2 reuses P: no exchange, no
//    barrier inside the loop, each warp runs to its own rows' last valid
//    slot. wh stays resident in shared memory (gate-padded, 150,528 bytes
//    at H = 96) and B is split into its big and small TF32 parts in
//    registers (both parts would take 294 KB). dh and dc live in shared
//    memory, each element read and written only by the lane that owns it;
//    H <= 96 takes one accumulator chunk of 12 n-tiles, wider H several
//    (the later chunks read the dgates back from the stash, the lane's own
//    writes). The step's stash rows are prefetched into L2 one step ahead
//    and into registers one k-group ahead: a ring in shared memory would
//    need the step's 120 KB of stash rows beside wh. The dgates are
//    written over the stashed gates (masked slots keep their stashed 0).
// 2. `dx_kernel`: dx = dgates wi^T per (stash block, step) slab, off the
//    serial chain, wi resident in shared memory; K5 writes dx (0 at masked
//    slots and past a block's last valid slot), K4 sends it back through
//    each side's relu into dU in its epilogue (the fields recomputed from
//    the keys), one partial per warp stream.
// 3. `weights_kernel`: [dwi; dwh] = sum over valid (row, slot) of
//    [x; h_prev] dgates^T, 64 x 128 output tiles over the slabs in P fixed
//    parts (x read from the rows, or recomputed from the keys once per
//    slab), and dbh = the slabs' column sums.
// 4. `reduce_kernel` adds the partials in a fixed order: no float atomics,
//    so two launches give the same bits.
//
// 3xTF32: a b = a_big b_big + a_big b_small + a_small b_big, with x_big
// = x truncated to TF32 (the low 13 of its 23 mantissa bits cleared) and
// x_small = x - x_big, which the tensor core truncates to TF32 as it reads
// it; products accumulate in fp32, the small terms first. A single TF32
// product misses the 1e-4 tolerance by 1.5-3.4x at the bench width; the
// split is as accurate as fp32 (tests/test_torch_port_lstm_tc.py emulates
// both).

#pragma once

#include "lstm_keys.cuh"

namespace lstm {

constexpr int kSweepWarps = 4;                // warps of a sweep block
constexpr int kSweepRows = 16 * kSweepWarps;  // rows of a sweep block
constexpr int kChunkTiles = 12;  // n-tiles (8 columns) an accumulator holds
constexpr int kDxTiles = 3;      // n-tiles of dx a dx warp holds
constexpr int kDxWarps = 16;     // a dx block's target warp count
constexpr int kDxBlocks = 132;   // dx blocks (fixed: it fixes dU's bits)
constexpr int kWM = 64;          // weight-gradient tile: rows of [wi; wh]
constexpr int kWN = 128;         // and columns (gates)
constexpr int kWThreads = 256;   // 8 warps, 32 x 32 outputs each
constexpr int kReduceThreads = 256;

// A weight matrix W [n][4H] in shared memory, gate-padded: row n holds
// W[n][q H + j] at q hp + j (hp = H rounded up to 8, zero for j >= H), rows
// rounded up to 8 with zeros; the row stride is 8 words past a multiple of
// 32, so the float2 reads of a B fragment hit distinct banks.
struct Padded {
  int hp, ld, rows;  // gate stride, row stride, rows (words = rows * ld)
};

__host__ __device__ inline Padded padded_for(int n, int H) {
  Padded w;
  w.hp = round_up(H, 8);
  w.ld = round_up(4 * w.hp, 32) + 8;
  w.rows = round_up(n, 8);
  return w;
}

__device__ inline void copy_padded(float* dst, const float* __restrict__ w,
                                   int n, int H, const Padded& pw, int tid,
                                   int nt) {
  const int cols = 4 * pw.hp;
  for (int i = tid; i < pw.rows * cols; i += nt) {
    const int r = i / cols;
    const int c = i - r * cols;
    const int q = c / pw.hp;
    const int j = c - q * pw.hp;
    dst[r * pw.ld + c] =
        r < n && j < H ? __ldg(w + (size_t)r * 4 * H + q * H + j) : 0.f;
  }
}

// B fragment of k-step (gate q, units j .. j + 1 of the lane) for column n:
// W[n][q H + j], W[n][q H + j + 1], from the padded copy in shared memory
// (SMEM) or from device memory.
template <bool SMEM>
__device__ __forceinline__ void b_pair(const float* ws,
                                       const float* __restrict__ w,
                                       const Padded& pw, int n, int nrows,
                                       int H, int q, int j, Split& b0,
                                       Split& b1) {
  float v0, v1;
  if (SMEM) {
    const float2 v = n < pw.rows ? *reinterpret_cast<const float2*>(
                                       ws + n * pw.ld + q * pw.hp + j)
                                 : make_float2(0.f, 0.f);
    v0 = v.x;
    v1 = v.y;
  } else {
    const float* r = w + (size_t)n * 4 * H + q * H + j;
    v0 = n < nrows && j < H ? __ldg(r) : 0.f;
    v1 = n < nrows && j + 1 < H ? __ldg(r + 1) : 0.f;
  }
  b0 = split(v0);
  b1 = split(v1);
}

// ------------------------------------------------------------- the sweep

// A lane's two rows: processing position, row of x / g, stash block, row
// in it, the block's step count; `live` where a stash row exists.
struct LaneRows {
  int srow[2], fb[2], r[2], tend[2];
  bool live[2];
};

__device__ inline LaneRows lane_rows(const Operands& p, const Stash& st,
                                     int rb, int pos0) {
  LaneRows lr;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pos = pos0 + 8 * i;
    lr.live[i] = pos < p.rows;
    lr.fb[i] = pos / rb;
    lr.r[i] = pos - lr.fb[i] * rb;
    lr.srow[i] = lr.live[i] ? (p.order ? p.order[pos] : pos) : -1;
    lr.tend[i] = lr.live[i] ? st.tend[lr.fb[i]] : 0;
  }
  return lr;
}

// The stash values of k-group n for the lane's rows: the four activated
// gates and c_prev of units j0, j0 + 1 (j0 = 8 n + 2 (lane % 4)), from the
// rows' gate and carry planes of the step (ga, ca).
struct Group {
  float g[4][2][2];  // [gate][row][unit]
  float c[2][2];
};

__device__ __forceinline__ void load_group(Group& v, float* const (&ga)[2],
                                           const float* const (&ca)[2],
                                           const bool (&keep)[2], int H,
                                           int j0) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool on = keep[i] && j0 + e < H;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v.g[q][i][e] = on ? ga[i][q * H + j0 + e] : 0.f;
      v.c[i][e] = on ? ca[i][j0 + e] : 0.f;
    }
}

// Block b's rows are processing positions 64 b .. 64 b + 63; warp w's are
// 16 w .. 16 w + 15 of them, lane (g, c) holding rows g and g + 8 and
// units 8 n + 2 c, 8 n + 2 c + 1 of every n-tile n. Shared memory: the
// padded wh (WHS), then dh and dc [64][ls]. HC: H as a compile-time
// constant (96, the bench width: every offset an immediate), or 0.
template <int HC, bool WHS>
__global__ void __launch_bounds__(32 * kSweepWarps)
sweep_kernel(Operands p, int rb, Stash st, const float* g, Padded pwr,
             int lsr) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gr = lane / 4;
  const int gc = lane % 4;
  const int H = HC ? HC : p.H;
  const Padded pw = HC ? padded_for(HC, HC) : pwr;
  const int ls = HC ? round_up(round_up(HC, 8), 32) + 8 : lsr;
  const int ntk = pw.hp / 8;  // k-groups, and n-tiles of dh
  float* whs = smem;
  float* sdh = smem + (WHS ? pw.rows * pw.ld : 0) + warp * 16 * ls;
  float* sdc = sdh + kSweepRows * ls;
  if (WHS) copy_padded(whs, p.wh, H, H, pw, tid, blockDim.x);

  const LaneRows lr =
      lane_rows(p, st, rb, blockIdx.x * kSweepRows + warp * 16 + gr);
  for (int n = 0; n < ntk; ++n) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 8 * n + 2 * gc + e;
        const int a = (gr + 8 * i) * ls + j;
        sdh[a] = lr.live[i] && j < H ? g[(size_t)lr.srow[i] * H + j] : 0.f;
        sdc[a] = 0.f;
      }
  }
  __syncthreads();  // wh is in shared memory
  const int steps = __reduce_max_sync(0xffffffffu,
                                      max(lr.tend[0], lr.tend[1]));

  // which of the lane's rows step t moves, and their stash rows: read a
  // step ahead
  auto rows_at = [&](int t, bool (&keep)[2], float* (&ga)[2],
                     const float* (&ca)[2]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      keep[i] = t >= 0 && lr.live[i] && t < lr.tend[i] &&
                p.mask[(size_t)lr.srow[i] * p.L + t] != 0;
      const int tt = t >= 0 ? t : 0;
      ga[i] = st.gates + stash_at(lr.fb[i], p.L, tt, lr.r[i], rb, 4 * H);
      ca[i] = st.cprev + stash_at(lr.fb[i], p.L, tt, lr.r[i], rb, H);
    }
  };
  bool keep[2];
  float* ga[2];
  const float* ca[2];
  rows_at(steps - 1, keep, ga, ca);
  Group nxt;  // the stash values of the next k-group, a group ahead
  load_group(nxt, ga, ca, keep, H, 2 * gc);
  const float* wb = whs + gr * pw.ld + 2 * gc;  // the lane's B row, unit
  for (int t = steps - 1; t >= 0; --t) {
    bool keep_next[2];
    float* ga_next[2];
    const float* ca_next[2];
    rows_at(t - 1, keep_next, ga_next, ca_next);
    // the next step's stash rows into L2 (12 + 3 lines a row at H = 96)
    if (t > 0) {
      const int lg = (4 * H * 4 + 127) / 128;
      const int lc = (H * 4 + 127) / 128;
      for (int k = lane; k < 16 * (lg + lc); k += 32) {
        const int row = k / (lg + lc);
        const int line = k - row * (lg + lc);
        const int pos = blockIdx.x * kSweepRows + warp * 16 + row;
        if (pos >= p.rows) continue;
        const int fb = pos / rb;
        const int r = pos - fb * rb;
        const char* a =
            line < lg
                ? reinterpret_cast<const char*>(
                      st.gates + stash_at(fb, p.L, t - 1, r, rb, 4 * H)) +
                      128 * line
                : reinterpret_cast<const char*>(
                      st.cprev + stash_at(fb, p.L, t - 1, r, rb, H)) +
                      128 * (line - lg);
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(a));
      }
    }
    for (int c0 = 0; c0 < ntk; c0 += kChunkTiles) {
      const int nc = min(kChunkTiles, ntk - c0);
      float acc[kChunkTiles][4];
#pragma unroll
      for (int n = 0; n < kChunkTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
      for (int kg = 0; kg < ntk; ++kg) {
        const int j0 = 8 * kg + 2 * gc;
        float d[4][2][2];  // dgates [gate][row][unit]
        if (c0 == 0) {
          const Group cur = nxt;
          if (kg + 1 < ntk)
            load_group(nxt, ga, ca, keep, H, j0 + 8);
          else if (t > 0)
            load_group(nxt, ga_next, ca_next, keep_next, H, 2 * gc);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int a = (gr + 8 * i) * ls + j0;
            const float2 dh2 = *reinterpret_cast<const float2*>(sdh + a);
            float2 dc2 = *reinterpret_cast<const float2*>(sdc + a);
            const float dh[2] = {dh2.x, dh2.y};
            float dc[2] = {dc2.x, dc2.y};
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float gi = cur.g[0][i][e], gf = cur.g[1][i][e];
              const float gg = cur.g[2][i][e], go = cur.g[3][i][e];
              const float cp = cur.c[i][e];
              const bool on = keep[i] && j0 + e < H;
              // the forward's c, from its stashed inputs
              const float tc = tanhf(fmaf(gf, cp, gi * gg));
              const float dnc = dc[e] + dh[e] * go * (1.f - tc * tc);
              d[0][i][e] = on ? dnc * gg * gi * (1.f - gi) : 0.f;
              d[1][i][e] = on ? dnc * cp * gf * (1.f - gf) : 0.f;
              d[2][i][e] = on ? dnc * gi * (1.f - gg * gg) : 0.f;
              d[3][i][e] = on ? dh[e] * tc * go * (1.f - go) : 0.f;
              if (on) dc[e] = dnc * gf;
            }
            if (keep[i]) {
              dc2.x = dc[0];
              dc2.y = dc[1];
              *reinterpret_cast<float2*>(sdc + a) = dc2;
#pragma unroll
              for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int e = 0; e < 2; ++e)
                  if (j0 + e < H) ga[i][q * H + j0 + e] = d[q][i][e];
            }
          }
        } else {  // the dgates this lane wrote in the first chunk
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                d[q][i][e] =
                    keep[i] && j0 + e < H ? ga[i][q * H + j0 + e] : 0.f;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const Split a[4] = {split(d[q][0][0]), split(d[q][1][0]),
                              split(d[q][0][1]), split(d[q][1][1])};
          Split b0[kChunkTiles], b1[kChunkTiles];
          const float* wq = wb + 8 * c0 * pw.ld + q * pw.hp + 8 * kg;
#pragma unroll
          for (int n = 0; n < kChunkTiles; ++n) {
            if (n < nc) {
              if (WHS) {
                const float2 v =
                    *reinterpret_cast<const float2*>(wq + 8 * n * pw.ld);
                b0[n] = split(v.x);
                b1[n] = split(v.y);
              } else {
                b_pair<false>(whs, p.wh, pw, 8 * (c0 + n) + gr, H, H, q, j0,
                              b0[n], b1[n]);
              }
            }
          }
          mma3(acc, a, b0, b1, nc);
        }
      }
      // dh_prev where the slot is valid, else dh passes on
#pragma unroll
      for (int n = 0; n < kChunkTiles; ++n) {
        if (n < nc) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (keep[i])
              *reinterpret_cast<float2*>(
                  sdh + (gr + 8 * i) * ls + 8 * (c0 + n) + 2 * gc) =
                  make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      keep[i] = keep_next[i];
      ga[i] = ga_next[i];
      ca[i] = ca_next[i];
    }
  }
}

// ---------------------------------------------------------------- dx, dU

// A dx warp's place: `ng` n-tile groups of kDxTiles cover x's h channels;
// a block runs `streams` warp streams of ng warps, warp w taking group
// w % ng of stream w / ng, over the tasks (stash block, step, 16-row
// tile) stream, stream + all streams, ...
struct DxLayout {
  int ng, streams, warps;
};

__host__ __device__ inline DxLayout dx_layout_for(int h) {
  DxLayout d;
  d.ng = ((h + 7) / 8 + kDxTiles - 1) / kDxTiles;
  d.streams = d.ng < kDxWarps ? kDxWarps / d.ng : 1;
  d.warps = d.ng * d.streams;
  return d;
}

// The A fragment values of k-group kg, gate q for the lane's rows: the
// dgates of units j0, j0 + 1 at a row where `keep`, else 0.
__device__ __forceinline__ void load_dgates(float (&d)[4][2][2],
                                            const Stash& st, int fb, int L,
                                            int t, const int (&r)[2],
                                            const bool (&keep)[2], int rb,
                                            int H, int j0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float* ga = st.gates + stash_at(fb, L, t, keep[i] ? r[i] : 0, rb,
                                          4 * H);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        d[q][i][e] = keep[i] && j0 + e < H ? ga[q * H + j0 + e] : 0.f;
  }
}

// dx = dgates wi^T over the slabs (stash block fb, step t) of rb rows.
// NCOL = kXRows: dx written for every (row, slot) of x's rows, 0 where the
// slot is masked or past the block's last valid slot. Else dx goes back
// through each side's relu: dU rows of the fields and b1's row, one
// partial [ncol + 2][h] per warp stream (the masking row 0). Shared
// memory: the padded wi (WIS), then U.
template <int NCOL, bool ROOT, bool WIS>
__global__ void __launch_bounds__(32 * kDxWarps, 1)
dx_kernel(Operands p, int rb, Stash st, Padded pw, DxLayout dl, float* dx,
          float* part) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gr = lane / 4;
  const int gc = lane % 4;
  const int h = p.h;
  const int H = p.H;
  const int ntk = pw.hp / 8;
  float* wis = smem;
  float* su = smem + (WIS ? pw.rows * pw.ld : 0);
  if (WIS) copy_padded(wis, p.wi, h, H, pw, tid, blockDim.x);
  if constexpr (NCOL != kXRows)
    for (int i = tid; i < (NCOL + 2) * h; i += blockDim.x) su[i] = p.u[i];
  __syncthreads();

  const int grp = warp % dl.ng;
  const int stream = blockIdx.x * dl.streams + warp / dl.ng;
  const int nstreams = gridDim.x * dl.streams;
  const int mt = (rb + 15) / 16;
  const int blocks = (p.rows + rb - 1) / rb;
  constexpr int NU = NCOL == kXRows ? 1 : NCOL + 1;
  float acc_u[kDxTiles][2][NU];  // dU rows 0..ncol-1 and b1's, per channel
#pragma unroll
  for (int n = 0; n < kDxTiles; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int c = 0; c < NU; ++c) acc_u[n][e][c] = 0.f;

  for (int task = stream; task < blocks * p.L * mt; task += nstreams) {
    const int fb = task / (p.L * mt);
    const int t = (task / mt) % p.L;
    const int m0 = (task % mt) * 16;
    const int tend = st.tend[fb];
    int r[2], srow[2];
    bool keep[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      r[i] = m0 + gr + 8 * i;
      const int pos = fb * rb + r[i];
      srow[i] = r[i] < rb && pos < p.rows
                    ? (p.order ? p.order[pos] : pos) : -1;
      keep[i] = srow[i] >= 0 && t < tend &&
                p.mask[(size_t)srow[i] * p.L + t] != 0;
    }
    float acc[kDxTiles][4];
#pragma unroll
    for (int n = 0; n < kDxTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    if (t < tend) {  // the same for the whole warp
      float nxt[4][2][2];
      load_dgates(nxt, st, fb, p.L, t, r, keep, rb, H, 2 * gc);
      for (int kg = 0; kg < ntk; ++kg) {
        const int j0 = 8 * kg + 2 * gc;
        float d[4][2][2];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) d[q][i][e] = nxt[q][i][e];
        if (kg + 1 < ntk)
          load_dgates(nxt, st, fb, p.L, t, r, keep, rb, H, j0 + 8);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const Split a[4] = {split(d[q][0][0]), split(d[q][1][0]),
                              split(d[q][0][1]), split(d[q][1][1])};
          Split b0[kDxTiles], b1[kDxTiles];
#pragma unroll
          for (int n = 0; n < kDxTiles; ++n)
            b_pair<WIS>(wis, p.wi, pw, 8 * (grp * kDxTiles + n) + gr, h, H,
                        q, j0, b0[n], b1[n]);
          mma3(acc, a, b0, b1);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (srow[i] < 0) continue;
      if constexpr (NCOL == kXRows) {
        float* row = dx + ((size_t)srow[i] * p.L + t) * h;
#pragma unroll
        for (int n = 0; n < kDxTiles; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = 8 * (grp * kDxTiles + n) + 2 * gc + e;
            if (k < h) row[k] = keep[i] ? acc[n][2 * i + e] : 0.f;
          }
      } else {
        if (!keep[i]) continue;
        const size_t off = (size_t)srow[i] * p.L + t;
        float fo[NCOL], fc[NCOL];
        fields<NCOL, ROOT>(p.kown[off], ROOT ? p.rown[off] : 0, p.shift, fo);
        fields<NCOL, ROOT>(p.kcross[off], ROOT ? p.rcross[off] : 0, p.shift,
                           fc);
#pragma unroll
        for (int n = 0; n < kDxTiles; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = 8 * (grp * kDxTiles + n) + 2 * gc + e;
            if (k >= h) continue;
            const float v = acc[n][2 * i + e];
            const float dzo = side_z(fo, su, h, k) > 0.f ? v : 0.f;
            const float dzc = side_z(fc, su, h, k) > 0.f ? v : 0.f;
#pragma unroll
            for (int c = 0; c < NCOL; ++c) {
              acc_u[n][e][c] = fmaf(fo[c], dzo, acc_u[n][e][c]);
              acc_u[n][e][c] = fmaf(fc[c], dzc, acc_u[n][e][c]);
            }
            acc_u[n][e][NCOL] += dzo;
            acc_u[n][e][NCOL] += dzc;
          }
      }
    }
  }
  if constexpr (NCOL != kXRows) {
    // add the 8 lanes of each channel pair in a fixed tree; lanes 0..3
    // write the stream's partial of their channels
    float* pp = part + (size_t)stream * (NCOL + 2) * h;
#pragma unroll
    for (int n = 0; n < kDxTiles; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 8 * (grp * kDxTiles + n) + 2 * gc + e;
#pragma unroll
        for (int c = 0; c < NU; ++c) {
          float v = acc_u[n][e][c];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (gr == 0 && k < h) pp[(c == NCOL ? NCOL + 1 : c) * h + k] = v;
        }
        if (gr == 0 && k < h) pp[NCOL * h + k] = 0.f;
      }
  }
}

// ------------------------------------------------------ dwi, dwh and dbh

// Part blockIdx.y of [dbh | dwi | dwh] over output tile blockIdx.x of
// [x; h_prev]^T dgates ([h + H][4H] in kWM x kWN tiles): the sum over the
// part's slabs (stash block, step), slab s = part, part + P, ... and the
// slabs' column sums of dgates for dbh (the blocks of the first tile row).
// The part's next slab with a valid step after slab s (or past the end).
__device__ __forceinline__ int next_slab(const Stash& st, int s, int P,
                                         int L, int total) {
  for (s += P; s < total; s += P)
    if (s % L < st.tend[s / L]) break;
  return s;
}

// A slab row's meta data, loaded a slab ahead: its row of x and its keys.
struct SlabRow {
  int row;
  uint32_t ko, kc;
  int32_t ro, rc;
};

template <int NCOL, bool ROOT>
__device__ __forceinline__ SlabRow slab_row(const Operands& p, int rb,
                                            int s, int r, int total) {
  SlabRow m{-1, 0u, 0u, 0, 0};
  if (s >= total) return m;
  const int fb = s / p.L;
  const int pos = fb * rb + r;
  if (pos >= p.rows) return m;
  m.row = p.order ? p.order[pos] : pos;
  if constexpr (NCOL != kXRows) {
    const size_t off = (size_t)m.row * p.L + (s - fb * p.L);
    m.ko = p.kown[off];
    m.kc = p.kcross[off];
    if (ROOT) {
      m.ro = p.rown[off];
      m.rc = p.rcross[off];
    }
  }
  return m;
}

// Part blockIdx.y of [dbh | dwi | dwh] over output tile blockIdx.x of
// [x; h_prev]^T dgates ([h + H][4H] in kWM x kWN tiles): the sum over the
// part's slabs (stash block, step), slab s = part, part + P, ... with a
// valid step, and the slabs' column sums of dgates for dbh (the blocks of
// the first tile row). A slab's tiles are loaded while the previous
// slab's products run, its rows and keys a slab earlier still.
template <int NCOL, bool ROOT>
__global__ void __launch_bounds__(kWThreads, 2)
weights_kernel(Operands p, int rb, Stash st, float* part) {
  constexpr int NF = NCOL == kXRows ? 1 : NCOL;
  constexpr int kR = kStashRows;  // slab rows
  constexpr int kAE = kR * kWM / kWThreads;  // A elements a thread stages
  constexpr int kBE = kR * kWN / kWThreads;
  __shared__ __align__(16) float as[kR][kWM + 8];  // [k][m]
  __shared__ __align__(16) float bs[kR][kWN + 8];  // [k][n]
  __shared__ float sfo[2][kR][NF], sfc[2][kR][NF];
  __shared__ int srow[2][kR];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gr = lane / 4;
  const int gc = lane % 4;
  const int h = p.h;
  const int H = p.H;
  const int M = h + H;
  const int N = 4 * H;
  const int ntn = (N + kWN - 1) / kWN;
  const int m0 = (blockIdx.x / ntn) * kWM;
  const int n0 = (blockIdx.x % ntn) * kWN;
  const int wm = (warp % 2) * 32;  // the warp's 32 x 32 outputs
  const int wn = (warp / 2) * 32;
  const int P = gridDim.y;
  const int total = ((p.rows + rb - 1) / rb) * p.L;
  float acc[2][4][4];  // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][b][e] = 0.f;
  float acc_b = 0.f;  // dbh of column n0 + tid (tid < kWN, first tile row)

  // slab s's rows (and fields) into buffer b of srow (sfo, sfc)
  auto put_meta = [&](const SlabRow& meta, int b) {
    if (tid < rb) {
      srow[b][tid] = meta.row;
      if constexpr (NCOL != kXRows) {
        float fo[NCOL], fc[NCOL];
        fields<NCOL, ROOT>(meta.ko, meta.ro, p.shift, fo);
        fields<NCOL, ROOT>(meta.kc, meta.rc, p.shift, fc);
#pragma unroll
        for (int c = 0; c < NCOL; ++c) {
          sfo[b][tid][c] = meta.row >= 0 ? fo[c] : 0.f;
          sfc[b][tid][c] = meta.row >= 0 ? fc[c] : 0.f;
        }
      }
    }
  };
  // slab s's A and B elements of this thread, from buffer b's rows; the
  // thread's A channel is m0 + tid % kWM for every element, so its column
  // of U lives in registers
  static_assert(kWThreads % kWM == 0, "one A channel a thread");
  float uc[NCOL == kXRows ? 1 : NCOL + 2];
  if constexpr (NCOL != kXRows) {
    const int m = m0 + tid % kWM;
#pragma unroll
    for (int c = 0; c < NCOL + 2; ++c) uc[c] = m < h ? p.u[c * h + m] : 0.f;
  }
  float va[kAE], vb[kBE];
  auto load_tiles = [&](int s, int b) {
    const int fb = s / p.L;
    const int t = s - fb * p.L;
    const float* hb = st.hprev + stash_at(fb, p.L, t, 0, rb, H);
    const float* gb = st.gates + stash_at(fb, p.L, t, 0, rb, N);
    const int m = m0 + tid % kWM;  // the thread's A channel
#pragma unroll
    for (int u = 0; u < kAE; ++u) {
      const int r = tid / kWM + u * (kWThreads / kWM);
      const int row = r < rb ? srow[b][r] : -1;
      va[u] = 0.f;
      if (row >= 0 && m < h) {
        if constexpr (NCOL == kXRows) {
          va[u] = p.x[((size_t)row * p.L + t) * h + m];
        } else {
          // hidden(): relu(b1 + fo . U[:, m]) + relu(b1 + fc . U[:, m])
          float zo = uc[NCOL + 1], zc = uc[NCOL + 1];
#pragma unroll
          for (int c = 0; c < NCOL; ++c) {
            zo = fmaf(sfo[b][r][c], uc[c], zo);
            zc = fmaf(sfc[b][r][c], uc[c], zc);
          }
          va[u] = fmaxf(zo, 0.f) + fmaxf(zc, 0.f);
        }
      } else if (row >= 0 && m < M) {
        va[u] = hb[r * H + (m - h)];
      }
    }
    const int n = n0 + tid % kWN;
#pragma unroll
    for (int u = 0; u < kBE; ++u) {
      const int r = tid / kWN + u * (kWThreads / kWN);
      vb[u] = r < rb && n < N ? gb[r * N + n] : 0.f;
    }
  };

  // a two-stage pipeline: slab s's tiles are multiplied while the next
  // slab's are loaded
  const int rt = tid < rb ? tid : 0;  // the slab row whose meta it loads
  int s = blockIdx.y;
  if (s < total && s % p.L >= st.tend[s / p.L])
    s = next_slab(st, s, P, p.L, total);
  int s1 = next_slab(st, s, P, p.L, total);
  int buf = 0;
  put_meta(slab_row<NCOL, ROOT>(p, rb, s, rt, total), buf);
  SlabRow m1 = slab_row<NCOL, ROOT>(p, rb, s1, rt, total);
  __syncthreads();  // the first rows are in shared memory
  if (s < total) load_tiles(s, buf);
  while (s < total) {
#pragma unroll
    for (int u = 0; u < kAE; ++u)
      as[tid / kWM + u * (kWThreads / kWM)][tid % kWM] = va[u];
#pragma unroll
    for (int u = 0; u < kBE; ++u)
      bs[tid / kWN + u * (kWThreads / kWN)][tid % kWN] = vb[u];
    put_meta(m1, buf ^ 1);
    const int s2 = next_slab(st, s1, P, p.L, total);
    m1 = slab_row<NCOL, ROOT>(p, rb, s2, rt, total);  // two slabs ahead
    __syncthreads();  // the tiles of s and the rows of s1 are in place
    if (s1 < total) load_tiles(s1, buf ^ 1);
    if (m0 == 0 && tid < kWN)
      for (int r = 0; r < rb; ++r) acc_b += bs[r][tid];
    // the slab's products in a fresh accumulator, added to the part's sum
    // in round-to-nearest fp32: accumulating the thousands of slabs of a
    // part in the tensor cores' accumulator drifted past 1e-4 on an H100
    // (dwh 1.2e-4 of its largest entry at L = 801, rows unsorted)
    float sl[2][4][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e) sl[a][b][e] = 0.f;
    for (int k0 = 0; k0 < rb; k0 += 8) {
      Split b0[4], b1[4];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn + 8 * ni + gr;
        b0[ni] = split(bs[k0 + gc][n]);
        b1[ni] = split(bs[k0 + gc + 4][n]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int m = wm + 16 * mi + gr;
        const Split a[4] = {split(as[k0 + gc][m]), split(as[k0 + gc][m + 8]),
                            split(as[k0 + gc + 4][m]),
                            split(as[k0 + gc + 4][m + 8])};
        mma3(sl[mi], a, b0, b1);
      }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][b][e] += sl[a][b][e];
    __syncthreads();  // the tiles of s are consumed
    s = s1;
    s1 = s2;
    buf ^= 1;
  }
  float* pp = part + (size_t)blockIdx.y * (N + M * N);
  if (m0 == 0 && tid < kWN && n0 + tid < N) pp[n0 + tid] = acc_b;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + 16 * mi + gr + 8 * (e / 2);
        const int n = n0 + wn + 8 * ni + 2 * gc + e % 2;
        if (m < M && n < N) pp[N + (size_t)m * N + n] = acc[mi][ni][e];
      }
}

// out[e] = part[0][e] + part[1][e] + ... + part[P-1][e], in that order.
__global__ void reduce_kernel(const float* part, float* out, int E, int P) {
  const int e = blockIdx.x * kReduceThreads + threadIdx.x;
  if (e >= E) return;
  float s = 0.f;
#pragma unroll 8
  for (int q = 0; q < P; ++q) s += part[(size_t)q * E + e];
  out[e] = s;
}

// ------------------------------------------------------------- launches

// Dynamic shared memory, in bytes, of the sweep (wh padded where it fits)
// and of the dx kernel (wi padded where it fits, and U for the keys).
inline size_t sweep_smem(int H, bool whs) {
  const Padded pw = padded_for(H, H);
  const int ls = round_up(pw.hp, 32) + 8;
  return ((whs ? (size_t)pw.rows * pw.ld : 0) + 2 * (size_t)kSweepRows * ls) *
         sizeof(float);
}

inline size_t dx_smem(int h, int H, int ncol, bool wis) {
  const Padded pw = padded_for(h, H);
  return ((wis ? (size_t)pw.rows * pw.ld : 0) +
          (ncol == kXRows ? 0 : (size_t)(ncol + 2) * h)) * sizeof(float);
}

// The backward after the training forward: sweep, dx (dU partials into
// part1 for the keys), weight gradients (partials into part2), then the
// reductions into out ([dU |] dbh | dwi | dwh).
template <int NCOL, bool ROOT>
cudaError_t launch_backward(const Operands& p, const Stash& st,
                            const float* g, float* dx, float* part1,
                            float* part2, float* out, int P,
                            cudaStream_t stream) {
  const int rb = kStashRows;
  cudaError_t err;
  {
    const Padded pw = padded_for(p.H, p.H);
    const int ls = round_up(pw.hp, 32) + 8;
    const bool whs = sweep_smem(p.H, true) <= (size_t)kMaxSmem;
    const size_t bytes = sweep_smem(p.H, whs);
    void (*kernel)(Operands, int, Stash, const float*, Padded, int) =
        !whs ? &sweep_kernel<0, false>
             : p.H == 96 ? &sweep_kernel<96, true> : &sweep_kernel<0, true>;
    if ((err = allow_smem(kernel, bytes)) != cudaSuccess) return err;
    const int blocks = (p.rows + kSweepRows - 1) / kSweepRows;
    kernel<<<blocks, 32 * kSweepWarps, bytes, stream>>>(p, rb, st, g, pw,
                                                         ls);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  {
    const Padded pw = padded_for(p.h, p.H);
    const DxLayout dl = dx_layout_for(p.h);
    const bool wis = dx_smem(p.h, p.H, NCOL, true) <= (size_t)kMaxSmem;
    const size_t bytes = dx_smem(p.h, p.H, NCOL, wis);
    void (*kernel)(Operands, int, Stash, Padded, DxLayout, float*, float*) =
        wis ? &dx_kernel<NCOL, ROOT, true> : &dx_kernel<NCOL, ROOT, false>;
    if ((err = allow_smem(kernel, bytes)) != cudaSuccess) return err;
    kernel<<<kDxBlocks, 32 * dl.warps, bytes, stream>>>(p, rb, st, pw, dl,
                                                        dx, part1);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const int M = p.h + p.H;
  const int N = 4 * p.H;
  const dim3 grid(((M + kWM - 1) / kWM) * ((N + kWN - 1) / kWN), P);
  weights_kernel<NCOL, ROOT><<<grid, kWThreads, 0, stream>>>(p, rb, st,
                                                             part2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  float* o = out;
  if constexpr (NCOL != kXRows) {
    const int e1 = (NCOL + 2) * p.h;
    reduce_kernel<<<(e1 + kReduceThreads - 1) / kReduceThreads,
                    kReduceThreads, 0, stream>>>(
        part1, o, e1, kDxBlocks * dx_layout_for(p.h).streams);
    o += e1;
  }
  const int e2 = N + M * N;
  reduce_kernel<<<(e2 + kReduceThreads - 1) / kReduceThreads,
                  kReduceThreads, 0, stream>>>(part2, o, e2, P);
  return cudaGetLastError();
}

// The stash's planes in one buffer of blocks * kStashRows * L * 6H floats:
// activated gates [.][4H], then c and h entering each step [.][H].
inline Stash stash_in(void* buf, void* tend, int rows, int L, int H) {
  const size_t plane =
      (size_t)((rows + kStashRows - 1) / kStashRows) * kStashRows * L;
  float* s = (float*)buf;
  return Stash{s, s + plane * 4 * H, s + plane * 5 * H, (int*)tend};
}

}  // namespace lstm
