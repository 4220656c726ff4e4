// Masked LSTM over given input rows, backward (K5 bwd): the gradient of the
// forward (lstm.cu, K5) with respect to x [R, L, h], wi [h, 4H], wh [H, 4H]
// and bh [4H], given the cotangent g = dL/dout [R, H]; the mask gets none.
// Per row, in reverse over the slots, from dh = g and dc = 0:
//
//   gi, gf, gg, go: the gates after their activations; c = gf c_prev + gi gg
//   dgo = dh tanh(c) go (1 - go);        dc~ = dc + dh go (1 - tanh(c)^2)
//   dgi = dc~ gg gi (1 - gi);  dgf = dc~ c_prev gf (1 - gf);
//   dgg = dc~ gi (1 - gg^2)
//   dgates = [dgi, dgf, dgg, dgo] where mask, else 0                  [4H]
//   dwi += x^T dgates;  dwh += h_prev^T dgates;  dbh += dgates
//   dx[r, l] = dgates wi^T                        (exactly 0 where masked)
//   dh_prev = dgates wh^T where mask, else dh
//   dc_prev = dc~ gf where mask, else dc
//
// Replaces the TPU kernel surel_plus_tpu/ops/pallas/lstm_kernel.py
// _lstm_bwd_kernel (launched by lstm_final_hidden's custom VJP). That kernel
// keeps chunk-boundary carries in VMEM and re-runs each chunk's forward
// before its reverse pass, for its small VMEM; it reads the mask from x's
// last lane. This one reads the mask plane and keeps the whole forward.
//
// Design: K4 bwd's three stages (lstm_keys_bwd.cu), with x given in place
// of the keys. One C entry point runs:
// 1. The forward again, K5's own step loop (`forward_kernel<kXRows, ...,
//    STASH>` in lstm_keys.cuh), so the gates are K5's bit for bit, over the
//    same blocks of rows in the same order (`row_order`, by last valid slot).
//    It stashes every step's activated gates and entering carries (c, h):
//    padded rows x L x 6H fp32, 5.7 GB at R = 8192, L = 301, H = 96.
// 2. The reverse sweep, with K5's block layout: one thread per hidden unit
//    j and 8 rows. It forms unit j's four dgates from the stash, writes them
//    over the stashed gates and into shared memory [4H][ld]; after a barrier
//    every unit forms dh_prev = dgates wh^T (wh^T in shared memory where it
//    fits) and input channels j, j + hp, ... their dx = dgates wi^T (wi^T
//    through the read-only cache), written to each row's own position, and
//    keeps its four dbh entries in registers. Slots at or past a block's
//    last valid slot get dx = 0 written at the start.
// 3. The weight gradients [dwi; dwh] = sum over (row, slot) of
//    [x; h_prev] dgates^T: a tiled fp32 product, 64 x 128 output tiles of
//    [h + H, 4H], its K axis the (block, step) tiles of rb rows (x read from
//    device memory, h_prev and dgates from the stash); tiles past a block's
//    last valid slot are skipped. P parts of the tiles give P partial sums.
// 4. A pass adds the partials of each output entry (per block and row group
//    for dbh, per part for dwi and dwh) in a fixed order: no float atomics,
//    so two launches give the same bits.
//
// Bound on the H100: operations. Per valid (row, slot): the recomputed
// gates 4H (h + H) multiply-adds, dh_prev and dx 4H (H + h), the weight
// gradients 4H (h + H), three times K5's product (some 6.4 ms on the fp32
// CUDA cores at R = 8192, L = 301, h = H = 96, 39% of the slots valid),
// against x and dx (1.9 GB) and the stash written and read back (about
// 11 GB, some 3.4 ms at 3.35 TB/s). chip_smoke.py counts the bound from its
// inputs.

#include "lstm_keys.cuh"

namespace {

using namespace lstm;

constexpr int kBM = 64;            // weight-gradient tile: rows of [wi; wh]
constexpr int kBN = 128;           // and columns (gates)
constexpr int kWThreads = 256;     // 8 x 32 threads, 8 x 4 outputs each
constexpr int kReduceThreads = 256;

// Dynamic shared memory of the reverse sweep, in 4-byte words: dgates
// [4H][ld], and wh^T [4H][H] where it fits (H = 96: 202,752 bytes).
struct RevSmem {
  int dg, wh, words;
};

inline RevSmem rev_smem_for(const Layout& l, int H, bool wh_smem) {
  RevSmem s;
  s.dg = 0;
  s.wh = 4 * H * l.ld;
  s.words = s.wh + (wh_smem ? 4 * H * H : 0);
  return s;
}

// sx[i] += sum over m < 4H of dgates[m][r0 + i] wiT[m][k]: input channel k
// of dx for the thread's kRows rows.
__device__ __forceinline__ void dx_sum(float (&sx)[kRows], const float* dgs,
                                       const float* __restrict__ wiT, int H4,
                                       int h, int ld, int k, int r0) {
#pragma unroll 4
  for (int m = 0; m < H4; ++m) {
    const float w = __ldg(wiT + (size_t)m * h + k);
    const float4* v = reinterpret_cast<const float4*>(dgs + m * ld + r0);
#pragma unroll
    for (int i4 = 0; i4 < kRows / 4; ++i4) {
      const float4 d4 = v[i4];
      sx[4 * i4 + 0] = fmaf(d4.x, w, sx[4 * i4 + 0]);
      sx[4 * i4 + 1] = fmaf(d4.y, w, sx[4 * i4 + 1]);
      sx[4 * i4 + 2] = fmaf(d4.z, w, sx[4 * i4 + 2]);
      sx[4 * i4 + 3] = fmaf(d4.w, w, sx[4 * i4 + 3]);
    }
  }
}

template <bool WHS>
__global__ void __launch_bounds__(kMaxThreads)
reverse_kernel(Operands p, Layout lay, RevSmem sm, Stash st, const float* g,
               const float* wiT, const float* whT, float* dx, float* part) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int srow[kMaxGroups * kRows];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int rb = lay.rb;
  const int ld = lay.ld;
  const int h = p.h;
  const int H = p.H;
  const int H4 = 4 * H;
  const int blk = blockIdx.x;
  const int base = blk * rb;
  const int nrows = min(rb, p.rows - base);
  float* dgs = smem + sm.dg;
  float* swh = smem + sm.wh;

  if (WHS)
    for (int i = tid; i < H4 * H; i += nt) swh[i] = __ldg(whT + i);
  if (tid < rb)
    srow[tid] = tid < nrows ? (p.order ? p.order[base + tid] : base + tid)
                            : -1;
  __syncthreads();

  // dx of the slots at and past the block's last valid slot: 0 (each row's
  // tail is contiguous in [R, L, h])
  const int tend = st.tend[blk];
  const size_t tail = (size_t)(p.L - tend) * h;
  for (int i = 0; i < nrows; ++i) {
    float* row = dx + ((size_t)srow[i] * p.L + tend) * h;
    for (size_t e = tid; e < tail; e += nt) row[e] = 0.f;
  }

  const int j = tid % lay.hp;
  const int grp = tid / lay.hp;
  const int r0 = grp * kRows;
  const bool on = j < H;   // hidden unit j
  const bool xon = j < h;  // input channel j
  float dh[kRows], dc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = srow[r0 + i];
    dh[i] = on && r >= 0 ? g[(size_t)r * H + j] : 0.f;
    dc[i] = 0.f;
  }
  float acc_bh[4] = {0.f, 0.f, 0.f, 0.f};

  for (int t = tend - 1; t >= 0; --t) {
    bool keep[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = srow[r0 + i];
      keep[i] = r >= 0 && p.mask[(size_t)r * p.L + t] != 0;
    }
    if (on) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        float* ga = st.gates + stash_at(blk, p.L, t, r0 + i, rb, H4) + j;
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        if (keep[i]) {
          const Gates a{ga[0], ga[H], ga[2 * H], ga[3 * H]};
          const float cp = st.cprev[stash_at(blk, p.L, t, r0 + i, rb, H) + j];
          const float tc = tanhf(fmaf(a.f, cp, a.i * a.g));  // the forward's c
          const float dnc = dc[i] + dh[i] * a.o * (1.f - tc * tc);
          d[0] = dnc * a.g * a.i * (1.f - a.i);
          d[1] = dnc * cp * a.f * (1.f - a.f);
          d[2] = dnc * a.i * (1.f - a.g * a.g);
          d[3] = dh[i] * tc * a.o * (1.f - a.o);
          dc[i] = dnc * a.f;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          ga[q * H] = d[q];
          dgs[(q * H + j) * ld + r0 + i] = d[q];
          acc_bh[q] += d[q];
        }
      }
    }
    __syncthreads();  // every unit's dgates are in shared memory
    // dh_prev = dgates wh^T for unit j, dx = dgates wi^T for channel j
    float sh[kRows], sx[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) sh[i] = sx[i] = 0.f;
#pragma unroll 4
    for (int m = 0; m < H4; ++m) {
      const float wh_m =
          on ? (WHS ? swh[m * H + j] : __ldg(whT + (size_t)m * H + j)) : 0.f;
      const float wi_m = xon ? __ldg(wiT + (size_t)m * h + j) : 0.f;
      const float4* v = reinterpret_cast<const float4*>(dgs + m * ld + r0);
#pragma unroll
      for (int i4 = 0; i4 < kRows / 4; ++i4) {
        const float4 d4 = v[i4];
        sh[4 * i4 + 0] = fmaf(d4.x, wh_m, sh[4 * i4 + 0]);
        sh[4 * i4 + 1] = fmaf(d4.y, wh_m, sh[4 * i4 + 1]);
        sh[4 * i4 + 2] = fmaf(d4.z, wh_m, sh[4 * i4 + 2]);
        sh[4 * i4 + 3] = fmaf(d4.w, wh_m, sh[4 * i4 + 3]);
        sx[4 * i4 + 0] = fmaf(d4.x, wi_m, sx[4 * i4 + 0]);
        sx[4 * i4 + 1] = fmaf(d4.y, wi_m, sx[4 * i4 + 1]);
        sx[4 * i4 + 2] = fmaf(d4.z, wi_m, sx[4 * i4 + 2]);
        sx[4 * i4 + 3] = fmaf(d4.w, wi_m, sx[4 * i4 + 3]);
      }
    }
    // channels j, j + hp, j + 2 hp, ... (more than one only when h > hp)
    for (int k = j; k < h; k += lay.hp) {
      if (k != j) {
#pragma unroll
        for (int i = 0; i < kRows; ++i) sx[i] = 0.f;
        dx_sum(sx, dgs, wiT, H4, h, ld, k, r0);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = srow[r0 + i];
        if (r >= 0) dx[((size_t)r * p.L + t) * h + k] = keep[i] ? sx[i] : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      if (keep[i]) dh[i] = sh[i];
    __syncthreads();  // the dgates are consumed
  }
  // this row group's partial of dbh
  if (on) {
    float* pp = part + (size_t)(blk * lay.groups + grp) * H4;
#pragma unroll
    for (int q = 0; q < 4; ++q) pp[q * H + j] = acc_bh[q];
  }
}

// Part blockIdx.z of [dwi; dwh] over the output tile (blockIdx.y,
// blockIdx.x): the sum over its (block, step) tiles of [x; h_prev] dgates^T.
__global__ void __launch_bounds__(kWThreads)
weights_kernel(Operands p, Layout lay, Stash st, float* part) {
  __shared__ __align__(16) float as[kMaxGroups * kRows][kBM];  // [r][m]
  __shared__ float bs[kMaxGroups * kRows][kBN];                // [r][n]
  __shared__ int srow[kMaxGroups * kRows];
  const int tid = threadIdx.x;
  const int rb = lay.rb;
  const int h = p.h;
  const int H = p.H;
  const int M = h + H;
  const int N = 4 * H;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int blocks = (p.rows + rb - 1) / rb;
  const int tm = tid / 32;  // rows m0 + 8 tm .. + 7 (one per warp)
  const int tn = tid % 32;  // columns n0 + tn + 32 c, c = 0..3
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  for (int tile = blockIdx.z; tile < blocks * p.L; tile += gridDim.z) {
    const int b = tile / p.L;
    const int t = tile - b * p.L;
    if (t >= st.tend[b]) continue;  // the same for every thread
    __syncthreads();  // the previous tile is consumed
    if (tid < rb) {
      const int r = b * rb + tid;
      srow[tid] = r < p.rows ? (p.order ? p.order[r] : r) : -1;
    }
    __syncthreads();
    for (int e = tid; e < rb * kBM; e += kWThreads) {
      const int r = e / kBM;
      const int ml = e - r * kBM;
      const int m = m0 + ml;
      const int row = srow[r];
      float v = 0.f;
      if (row >= 0 && m < h)
        v = p.x[((size_t)row * p.L + t) * h + m];
      else if (row >= 0 && m < M)
        v = st.hprev[stash_at(b, p.L, t, r, rb, H) + (m - h)];
      as[r][ml] = v;
    }
    for (int e = tid; e < rb * kBN; e += kWThreads) {
      const int r = e / kBN;
      const int nl = e - r * kBN;
      const int n = n0 + nl;
      bs[r][nl] = n < N ? st.gates[stash_at(b, p.L, t, r, rb, N) + n] : 0.f;
    }
    __syncthreads();
    for (int k = 0; k < rb; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[k][tm * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[k][tm * 8 + 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float bv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = bs[k][tn + 32 * c];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
    }
  }
  float* pp = part + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + tm * 8 + i;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + tn + 32 * c;
      if (n < N) pp[(size_t)m * N + n] = acc[i][c];
    }
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

cudaError_t launch_reverse(const Operands& p, const Layout& lay,
                           const Stash& st, const float* g, const float* wiT,
                           const float* whT, float* dx, float* part,
                           cudaStream_t stream) {
  const RevSmem with_wh = rev_smem_for(lay, p.H, true);
  const bool whs = (size_t)with_wh.words * sizeof(float) <= (size_t)kMaxSmem;
  const RevSmem sm = whs ? with_wh : rev_smem_for(lay, p.H, false);
  void (*kernel)(Operands, Layout, RevSmem, Stash, const float*,
                 const float*, const float*, float*, float*) =
      whs ? &reverse_kernel<true> : &reverse_kernel<false>;
  const size_t bytes = (size_t)sm.words * sizeof(float);
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (p.rows + lay.rb - 1) / lay.rb;
  kernel<<<blocks, lay.hp * lay.groups, bytes, stream>>>(p, lay, sm, st, g,
                                                         wiT, whT, dx, part);
  return cudaGetLastError();
}

}  // namespace

// Scratch, sized by the caller from the shapes (layout_for(H): rb rows a
// block, `groups` row groups, blocks = ceil(rows / rb)):
//   stash: blocks * rb * L * 6H floats; tend: blocks ints;
//   part1: blocks * groups * 4H floats; part2: P * (h + H) * 4H floats.
// dx: rows * L * h floats, every entry written. out: 4H + (h + H) 4H
// floats, [dbh | dwi | dwh]. wiT [4H, h] and whT [4H, H] are wi and wh
// transposed. P (>= 1) fixes the partition of the weight-gradient tiles,
// and with it the bits.
extern "C" int lstm_x_bwd_launch(const void* x, const void* mask,
                                 const void* order, const void* wi,
                                 const void* wh, const void* bh,
                                 const void* g, const void* wiT,
                                 const void* whT, void* stash, void* tend,
                                 void* part1, void* part2, void* dx,
                                 void* out, int rows, int L, int h, int H,
                                 int P, void* stream) {
  const Operands p{nullptr,           nullptr,           (const uint8_t*)mask,
                   nullptr,           nullptr,           (const int32_t*)order,
                   nullptr,           (const float*)wi,  (const float*)wh,
                   (const float*)bh,  rows,              L,
                   h,                 H,                 0,
                   (const float*)x};
  if (rows < 1 || L < 1 || h < 1 || h > kMaxH || H < 1 || H > kMaxH ||
      P < 1)
    return (int)cudaErrorInvalidValue;
  const Layout lay = layout_for(H);
  const size_t plane = (size_t)((rows + lay.rb - 1) / lay.rb) * lay.rb * L;
  float* s = (float*)stash;
  const Stash st{s, s + plane * 4 * H, s + plane * 5 * H, (int*)tend};
  const cudaStream_t cs = (cudaStream_t)stream;
  cudaError_t err = launch_forward<kXRows, true>(p, nullptr, st, cs);
  if (err != cudaSuccess) return (int)err;
  err = launch_reverse(p, lay, st, (const float*)g, (const float*)wiT,
                       (const float*)whT, (float*)dx, (float*)part1, cs);
  if (err != cudaSuccess) return (int)err;
  const int M = h + H;
  const int N = 4 * H;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, P);
  weights_kernel<<<grid, kWThreads, 0, cs>>>(p, lay, st, (float*)part2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int blocks = (rows + lay.rb - 1) / lay.rb;
  float* o = (float*)out;
  reduce_kernel<<<(N + kReduceThreads - 1) / kReduceThreads, kReduceThreads,
                  0, cs>>>((const float*)part1, o, N, blocks * lay.groups);
  reduce_kernel<<<(M * N + kReduceThreads - 1) / kReduceThreads,
                  kReduceThreads, 0, cs>>>((const float*)part2, o + N,
                                           M * N, P);
  return (int)cudaGetLastError();
}
