// The keys-LSTM's forward (lstm_keys.cu, K4): the operands, the block
// layout, the field extraction, the hidden rows, the gate sums, the cell
// update and the step loop itself. Serving and training run this one code
// and get the same values bit for bit (same fmaf order); the training
// instance also stashes each step's gates and carries for the backward
// (lstm_tc.cuh), which runs no forward of its own. The same step loop also
// runs over given input rows x in place of the keys (NCOL = kXRows:
// lstm.cu, K5).

#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace lstm {

constexpr int kRows = 8;          // rows per thread (a row group's rows)
constexpr int kMaxGroups = 4;     // row groups per block
constexpr int kMaxThreads = 512;  // hp * groups
constexpr int kMaxH = 256;        // LSTM width H and input width h
constexpr int kChunk = 32;        // slots staged per chunk
// dynamic shared memory a block may have: 227 KB less the static arrays
constexpr int kMaxSmem = 232448 - 1024;
// NCOL of the kernels that read the input rows x [R, L, h] (K5) instead of
// computing them from keys of NCOL count fields (K4)
constexpr int kXRows = 0;

struct Operands {
  const uint32_t* kown;    // [R, L] own lo keys
  const uint32_t* kcross;  // [R, L] slot-aligned partner lo keys
  const uint8_t* mask;     // [R, L] bool
  const int32_t* rown;     // [R, L] root planes, or null
  const int32_t* rcross;   // [R, L] or null
  const int32_t* order;    // [R] row processed i-th, or null (identity)
  const float* u;          // [ncol + 2, h]: U rows | NEG row | b1 row
  const float* wi;         // [h, 4H] input weights (projection folded in)
  const float* wh;         // [H, 4H]
  const float* bh;         // [4H]
  int rows, L, h, H, shift;
  const float* x;          // [R, L, h] input rows (kXRows), else null
};

// One thread per hidden unit j < hp (H rounded up to whole warps) and row
// group g; a block holds rb = groups * kRows rows. x and h of the block's
// rows live in shared memory transposed, [channel][row] with row stride ld,
// so a thread reads its kRows rows of one channel as float4s, and all the
// lanes of a warp read the same address (a broadcast).
struct Layout {
  int hp, groups, rb, ld;
};

__host__ __device__ inline Layout layout_for(int H) {
  Layout l;
  l.hp = ((H + 31) / 32) * 32;
  l.groups = kMaxThreads / l.hp < kMaxGroups ? kMaxThreads / l.hp
                                             : kMaxGroups;
  l.rb = l.groups * kRows;
  l.ld = l.rb + 4;  // a multiple of 4 (float4), off the bank period
  return l;
}

// Offsets, in 4-byte words, of the dynamic shared memory: x and h double
// buffered ([2][h][ld], [2][H][ld]), then a chunk of staged key, mask and
// root planes ([kChunk][rb + 1] each), U, and wh [H][4H] where it fits
// (`wh_smem`: at H = 96 it takes 147,456 of the 226,176 bytes). The
// kernels that read x (ncol = kXRows) stage the mask plane only, and no U.
struct Smem {
  int xs, hs, ko, kc, mk, ro, rc, u, wh, words;
};

__host__ __device__ inline Smem smem_for(const Layout& l, int h, int H,
                                         int ncol, bool wh_smem) {
  Smem s;
  const int plane = kChunk * (l.rb + 1);
  const int kplane = ncol == kXRows ? 0 : plane;  // key and root planes
  s.xs = 0;
  s.hs = s.xs + 2 * h * l.ld;
  s.ko = s.hs + 2 * H * l.ld;
  s.kc = s.ko + kplane;
  s.mk = s.kc + kplane;
  s.ro = s.mk + plane;
  s.rc = s.ro + kplane;
  s.u = s.rc + kplane;
  s.wh = s.u + (ncol == kXRows ? 0 : (ncol + 2) * h);
  s.words = s.wh + (wh_smem ? 4 * H * H : 0);
  return s;
}

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

// x[k] = relu(z_own) + relu(z_cross)
template <int NCOL>
__device__ __forceinline__ float hidden(const float (&fo)[NCOL],
                                        const float (&fc)[NCOL],
                                        const float* u, int h, int k) {
  return fmaxf(side_z(fo, u, h, k), 0.f) + fmaxf(side_z(fc, u, h, k), 0.f);
}

// acc[q][i] += sum_k v[k][r0 + i] * w[k][q H + j], k = 0..n-1 in order:
// gate q (i, f, g, o) of unit j for the thread's kRows rows. v is x or h in
// shared memory ([n][ld]); w is in shared memory (W_SMEM) or read through
// the read-only cache.
template <bool W_SMEM>
__device__ __forceinline__ void gate_sum(float (&acc)[4][kRows],
                                         const float* __restrict__ w,
                                         const float* v, int n, int H,
                                         int ld, int j, bool on, int r0) {
  const size_t h4 = 4 * (size_t)H;
#pragma unroll 4
  for (int k = 0; k < n; ++k) {
    const float* wk = w + k * h4 + j;
    float wq[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      wq[q] = on ? (W_SMEM ? wk[q * H] : __ldg(wk + q * H)) : 0.f;
    const float4* vr = reinterpret_cast<const float4*>(v + k * ld + r0);
#pragma unroll
    for (int i4 = 0; i4 < kRows / 4; ++i4) {
      const float4 x4 = vr[i4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[q][4 * i4 + 0] = fmaf(x4.x, wq[q], acc[q][4 * i4 + 0]);
        acc[q][4 * i4 + 1] = fmaf(x4.y, wq[q], acc[q][4 * i4 + 1]);
        acc[q][4 * i4 + 2] = fmaf(x4.z, wq[q], acc[q][4 * i4 + 2]);
        acc[q][4 * i4 + 3] = fmaf(x4.w, wq[q], acc[q][4 * i4 + 3]);
      }
    }
  }
}

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

// What the training forward keeps for the backward's sweep, per block b and
// step t < tend[b], rows in the block's order, channels contiguous (so the
// lanes of a warp, one unit each, write and read whole lines): the gates
// after their activations [rb][4H] (0 where the slot is masked), and the
// carries entering the step, c and h [rb][H]. All null in serving.
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

// A 4-byte copy from device to shared memory that runs while the thread goes
// on (cp.async); `copies_wait` waits for the thread's copies.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Slot t of the block's rows into x [h][ld] (kXRows kernels): each row's h
// inputs are contiguous in device memory, read by neighbouring threads;
// rows past the block's end get 0.
__device__ __forceinline__ void stage_x(const Operands& p, const int* srow,
                                        int nrows, int rb, int ld, int t,
                                        float* x, int tid, int nt) {
  for (int i = tid; i < rb * p.h; i += nt) {
    const int r = i / p.h;
    const int k = i - r * p.h;
    float* dst = x + k * ld + r;
    if (r < nrows)
      copy_async(dst, p.x + ((size_t)srow[r] * p.L + t) * p.h + k);
    else
      *dst = 0.f;
  }
}

// Dynamic shared memory above the default 48 KB needs an opt-in per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The forward over one block of rb rows (design in lstm_keys.cu). Both
// instances write the final h to out[order[i]]; the training instance
// (STASH true) also writes the stash. With NCOL = kXRows the
// step's x rows are copied from p.x (lstm.cu) instead of computed from the
// keys: slot t + 1's copy runs while slot t's gate sums do.
template <int NCOL, bool ROOT, bool WHS, bool STASH>
__global__ void __launch_bounds__(kMaxThreads)
forward_kernel(Operands p, Layout lay, Smem sm, float* out, Stash st) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int srow[kMaxGroups * kRows];
  __shared__ int tend;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int rb = lay.rb;
  const int ld = lay.ld;
  const int cs = rb + 1;
  const int base = blockIdx.x * rb;
  const int nrows = min(rb, p.rows - base);  // rows of this block
  float* xs = smem + sm.xs;
  float* hs = smem + sm.hs;
  uint32_t* sko = reinterpret_cast<uint32_t*>(smem + sm.ko);
  uint32_t* skc = reinterpret_cast<uint32_t*>(smem + sm.kc);
  int32_t* smk = reinterpret_cast<int32_t*>(smem + sm.mk);
  int32_t* sro = reinterpret_cast<int32_t*>(smem + sm.ro);
  int32_t* src = reinterpret_cast<int32_t*>(smem + sm.rc);
  float* su = smem + sm.u;
  float* swh = smem + sm.wh;

  if constexpr (NCOL != kXRows)
    for (int i = tid; i < (NCOL + 2) * p.h; i += nt) su[i] = p.u[i];
  if (WHS)
    for (int i = tid; i < 4 * p.H * p.H; i += nt) swh[i] = __ldg(p.wh + i);
  for (int i = tid; i < p.H * ld; i += nt) hs[i] = 0.f;  // h0 = 0, buffer 0
  if (tid < nrows) srow[tid] = p.order ? p.order[base + tid] : base + tid;
  if (tid == 0) tend = 0;
  __syncthreads();
  // the block's last valid slot index + 1: later steps change no carry
  int last = 0;
  for (int i = tid; i < nrows * p.L; i += nt) {
    const int r = i / p.L;
    const int l = i - r * p.L;
    if (p.mask[(size_t)srow[r] * p.L + l]) last = max(last, l + 1);
  }
  if (last) atomicMax(&tend, last);

  const int j = tid % lay.hp;
  const int g = tid / lay.hp;
  const int r0 = g * kRows;
  const bool on = j < p.H;
  float bias[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) bias[q] = on ? p.bh[q * p.H + j] : 0.f;
  float c[kRows], hv[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) c[i] = hv[i] = 0.f;
  __syncthreads();
  const int steps = tend;
  if (STASH && tid == 0) st.tend[blockIdx.x] = steps;
  if constexpr (NCOL == kXRows)
    if (steps > 0) stage_x(p, srow, nrows, rb, ld, 0, xs, tid, nt);

  for (int t = 0; t < steps; ++t) {
    const int tt = t % kChunk;
    const int cur = t & 1;
    if (tt == 0) {
      __syncthreads();  // the previous chunk is consumed
      for (int i = tid; i < rb * kChunk; i += nt) {
        const int r = i / kChunk;
        const int s = i - r * kChunk;
        const bool in = r < nrows && t + s < p.L;
        const size_t off = in ? (size_t)srow[r] * p.L + t + s : 0;
        if constexpr (NCOL != kXRows) {
          sko[s * cs + r] = in ? p.kown[off] : 0u;
          skc[s * cs + r] = in ? p.kcross[off] : 0u;
        }
        smk[s * cs + r] = in ? (int32_t)(p.mask[off] != 0) : 0;
        if (ROOT) {
          sro[s * cs + r] = in ? p.rown[off] : 0;
          src[s * cs + r] = in ? p.rcross[off] : 0;
        }
      }
      __syncthreads();
    }
    // x of this slot for the block's rows, [h][ld]
    float* x = xs + cur * p.h * ld;
    if constexpr (NCOL == kXRows) {
      copies_wait();  // the thread's copies of slot t have landed
    } else {
      for (int i = tid; i < rb * p.h; i += nt) {
        const int k = i / rb;
        const int r = i - k * rb;
        float fo[NCOL], fc[NCOL];
        fields<NCOL, ROOT>(sko[tt * cs + r], ROOT ? sro[tt * cs + r] : 0,
                           p.shift, fo);
        fields<NCOL, ROOT>(skc[tt * cs + r], ROOT ? src[tt * cs + r] : 0,
                           p.shift, fc);
        x[k * ld + r] = hidden(fo, fc, su, p.h, k);
      }
    }
    __syncthreads();  // x ready; h of the previous step ready
    // the other x buffer was last read at step t - 1: free since the barrier
    if constexpr (NCOL == kXRows)
      if (t + 1 < steps)
        stage_x(p, srow, nrows, rb, ld, t + 1, xs + (cur ^ 1) * p.h * ld,
                tid, nt);
    float acc[4][kRows];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[q][i] = bias[q];
    gate_sum<false>(acc, p.wi, x, p.h, p.H, ld, j, on, r0);
    gate_sum<WHS>(acc, WHS ? swh : p.wh, hs + cur * p.H * ld, p.H, p.H, ld,
                  j, on, r0);
    float* hn = hs + (cur ^ 1) * p.H * ld;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const bool valid = smk[tt * cs + r0 + i] != 0;
      if (STASH && on) {
        const size_t a1 = stash_at(blockIdx.x, p.L, t, r0 + i, rb, p.H) + j;
        st.cprev[a1] = c[i];
        st.hprev[a1] = hv[i];
      }
      Gates a{0.f, 0.f, 0.f, 0.f};
      if (valid) {
        a = activate(acc[0][i], acc[1][i], acc[2][i], acc[3][i]);
        cell(a, c[i], hv[i]);
      }
      if (STASH && on) {
        float* ga = st.gates + stash_at(blockIdx.x, p.L, t, r0 + i, rb,
                                        4 * p.H) + j;
        ga[0] = a.i;
        ga[p.H] = a.f;
        ga[2 * p.H] = a.g;
        ga[3 * p.H] = a.o;
      }
      if (on) hn[j * ld + r0 + i] = hv[i];
    }
  }
  if (on) {
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      if (r0 + i < nrows) out[(size_t)srow[r0 + i] * p.H + j] = hv[i];
  }
}

template <int NCOL, bool STASH, bool WHS>
cudaError_t launch_forward(const Operands& p, const Layout& lay,
                           const Smem& sm, float* out, const Stash& st,
                           cudaStream_t stream) {
  const size_t bytes = (size_t)sm.words * sizeof(float);
  void (*kernel)(Operands, Layout, Smem, float*, Stash) =
      &forward_kernel<NCOL, false, WHS, STASH>;
  if constexpr (NCOL != kXRows)
    if (p.rown) kernel = &forward_kernel<NCOL, true, WHS, STASH>;
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (p.rows + lay.rb - 1) / lay.rb;
  kernel<<<blocks, lay.hp * lay.groups, bytes, stream>>>(p, lay, sm, out, st);
  return cudaGetLastError();
}

// The forward with wh in shared memory where it fits (H = 96), else read
// through the read-only cache like wi.
template <int NCOL, bool STASH>
cudaError_t launch_forward(const Operands& p, float* out, const Stash& st,
                           cudaStream_t stream) {
  const Layout lay = layout_for(p.H);
  const Smem with_wh = smem_for(lay, p.h, p.H, NCOL, true);
  if ((size_t)with_wh.words * sizeof(float) <= (size_t)kMaxSmem)
    return launch_forward<NCOL, STASH, true>(p, lay, with_wh, out, st,
                                             stream);
  return launch_forward<NCOL, STASH, false>(
      p, lay, smem_for(lay, p.h, p.H, NCOL, false), out, st, stream);
}

}  // namespace lstm
