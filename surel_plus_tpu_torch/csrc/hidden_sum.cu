// Fused key unpack + hidden layer + masked set sum, forward:
//
//   out[q,b,:] = sum_l  mask_own[q,b,l]   * relu(f(kown[q,b,l]) . U + b1)
//              + sum_l' mask_cross[q,b,l'] * relu(f(kcross[b,l']) . U + b1)
//
// f(k) unpacks a packed landing-count key into its ncol fields: field i is
// (k >> i*shift) & (2^shift - 1), the last field is the root bit, or comes
// from an int32 root plane (0 or 1) for the layouts whose root bit lies
// outside the lo word. U = u_ext[0:ncol] (W1's rows permuted and scaled),
// b1 = u_ext[ncol+1]; u_ext[ncol] is the TPU kernel's masking row, which
// this kernel replaces by skipping unselected slots.
//
// Replaces the TPU kernel surel_plus_tpu/ops/pallas/hidden_sum_kernel.py
// (_fwd_kernel). The TPU kernel reaches the MXU by laying fields on
// sublanes and splits the shared cross plane per endpoint with a
// group-selector matmul; neither carries over.
//
// Bound on the H100: bytes. At the bench width (Q=2, B=4096, L=301,
// Lc=602, H=96, ncol=4) the kernel reads about 30 MB (9 us at 3.35 TB/s).
// z = f . U + b1 for every selected slot and channel goes to the tensor
// cores (one TF32 product of K = 8 a slot and channel: about 6 us at the
// TF32 rate on sampled sets, where about 40% of the slots are selected);
// what stays on the CUDA cores is a max for each computed slot and channel
// and an add for each endpoint that selects it (about 6 us). The first
// version formed z with ncol fmaf a slot and channel from shared-memory
// broadcasts, in one block a row with two block barriers a 128-slot chunk,
// and walked every slot: 8.1x its fp32 bound. This one is not near its
// bound either: on an H100 the walk, the products and the sums each take
// a large share of its time and the near-0 test a smaller one; a bf16 or
// fp16 product of the same shape in place of the TF32 one took as long,
// and more warps a block, fewer channels a slab, a deeper ring or less
// inlined code did not help (PERF.md).
//
// Numerics. The fields are integers below 2^shift, exact in TF32 while
// shift <= 11; past it each is split in two exact TF32 parts (below 2^22),
// one more product. U is split into big = U truncated to TF32 and small =
// U - big, truncated to TF32 here (what the tensor core reads), so that
// z = b1 + sum_i f_i (big_i + small_i) loses only small's truncation:
// while 2 ncol <= 8 the fields go twice along K, against U's big and small
// rows stacked (one product), else two products, the small one first. b1
// starts the accumulator, which is fresh for every slot (never an
// accumulation across slots on the tensor cores: that drifted in the LSTM
// backwards, lstm_tc.cuh).
//
// The relu decisions. With S = |b1| + sum_i f_i |U_i|, small's truncation
// costs at most 2^-20 S (|small| <= 2^-10 |U|, truncated to 10 bits); the
// products are exact (11-bit by 11-bit significands) and the tensor
// core's sum of at most 2 x 9 terms in fp32 (two chained products: the
// fields are split only for ncol <= 3, which fit the lo word at
// shift >= 12, and are stacked) costs at most 18 * 2^-23 S; the fmaf chain
// itself at most ncol * 2^-24 S. Together below 2^-18 S. A slot takes S
// with the largest |b1| and |U_i| of the slab's channels (at least each
// channel's S), so wherever |z| >= S / 2^kNearShift (2^-16, 4x the error)
// the sign of the tensor-core z is the fmaf order's. Where no field meets
// a nonzero U row (a key of zeros, as the cross slots that the partner's
// set lacks) every product is 0 and both give b1 exactly: the bound is 0
// there, whatever b1 (a fresh Net's b1 is 0, and a channel whose relu
// never passes keeps b1 = 0 in training). Below it the k-step is noted (a
// warp notes up to kFlags k-steps, and rechecks every k-step of the row
// past that). After the row a cold pass recomputes those k-steps' z and,
// where it lies below the bound, takes relu of that z out of the sums and
// adds relu of z in the fmaf order (`htc::zed`) in its place: every relu
// decision is the one K1 bwd recomputes, and a set of one slot sums relu
// of the fmaf-order z to the bit (chip_smoke.py holds K1's signs to that
// order on such sets). On the bench's sets a recheck is rare
// (chip_smoke.py prints how rare). Past shift 22 (fields not exact in two
// parts) every z is recomputed. The cold pass goes an m-tile at a time so
// that it needs few registers beside the hot loop's (inlined in the hot
// loop, the recheck cost more in spills than the whole walk; a select a
// slot-channel there, to leave the near z out of the sums, made K1 37%
// slower on an H100, PERF.md).
//
// Design: a warp per query row, four rows a block, no block barrier. The
// warp walks the shared cross plane once, in 32-slot tiles with a Q-bit
// selection a slot, then each endpoint's own row. Each tile's keys, roots
// and mask bytes come through a ring of kRing stages in the warp's shared
// memory by asynchronous copies issued kRing - 1 tiles ahead (mask rows
// from the word boundary before the tile, zero-filled past the row's end),
// so no load waits in the walk, and no integer division: a cursor steps
// from tile to tile. Lane l holds slot l of the tile; one ballot finds the
// tile's k-steps (8 slots) that hold a selected slot, and only those run.
// The join's selections are prefixes (every own row's valid slots come
// first, and the merged cross plane's valid slots sort before its pads), so
// this wastes at most a k-step's slots a segment; compacting the selected
// slots into a queue (as K1 bwd does) cost more in its shared-memory
// traffic than it saved (PERF.md). An unselected slot of an active
// k-step gets NaN fields: its z is NaN and relu's fmaxf makes it 0.
// mma.sync.m16n8k8: M = channels (m-tiles of 16), N = the 8 slots of the
// k-step, K = U's rows: a lane (g, c) holds U's A fragment (channels
// 16 mt + g, + 8; K entries c, c + 4) in registers, takes slot g's key from
// its lane by a shuffle and unpacks the two fields its B fragment holds,
// and gets z for channels 16 mt + g, + 8 of slots 2c, 2c + 1. Every m-tile's
// product is issued before any result is read. relu and the sums stay in
// the accumulator fragment's layout: a lane keeps a sum per endpoint for
// each of its channels (a cross slot's weights are its endpoint bits, so
// its z is formed once and added to every endpoint that selects it; an
// own slot adds to its endpoint alone). At the row's end two shuffles add
// the four lanes of a channel in a fixed order: no float atomics, two
// launches give the same bits. H wider than a slab (slab_mtiles) runs more
// slabs (the grid's y).

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "hidden_tc.cuh"

namespace {

using namespace htc;
using smem::copy_async_part;

struct Args {
  SumRows r;
  const float* u;  // [ncol + 2, H]
  float* out;      // [Q, B, H]
  int H, shift;
};

// K entry k of a slot's B column: the field it holds, or -1 (a zero). While
// 2 ncol <= 8 the fields go twice along K, against U's big then small rows.
template <int NCOL>
__host__ __device__ constexpr int k_field(int k) {
  return k < NCOL ? k : (2 * NCOL <= 8 && k < 2 * NCOL ? k - NCOL : -1);
}

constexpr uint32_t kNaN = 0x7fc00000u;  // a pad slot's fields
constexpr int kRing = 4;        // a warp's ring of staged 32-slot tiles
constexpr int kFwdBlocks = 4;   // blocks an SM: at most 128 registers
constexpr int kFlags = 32;      // k-steps a warp notes for the recheck
constexpr int kMaskWords = 9;   // a mask row's 32 bytes, from a word boundary
// words of a stage: the tile's keys, roots, and up to kMaxQ mask rows
constexpr int kStageWords = 64 + kMaxQ * kMaskWords;

template <int S>
using Seg = std::integral_constant<int, S>;

// z of one slot and channel in the fmaf order, from the key and U's column
// (the recheck near 0).
template <int NCOL, bool ROOT>
__device__ __forceinline__ float zed_at(uint32_t key, int32_t root, int shift,
                                     const float* __restrict__ u, int H,
                                     int ch) {
  float f[NCOL], uc[NCOL];
  fields<NCOL, ROOT>(key, root, shift, f);
#pragma unroll
  for (int i = 0; i < NCOL; ++i) uc[i] = __ldg(u + i * H + ch);
  return zed(f, uc, __ldg(u + (NCOL + 1) * H + ch));
}

template <int NCOL, bool ROOT, int NQ>
__global__ void __launch_bounds__(kWarps * 32, kFwdBlocks)
hidden_sum_fwd_kernel(Args a) {
  constexpr int MS = slab_mtiles(NCOL, false);
  constexpr bool STACK = 2 * NCOL <= 8;
  constexpr int NA = STACK ? 1 : 2;  // U's parts a product takes
  constexpr unsigned kAll = 0xffffffffu;
  __shared__ __align__(16) uint32_t ring_all[kWarps][kRing * kStageWords];
  __shared__ int flags_all[kWarps][kFlags];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const SumRows r = a.r;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= r.B) return;  // the whole warp: no barrier follows
  const int c0 = blockIdx.y * 16 * MS;  // the slab's first channel
  uint32_t* ring = ring_all[warp];
  int* flags = flags_all[warp];  // the k-steps (4 ti + j) to recheck
  const bool fsplit = a.shift > kExactShift;
  const int fi0 = k_field<NCOL>(c), fi1 = k_field<NCOL>(c + 4);

  // U's A fragment of m-tile mt (part 0 is the small one when there are
  // two) and b1 of its channels g, g + 8; past H, A is 0 and b1 infinite:
  // z is never near 0 there (and never stored)
  auto u_frag = [&](int mt, uint32_t (&A)[NA][4], float (&bx)[2]) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int ch = c0 + 16 * mt + g + 8 * (jj & 1);
      const int k = c + 4 * (jj >> 1);
#pragma unroll
      for (int p = 0; p < NA; ++p) {
        const int fi = STACK ? k_field<NCOL>(k) : (k < NCOL ? k : -1);
        const bool small = STACK ? k >= NCOL : p == 0;
        const Split s = split(fi >= 0 && ch < a.H ? __ldg(a.u + fi * a.H + ch)
                                                  : 0.f);
        A[p][jj] = small ? (s.small & 0xffffe000u) : s.big;
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ch = c0 + 16 * mt + g + 8 * e;
      bx[e] = ch < a.H ? __ldg(a.u + (NCOL + 1) * a.H + ch)
                       : __int_as_float(0x7f800000);
    }
  };
  uint32_t ua[NA][MS][4];
  float bias[MS][2];
#pragma unroll
  for (int mt = 0; mt < MS; ++mt) {
    uint32_t A[NA][4];
    u_frag(mt, A, bias[mt]);
#pragma unroll
    for (int p = 0; p < NA; ++p)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) ua[p][mt][jj] = A[p][jj];
  }
  // the recheck bound's terms: the largest |b1| and |U_i| over the slab's
  // channels (a slot's bound is `near_bound`)
  float umax[NCOL], bmax = 0.f;
#pragma unroll
  for (int i = 0; i < NCOL; ++i) umax[i] = 0.f;
  for (int x = 0; x < 2 * MS; ++x) {
    const int ch = c0 + 16 * (x / 2) + g + 8 * (x % 2);
    if (ch >= a.H) continue;
    bmax = fmaxf(bmax, fabsf(__ldg(a.u + (NCOL + 1) * a.H + ch)));
#pragma unroll
    for (int i = 0; i < NCOL; ++i)
      umax[i] = fmaxf(umax[i], fabsf(__ldg(a.u + i * a.H + ch)));
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    bmax = fmaxf(bmax, __shfl_xor_sync(kAll, bmax, o));
#pragma unroll
    for (int i = 0; i < NCOL; ++i)
      umax[i] = fmaxf(umax[i], __shfl_xor_sync(kAll, umax[i], o));
  }
  // a slot's recheck bound: S / 2^kNearShift with S = max |b1| + sum_i
  // f_i max |U_i|, at least the S of each of its channels (infinite past
  // shift 22: every z is rechecked); 0 where no field meets a nonzero U
  // row, since z is then b1 exactly in both orders
  auto near_bound = [&](uint32_t key, int32_t root) {
    float f[NCOL];
    fields<NCOL, ROOT>(key, root, a.shift, f);
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < NCOL; ++i) t = fmaf(f[i], umax[i], t);
    if (t == 0.f) return 0.f;
    return a.shift > 2 * kExactShift ? __int_as_float(0x7f800000)
                                     : ldexpf(bmax + t, -kNearShift);
  };

  float acc[NQ][MS][2];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int mt = 0; mt < MS; ++mt) acc[q][mt][0] = acc[q][mt][1] = 0.f;

  // The B fragments of k-step j (slots 8j .. 8j + 7 of the tile, whose
  // keys and bits the tile's lanes hold: `mine` is this lane's): slot g's
  // fields at K entries c and c + 4, big and small TF32 parts. A slot no
  // endpoint selects (masked, or past the row) gets NaN fields: its z is
  // NaN, and relu's fmaxf makes that 0.
  struct BF {
    uint32_t b0, b1, s0, s1;
  };
  auto bfrag = [&](const Slot& mine, int j) {
    const uint32_t key = __shfl_sync(kAll, mine.key, 8 * j + g);
    const int32_t root = ROOT ? __shfl_sync(kAll, mine.root, 8 * j + g) : 0;
    const uint32_t sel = __shfl_sync(kAll, mine.bits, 8 * j + g);
    BF f{kNaN, kNaN, 0u, 0u};
    if (sel != 0) {
      const Split s0 = split(fi0 < 0 ? 0.f
                                     : field<NCOL, ROOT>(key, root, a.shift,
                                                         fi0));
      const Split s1 = split(fi1 < 0 ? 0.f
                                     : field<NCOL, ROOT>(key, root, a.shift,
                                                         fi1));
      f = BF{s0.big, s1.big, s0.small, s1.small};  // a rest: exact in TF32
    }
    return f;
  };
  // z of m-tile mt: channel g (d[0], d[1]) and g + 8 (d[2], d[3]), slots
  // 2c and 2c + 1 of the k-step
  auto product = [&](const BF& f, int mt, float (&d)[4]) {
    const uint32_t(&A)[4] = ua[0][mt];
    mma_to(d, A, (STACK && fsplit) ? f.s0 : f.b0,
           (STACK && fsplit) ? f.s1 : f.b1, bias[mt][0], bias[mt][0],
           bias[mt][1], bias[mt][1]);
    if constexpr (STACK) {
      if (fsplit) mma(d, A[0], A[1], A[2], A[3], f.b0, f.b1);
    } else {  // ncol >= 5: the fields are never split (shift <= 10)
      const uint32_t(&U)[4] = ua[NA - 1][mt];
      mma(d, U[0], U[1], U[2], U[3], f.b0, f.b1);
    }
  };

  // The hot k-step: relu(z) into the sums; SEG -1: the cross plane (each
  // slot weighted by its endpoint bits), else endpoint SEG's own row.
  // Returns whether any of the warp's z lies within the recheck bound.
  auto kstep = [&](const Slot& mine, float nb_mine, int j, auto seg) {
    constexpr int SEG = decltype(seg)::value;
    const BF f = bfrag(mine, j);
    float d[MS][4];  // every m-tile's product issued before any is read
#pragma unroll
    for (int mt = 0; mt < MS; ++mt) product(f, mt, d[mt]);
    // the lane's columns 2c, 2c + 1: the cross slots' endpoint bits and
    // the slots' recheck bounds
    const uint32_t m0 = __shfl_sync(kAll, mine.bits, 8 * j + 2 * c);
    const uint32_t m1 = __shfl_sync(kAll, mine.bits, 8 * j + 2 * c + 1);
    const float nb0 = __shfl_sync(kAll, nb_mine, 8 * j + 2 * c);
    const float nb1 = __shfl_sync(kAll, nb_mine, 8 * j + 2 * c + 1);
    bool near = false;
#pragma unroll
    for (int mt = 0; mt < MS; ++mt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        near |= fabsf(d[mt][2 * e]) < nb0;
        near |= fabsf(d[mt][2 * e + 1]) < nb1;
        const float r0 = fmaxf(d[mt][2 * e], 0.f);
        const float r1 = fmaxf(d[mt][2 * e + 1], 0.f);
        if constexpr (SEG < 0) {
#pragma unroll
          for (int q = 0; q < NQ; ++q)
            acc[q][mt][e] = fmaf((float)((m1 >> q) & 1u), r1,
                                 fmaf((float)((m0 >> q) & 1u), r0,
                                      acc[q][mt][e]));
        } else {
          acc[SEG][mt][e] += r0;
          acc[SEG][mt][e] += r1;
        }
      }
    }
    return __any_sync(kAll, near);
  };

  // The cold pass over a k-step that `kstep` flagged: its z again, and
  // where z lies within the bound, relu of z in the fmaf order in place of
  // relu of the tensor-core z: the one taken out of the sums, then the
  // other added, with the slot's endpoint weights (a sum that held only
  // this slot ends as relu of the fmaf-order z to the bit; adding their
  // difference would not, where the two z differ by orders of magnitude).
  // It goes an m-tile at a time, U's A fragment and b1 rebuilt from device
  // memory, so that it holds few registers beside the hot loop's.
  auto recheck = [&](const Slot& mine, int j) {
    const BF f = bfrag(mine, j);
    uint32_t kk[2], mm[2];
    int32_t rr[2];
    float nbh[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      kk[h] = __shfl_sync(kAll, mine.key, 8 * j + 2 * c + h);
      rr[h] = __shfl_sync(kAll, mine.root, 8 * j + 2 * c + h);
      mm[h] = __shfl_sync(kAll, mine.bits, 8 * j + 2 * c + h);
      nbh[h] = near_bound(kk[h], rr[h]);
    }
#pragma unroll 1
    for (int x = 0; x < MS; ++x) {
      uint32_t A[NA][4];
      float bx[2];
      u_frag(x, A, bx);
      float d[4];
      mma_to(d, A[0], (STACK && fsplit) ? f.s0 : f.b0,
             (STACK && fsplit) ? f.s1 : f.b1, bx[0], bx[0], bx[1], bx[1]);
      if constexpr (STACK) {
        if (fsplit) mma(d, A[0][0], A[0][1], A[0][2], A[0][3], f.b0, f.b1);
      } else {
        mma(d, A[NA - 1][0], A[NA - 1][1], A[NA - 1][2], A[NA - 1][3], f.b0,
            f.b1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!(fabsf(d[e]) < nbh[e & 1])) continue;
        const int h = e & 1;
        const float zf = zed_at<NCOL, ROOT>(kk[h], rr[h], a.shift, a.u, a.H,
                                            c0 + 16 * x + g + 8 * (e >> 1));
        const float rt = fmaxf(d[e], 0.f), rz = fmaxf(zf, 0.f);
#pragma unroll
        for (int mt = 0; mt < MS; ++mt)  // acc's indices stay static
          if (mt == x)
#pragma unroll
            for (int q = 0; q < NQ; ++q)
              if ((mm[h] >> q) & 1u)
                acc[q][mt][e >> 1] = (acc[q][mt][e >> 1] - rt) + rz;
      }
    }
  };

  // A tile of the walk: its segment (-1: the cross plane, else endpoint
  // seg's own row) and first slot; `step` moves to the next tile.
  struct Cursor {
    int seg, l0;
  };
  auto width = [&](int seg) { return seg < 0 ? r.Lc : r.Lo; };
  auto step = [&](Cursor& cu) {
    cu.l0 += 32;
    if (cu.l0 >= width(cu.seg)) {
      ++cu.seg;
      cu.l0 = 0;
    }
  };
  // the tile's keys, roots and first mask row (row q at + q * mstride)
  struct Tile {
    const uint32_t* keys;
    const int32_t* roots;
    const uint8_t* m0;
    size_t mstride;
    int L, nrow;
  };
  auto tile = [&](Cursor cu) {
    if (cu.seg < 0) {
      const size_t at = (size_t)b * r.ldc + cu.l0;
      return Tile{r.kcross + at, ROOT ? r.rcross + at : nullptr,
                  r.mcross + at, (size_t)r.B * r.ldc, r.Lc, r.Q};
    }
    const size_t at = ((size_t)cu.seg * r.B + b) * r.Lo + cu.l0;
    return Tile{r.kown + at, ROOT ? r.rown + at : nullptr, r.mown + at, 0,
                r.Lo, 1};
  };
  // stage the tile at `cu` in ring stage st
  auto issue = [&](Cursor cu, int st) {
    const Tile t = tile(cu);
    uint32_t* sg = ring + st * kStageWords;
    if (cu.l0 + lane < t.L) {
      copy_async<4>(sg + lane, t.keys + lane);
      if (ROOT) copy_async<4>(sg + 32 + lane, t.roots + lane);
    }
    // the mask rows' bytes from the word boundary at or before the tile's
    // first, none past the row's end
    for (int w = lane; w < t.nrow * kMaskWords; w += 32) {
      const int q = w / kMaskWords;
      const uint8_t* row = t.m0 + q * t.mstride;
      const uint8_t* word = reinterpret_cast<const uint8_t*>(
          reinterpret_cast<uintptr_t>(row) & ~(uintptr_t)3) +
          4 * (w - q * kMaskWords);
      const long left = (long)((row - cu.l0 + t.L) - word);
      if (left > 0)
        copy_async_part(sg + 64 + w, word, left < 4 ? (unsigned)left : 4u);
    }
  };

  const int ntiles = r.cross_tiles() + r.Q * r.own_tiles();
  int nflag = 0;                    // k-steps flagged for the recheck
  Cursor rd{r.Lc > 0 ? -1 : 0, 0};  // the tile read next
  Cursor wr = rd;                   // the tile staged next
#pragma unroll
  for (int i = 0; i + 1 < kRing; ++i) {
    if (i < ntiles) issue(wr, i);
    copies_commit();  // a group per tile, empty past the row
    step(wr);
  }
  for (int ti = 0; ti < ntiles; ++ti) {
    __syncwarp();  // every lane is done with the stage reused next
    if (ti + kRing - 1 < ntiles) issue(wr, (ti + kRing - 1) % kRing);
    copies_commit();
    step(wr);
    copies_wait<kRing - 1>();
    __syncwarp();  // tile ti has landed, every lane's part of it
    const Tile t = tile(rd);
    const int seg = rd.seg;
    const uint32_t* sg = ring + (ti % kRing) * kStageWords;
    Slot mine{0u, 0u, 0};  // this lane's slot of the tile
    if (rd.l0 + lane < t.L) {
      const uint8_t* mb = reinterpret_cast<const uint8_t*>(sg + 64);
      mine.key = sg[lane];
      if (ROOT) mine.root = (int32_t)sg[32 + lane];
      for (int q = 0; q < t.nrow; ++q) {
        const int o = (int)(reinterpret_cast<uintptr_t>(t.m0 + q * t.mstride)
                            & 3);
        mine.bits |= (uint32_t)(mb[4 * kMaskWords * q + o + lane] != 0)
                     << (seg < 0 ? q : seg);
      }
    }
    step(rd);
    const float nb_mine = near_bound(mine.key, mine.root);
    // the k-steps (8 slots) that hold a selected slot, uniform in the warp
    const uint32_t act = __ballot_sync(kAll, mine.bits != 0);
    if (act == 0) continue;
    auto run = [&](auto seg_tag) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if ((act >> (8 * j)) & 0xffu && kstep(mine, nb_mine, j, seg_tag)) {
          if (nflag < kFlags && lane == 0) flags[nflag] = 4 * ti + j;
          ++nflag;
        }
    };
    switch (seg) {
      case -1: run(Seg<-1>{}); break;
      case 0: run(Seg<0>{}); break;
      case 1: run(Seg<1>{}); break;
      default:
        if constexpr (NQ > 2) {
          if (seg == 2)
            run(Seg<2>{});
          else
            run(Seg<3>{});
        }
    }
  }

  // the recheck of the flagged k-steps, their slots read again from device
  // memory (every active k-step of the row when more than kFlags were)
  if (nflag > kFlags) {
    for (int ti = 0; ti < ntiles; ++ti) {
      const Slot mine = row_slot<ROOT>(r, b, ti, lane);
      const uint32_t act = __ballot_sync(kAll, mine.bits != 0);
      for (int j = 0; j < 4; ++j)
        if ((act >> (8 * j)) & 0xffu) recheck(mine, j);
    }
  } else if (nflag > 0) {
    __syncwarp();  // the flags written
    for (int k = 0; k < nflag; ++k) {
      const Slot mine = row_slot<ROOT>(r, b, flags[k] / 4, lane);
      recheck(mine, flags[k] % 4);
    }
  }

  // the four lanes of a channel (c = 0..3) added in a fixed order; lane c
  // writes the channels of m-tile halves 2 mt + e = c (mod 4)
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int mt = 0; mt < MS; ++mt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = acc[q][mt][e];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        const int ch = c0 + 16 * mt + g + 8 * e;
        if (q < r.Q && ch < a.H && c == ((2 * mt + e) & 3))
          a.out[((size_t)q * r.B + b) * a.H + ch] = v;
      }
}

template <int NCOL, bool ROOT, int NQ>
cudaError_t launch_typed(const Args& a, cudaStream_t stream) {
  constexpr int CS = 16 * slab_mtiles(NCOL, false);
  const dim3 grid((a.r.B + kWarps - 1) / kWarps, (a.H + CS - 1) / CS);
  hidden_sum_fwd_kernel<NCOL, ROOT, NQ><<<grid, kWarps * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int NCOL>
cudaError_t launch(const Args& a, bool root, cudaStream_t stream) {
  if (a.r.Q <= 2)
    return root ? launch_typed<NCOL, true, 2>(a, stream)
                : launch_typed<NCOL, false, 2>(a, stream);
  return root ? launch_typed<NCOL, true, 4>(a, stream)
              : launch_typed<NCOL, false, 4>(a, stream);
}

}  // namespace

extern "C" int hidden_sum_fwd_launch(const void* kown, const void* mown,
                                     const void* kcross, const void* mcross,
                                     const void* rown, const void* rcross,
                                     const void* u, void* out, int Q, int B,
                                     int Lo, int Lc, int ldc, int H,
                                     int ncol, int shift, void* stream) {
  const Args a{SumRows{(const uint32_t*)kown, (const uint8_t*)mown,
                       (const uint32_t*)kcross, (const uint8_t*)mcross,
                       (const int32_t*)rown, (const int32_t*)rcross, Q, B,
                       Lo, Lc, ldc},
               (const float*)u, (float*)out, H, shift};
  const bool root = rown != nullptr;
  const cudaStream_t s = (cudaStream_t)stream;
  if (Q < 1 || Q > kMaxQ || H < 1 || H > 1024 || B < 1 || ldc < Lc)
    return (int)cudaErrorInvalidValue;
  switch (ncol) {
    case 2: return (int)launch<2>(a, root, s);
    case 3: return (int)launch<3>(a, root, s);
    case 4: return (int)launch<4>(a, root, s);
    case 5: return (int)launch<5>(a, root, s);
    case 6: return (int)launch<6>(a, root, s);
    case 7: return (int)launch<7>(a, root, s);
    case 8: return (int)launch<8>(a, root, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
