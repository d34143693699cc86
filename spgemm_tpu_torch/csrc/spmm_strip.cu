// Strip SpMM kernel for Hopper (sm_90a), C ABI for ctypes: Y = A . X.
//
// Replaces both Pallas SpMM kernels of the JAX package:
//   spgemm_tpu/ops/pallas_kernels.py:_spmm_kernel_factory        (:679)
//   spgemm_tpu/ops/pallas_kernels.py:_spmm_window_kernel_factory (:805)
// reached through spmm_strip_pallas (:757) and spmm_window_pallas (:894).
// Both compute the same Y from the same (aptr, ak, arow) plan; the window
// form only reads X through a per-block window [kmin[blk], kmin[blk]+kwin)
// and rebases ak by kmin[blk]: tile g of tile-row i (block blk =
// i / block_rows) reads X slab kmin[blk] + (ak[g] - kmin[blk]), which is
// slab ak[g]. On the card X is one array in device memory in both forms
// (the window is a TPU VMEM budget), so both read the same addresses and
// one kernel serves them: `kmin` null is the resident form, `kmin` set
// the window form.
//
// What it computes. For every tile-row i < gm and every A tile g in
// [aptr[i], aptr[i+1]):
//   y[i] += a[g] (tm x tk) . xb[ak[g]] (tk x k_pad)
// with y laid out (n_blocks*block_rows, tm, k_pad) as the TPU kernels
// emit it; the padding rows i >= gm of the last block come out zero.
//
// What differs from the TPU kernels, and why (128-column form). The TPU
// kernels hold X (or a block's X window) in VMEM, stream a block's A
// tiles by one DMA and stage a whole block's Y in VMEM, over an in-order
// grid. An H100 CTA has at most 227 KB of shared memory and CTAs run in
// no order. Here one 256-thread CTA owns a group of consecutive tile rows
// (128 rows of Y: 128/tm tile rows, one m16 row tile per warp) and one
// 128-wide chunk of k_pad. Neighbouring tile rows of a band read the same
// X slabs, so the CTA stages each slab its rows use once, in ascending
// ak, and every warp whose row has a tile on that slab multiplies it:
//   - the slab order is a merge of the rows' ak lists (each ascending),
//     made in the kernel by one warp from (aptr, ak): the next slab is the
//     least next ak over the rows, so every row still adds its tiles in
//     ascending ak, and every (row, tile) is visited once. Up to kSchedCap
//     slabs are merged per pass into shared memory;
//   - the (slab, 16-deep k chunk) steps stream X (16 x 128) and the rows'
//     A chunks (128 x 16; a row without a tile on the slab is zero-filled)
//     through a 4-stage cp.async ring, one barrier per step;
//   - values multiply on mma.sync.m16n8k8 with f32 accumulation, as the
//     strip kernel's exact three-way TF32 split: each operand is hi + mid
//     + lo, and the six partial products above 2^-33 |a.b| go into a
//     zeroed partial sum that one round-to-nearest add folds into the
//     accumulator (in-place 3xTF32 biased long positive sums downward
//     through the mma's truncating alignment and left about 2^-22 |a.b|
//     per product). X is the operand all eight warps read, so it is split
//     once per chunk, in shared memory, by the whole CTA (hi in place, mid
//     and lo into one of two buffers each), one step ahead of its
//     products; A is split by the warp that owns its rows. The products
//     skip the terms whose mid and lo are all zero (those of A where the
//     warp's A fragments are TF32 values, those of X where the chunk's X
//     is), which adds exact zeros only; where both are TF32 values one
//     product on the raw bits goes straight into the accumulator, so the
//     integer model stays bit-equal to the plain version.
// The tm x 128 accumulators (64 registers) stay in registers and each Y
// row is written once. No atomics, a fixed accumulation order.
//
// What bounds it on the card. At the suite's banded65536 with 16x128
// tiles and k = 128 (8,184 A tiles, gm 4,096, gn 512) the bytes each read
// or written once are A 67 MB, X 33.5 MB and Y 33.5 MB: 40 us at 3.35
// TB/s. The dense-tile work is 2*8,184*16*128*128 = 4.3 GFLOP (the useful
// 2*nnz*k is 1.09 GFLOP): as six split products, 25.8 GFLOP at 495
// TFLOP/s, 52 us (one product on the integer model, 9 us).
// So bytes bound it; the L2 -> shared stream of X slabs (about 3 slabs of
// 64 KB per 128-row group on the band, against one 64 KB slab per A tile
// when each tile row restaged its own) is what the row groups cut.
//
// Narrow form (k <= 32, SpMV first). The TPU pads k to 128 lanes; the
// 128-column form above would then spend 127/128 of its work on padding
// at k = 1. For k <= 32 the caller packs X and Y at a width W of 8, 16 or
// 32 (k rounded up to a power of two) and spmm_narrow_kernel runs: one
// CTA per tile row, A and X streamed through a cp.async ring in shared
// memory, every thread on a k slice of 8 output columns, and the k slices
// of each output summed once in shared memory (see its comment).
// There the bytes bound it: at SpMV on banded65536 the 67 MB of dense
// 16x128 A tiles, about 20 us at 3.35 TB/s, where cuSPARSE's SpMV reads
// about 35 MB of CSR. The tile format's padding is the price of the
// format, not of the kernel.
//
// Limits (checked by the caller, spgemm_tpu_torch/ops/spmm_kernels.py):
//   tm in {8, 16, 32, 64}; any tk >= 1 (16-byte copies of A rows where
//   tk % 4 == 0, 4-byte copies otherwise); k_pad a multiple of 128, or 8,
//   16 or 32 (narrow form); n_blocks*block_rows < 2^31 (grid size);
//   k_pad/128 < 65536. All element offsets are int64.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC spmm_strip.cu -o libspmm_strip.so

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int kThreads = 256;
constexpr int kCols = 128;            // k_pad columns per CTA
constexpr int kNT = kCols / 8;        // n8 column tiles per warp
constexpr int kGroupRows = 128;       // Y rows per CTA: one m16 per warp
constexpr int kXK = 16;               // k depth of one step
constexpr int kStages = 4;            // cp.async ring depth
constexpr int kRestBufs = 2;          // X mid and lo planes: this step and
                                      // the next
constexpr int kXStride = kCols + 8;   // X rows, words: no bank conflicts
constexpr int kAStride = kXK + 4;     // A rows, words: no bank conflicts
constexpr int kSchedCap = 64;         // slabs merged per pass

template <int TM>
struct SpmmCfg {
  static constexpr int R = kGroupRows / TM;        // tile rows per CTA
  static constexpr int XB = kXK * kXStride * 4;    // stage layout, bytes
  static constexpr int AB = kGroupRows * kAStride * 4;
  static constexpr int STAGE = XB + AB;
  static constexpr int SMEM = kStages * STAGE + 2 * kRestBufs * XB;
  static_assert(R * TM == kGroupRows && R <= 32, "rows must fill a group");
  static_assert(XB % 16 == 0 && AB % 16 == 0, "16-byte aligned parts");
};

template <int TM>
__global__ void __launch_bounds__(kThreads, 2)
spmm_strip_kernel(const float* __restrict__ a,
                  const float* __restrict__ xb,
                  const int32_t* __restrict__ aptr,
                  const int32_t* __restrict__ ak,
                  float* __restrict__ y,
                  int64_t gm, int64_t n_rows, int64_t tk, int64_t k_pad) {
  using C = SpmmCfg<TM>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int32_t sched_v[kSchedCap];          // slab of each entry
  __shared__ int32_t sched_g[kSchedCap * C::R];   // each row's tile or -1
  __shared__ int32_t sched_n;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;  // mma fragment row / column group
  const int tig = lane & 3;   // thread in group
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * C::R;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * kCols;
  const int nch = static_cast<int>((tk + kXK - 1) / kXK);
  const bool vec = (tk & 3) == 0;  // A rows 16-byte aligned
  // the warp's m16 rows 16*warp .. +15 of the group are tile rows r_lo
  // (and r_lo + 1 at tm 8)
  const int r_lo = 16 * warp / TM;
  float* rest_buf = reinterpret_cast<float*>(smem + kStages * C::STAGE);

  // merge cursors: lane r < R of warp 0 walks tile row row0 + r
  int cur = 0;
  int end = 0;
  if (warp == 0 && lane < C::R && row0 + lane < gm) {
    cur = aptr[row0 + lane];
    end = aptr[row0 + lane + 1];
  }

  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
  }

  // copies k chunk `step % nch` of schedule entry `step / nch` into stage
  // `buf`: X rows from the entry's slab, A rows from each row's tile
  auto load_step = [&](int buf, int step) {
    int tid = threadIdx.x;  // opaque: offsets recomputed per step
    asm volatile("" : "+r"(tid));
    const int d = step / nch;
    const int64_t k0 = static_cast<int64_t>(step - d * nch) * kXK;
    const int kmax = static_cast<int>(tk - k0 < kXK ? tk - k0 : kXK);
    float* xs = reinterpret_cast<float*>(smem + buf * C::STAGE);
    float* as = reinterpret_cast<float*>(smem + buf * C::STAGE + C::XB);
    const float* xg =
        xb + (static_cast<int64_t>(sched_v[d]) * tk + k0) * k_pad + c0;
#pragma unroll
    for (int j = 0; j < kXK * kCols / 4 / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int kr = i / (kCols / 4);
      const int c = (i % (kCols / 4)) * 4;
      const bool in = kr < kmax;
      cp_async16(xs + kr * kXStride + c, in ? xg + kr * k_pad + c : xb, in);
    }
    const int32_t* gs = sched_g + d * C::R;
    if (vec) {
#pragma unroll
      for (int j = 0; j < kGroupRows * kXK / 4 / kThreads; ++j) {
        const int i = tid + j * kThreads;
        const int m = i / (kXK / 4);
        const int c = (i % (kXK / 4)) * 4;
        const int g = gs[m / TM];
        const bool in = g >= 0 && c < kmax;
        cp_async16(as + m * kAStride + c,
                   in ? a + (static_cast<int64_t>(g) * TM + m % TM) * tk +
                            k0 + c
                      : a,
                   in);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kGroupRows * kXK / kThreads; ++j) {
        const int i = tid + j * kThreads;
        const int m = i / kXK;
        const int c = i % kXK;
        const int g = gs[m / TM];
        const bool in = g >= 0 && c < kmax;
        cp_async4(as + m * kAStride + c,
                  in ? a + (static_cast<int64_t>(g) * TM + m % TM) * tk +
                           k0 + c
                     : a,
                  in);
      }
    }
  };

  // splits the X chunk of stage `buf` exactly into hi (in place), mid
  // and lo (mid/lo buffer pair `lb`); true if any of this thread's
  // values is not a TF32 value
  auto split_x = [&](int buf, int lb) {
    uint32_t* xs = reinterpret_cast<uint32_t*>(smem + buf * C::STAGE);
    uint32_t* xm = reinterpret_cast<uint32_t*>(rest_buf) + lb * (C::XB / 4);
    uint32_t* xl = xm + kRestBufs * (C::XB / 4);
    uint32_t low = 0u;
    // both values a thread splits in flight at tm 64, one at a time
    // below: so each instantiation stays within 128 registers without a
    // spill (ptxas: the unrolled loop spilled at tm 16, the rolled one at
    // tm 64)
#pragma unroll(TM == 64 ? 2 : 1)
    for (int j = 0; j < kXK * kCols / 4 / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int off = (i / (kCols / 4)) * kXStride + (i % (kCols / 4)) * 4;
      uint4 v = *reinterpret_cast<uint4*>(xs + off);
      uint4 h, m, l;
      low |= v.x | v.y | v.z | v.w;
      split3_tf32(__uint_as_float(v.x), h.x, m.x, l.x);
      split3_tf32(__uint_as_float(v.y), h.y, m.y, l.y);
      split3_tf32(__uint_as_float(v.z), h.z, m.z, l.z);
      split3_tf32(__uint_as_float(v.w), h.w, m.w, l.w);
      *reinterpret_cast<uint4*>(xs + off) = h;
      *reinterpret_cast<uint4*>(xm + off) = m;
      *reinterpret_cast<uint4*>(xl + off) = l;
    }
    return (low & kTf32Low) != 0u;
  };

  // the warp's products over stage `buf` (schedule entry d); x_rest: some
  // X value of the chunk is not a TF32 value (has a nonzero mid or lo)
  auto compute_step = [&](int buf, int lb, int d, bool x_rest) {
    const int32_t* gs = sched_g + d * C::R;
    const bool has = gs[r_lo] >= 0 || (TM < 16 && gs[r_lo + 1] >= 0);
    if (!has) return;  // warp-uniform: no tile of the warp's rows here
    const float* as = reinterpret_cast<const float*>(smem + buf * C::STAGE +
                                                     C::XB);
    const uint32_t* xh =
        reinterpret_cast<const uint32_t*>(smem + buf * C::STAGE);
    const uint32_t* xm = reinterpret_cast<const uint32_t*>(rest_buf) +
                         lb * (C::XB / 4);
    const uint32_t* xl = xm + kRestBufs * (C::XB / 4);
    // two k8 steps, not unrolled: one step's fragments live at a time,
    // within the 128-register budget
#pragma unroll 1
    for (int kk = 0; kk < kXK; kk += 8) {
      const float* ap = as + (16 * warp + gid) * kAStride + kk + tig;
      const float af[4] = {ap[0], ap[8 * kAStride], ap[4],
                           ap[8 * kAStride + 4]};
      uint32_t low = 0u;
#pragma unroll
      for (int q = 0; q < 4; ++q) low |= __float_as_uint(af[q]);
      const bool a_rest = __any_sync(0xffffffffu, (low & kTf32Low) != 0u);
      const int b0 = (kk + tig) * kXStride + gid;
      const int b1 = b0 + 4 * kXStride;
      if (!a_rest && !x_rest) {
        // every operand is a TF32 value (integers below 2^11 are): one
        // product each, exact, on the raw bits
        const uint32_t ah[4] = {__float_as_uint(af[0]), __float_as_uint(af[1]),
                                __float_as_uint(af[2]), __float_as_uint(af[3])};
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          mma_tf32(acc[nt], ah, xh[b0 + nt * 8], xh[b1 + nt * 8]);
        }
        continue;
      }
      uint32_t ah[4], am[4], al[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) split3_tf32(af[q], ah[q], am[q], al[q]);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        // the strip kernel's six partial products, smallest first, into a
        // zeroed partial sum, without the terms whose mid or lo is zero
        // throughout; then one round-to-nearest add
        const uint32_t h0 = xh[b0 + nt * 8];
        const uint32_t h1 = xh[b1 + nt * 8];
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        if (a_rest) mma_tf32(part, al, h0, h1);
        if (x_rest) mma_tf32(part, ah, xl[b0 + nt * 8], xl[b1 + nt * 8]);
        if (a_rest && x_rest) {
          mma_tf32(part, am, xm[b0 + nt * 8], xm[b1 + nt * 8]);
        }
        if (a_rest) mma_tf32(part, am, h0, h1);
        if (x_rest) mma_tf32(part, ah, xm[b0 + nt * 8], xm[b1 + nt * 8]);
        mma_tf32(part, ah, h0, h1);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[nt][q] += part[q];
      }
    }
  };

  for (;;) {
    // merge up to kSchedCap slabs of the rows' ak lists (warp 0)
    if (warp == 0) {
      int nd = 0;
      while (nd < kSchedCap) {
        const int mine = cur < end ? ak[cur] : INT_MAX;
        const int v = __reduce_min_sync(0xffffffffu, mine);
        if (v == INT_MAX) break;
        if (lane < C::R) sched_g[nd * C::R + lane] = mine == v ? cur : -1;
        if (lane == 0) sched_v[nd] = v;
        cur += mine == v;
        ++nd;
      }
      if (lane == 0) sched_n = nd;
    }
    __syncthreads();
    const int nd = sched_n;
    if (nd == 0) break;

    // the (slab, k chunk) steps through the ring; chunk s+1 is split
    // while chunk s is multiplied
    const int steps = nd * nch;
#pragma unroll
    for (int p = 0; p < kStages - 1; ++p) {
      if (p < steps) load_step(p, p);
      cp_async_commit();
    }
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk 0 is visible
    bool x_rest_mine = split_x(0, 0);
    for (int step = 0; step < steps; ++step) {
      cp_async_wait<kStages - 3>();
      // chunk step+1 is visible, the split of chunk step too; the buffers
      // the copies and the split below overwrite are no longer read
      const bool x_rest = __syncthreads_or(x_rest_mine) != 0;
      if (step + 1 < steps) x_rest_mine = split_x((step + 1) % kStages,
                                                  (step + 1) % kRestBufs);
      const int next = step + kStages - 1;
      if (next < steps) load_step(next % kStages, next);
      cp_async_commit();
      compute_step(step % kStages, step % kRestBufs, step / nch, x_rest);
    }
    cp_async_wait<0>();
    __syncthreads();  // stages and schedule are free for the next pass
  }

  // Y rows of the group: group row m is Y row row0*TM + m
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int64_t col = c0 + nt * 8 + 2 * tig;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 16 * warp + gid + 8 * h;
      if (row0 + m / TM < n_rows) {
        *reinterpret_cast<float2*>(y + (row0 * TM + m) * k_pad + col) =
            make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
      }
    }
  }
}

template <int TM>
int launch(cudaStream_t stream, const float* a, const float* xb,
           const int32_t* aptr, const int32_t* ak, float* y, int64_t gm,
           int64_t n_rows, int64_t tk, int64_t k_pad) {
  using C = SpmmCfg<TM>;
  // all of the SM's unified L1/shared memory to shared, so two CTAs fit;
  // set once per device
  static bool ready[kMaxDevices] = {};
  const cudaError_t err =
      set_smem_once(spmm_strip_kernel<TM>, C::SMEM, true, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((n_rows + C::R - 1) / C::R),
                  static_cast<unsigned>(k_pad / kCols));
  spmm_strip_kernel<TM><<<grid, kThreads, C::SMEM, stream>>>(
      a, xb, aptr, ak, y, gm, n_rows, tk, k_pad);
  return static_cast<int>(cudaGetLastError());
}

// ---- narrow form: X and Y W = 8, 16 or 32 columns wide (k <= 32) ------
//
// One 256-thread CTA per tile row. The row's A tiles and their X slabs
// stream through a 3-stage cp.async ring in shared memory, in k chunks of
// NarrowCfg::KCH, one barrier per chunk, so two chunks' loads are in
// flight while one is multiplied. Thread t owns A row r = t % tm, columns
// cc*8 .. cc*8+7 of Y and the k slice k = i*KS + ks of each chunk
// (KS = 256 / (tm * W/8) slices), and keeps 8 partial sums in registers
// across all the row's tiles. The lanes of a warp differ in r first, so
// they read one X row segment together (a broadcast) and A words in
// distinct banks. The KS slices of each output are summed once, at the
// end, through shared memory. So the A bytes stream once with many loads
// in flight, and the multiply-adds (8 per 3 shared loads) stay far below
// them. At most 64 registers a thread (__launch_bounds__(256, 4)) keep
// four CTAs, 1,024 threads, on each SM.

constexpr int kNarrowThreads = 256;
constexpr int kNarrowStages = 3;

template <int TM, int W>
struct NarrowCfg {
  static constexpr int CC = W / 8;                        // column groups
  static constexpr int KS = kNarrowThreads / (TM * CC);   // k slices
  static constexpr int KCH = TM * W >= 1024 ? 64 : 128;   // k per stage
  static constexpr int AS = KCH + 4;  // A row stride: 16-byte rows
  static constexpr int STAGE = (TM * AS + KCH * W) * 4;   // bytes
  static constexpr int SMEM = kNarrowStages * STAGE;
  static_assert(CC * 8 == W && KS * TM * CC == kNarrowThreads && KS <= 32 &&
                    (KS & (KS - 1)) == 0 && KCH % KS == 0,
                "the thread layout must cover the tile");
  static_assert((TM * AS * 4) % 16 == 0, "X must stay 16-byte aligned");
  static_assert(KS * TM * W <= SMEM / 4, "the slice sums must fit");
};

template <int TM, int W>
__global__ void __launch_bounds__(kNarrowThreads, 4)
spmm_narrow_kernel(const float* __restrict__ a,
                   const float* __restrict__ xb,
                   const int32_t* __restrict__ aptr,
                   const int32_t* __restrict__ ak,
                   const int32_t* __restrict__ kmin,
                   float* __restrict__ y,
                   int64_t gm, int64_t block_rows, int64_t tk) {
  using C = NarrowCfg<TM, W>;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int r = tid % TM;
  const int cc = (tid / TM) % C::CC;
  const int ks = tid / (TM * C::CC);
  const int64_t row = blockIdx.x;
  float acc[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) acc[q] = 0.f;

  if (row < gm) {
    const int64_t g0 = aptr[row];
    const int64_t nkc = (tk + C::KCH - 1) / C::KCH;
    const int64_t steps = (aptr[row + 1] - g0) * nkc;
    const int64_t klo = kmin != nullptr ? kmin[row / block_rows] : 0;
    const float* xwin = xb + klo * tk * W;
    // chunk c: k0 = (c % nkc) * KCH of tile g0 + c / nkc, into stage buf
    auto load_step = [&](int buf, int64_t c) {
      const int64_t g = g0 + c / nkc;
      const int64_t k0 = (c % nkc) * C::KCH;
      const float* a_g = a + g * TM * tk + k0;
      const float* x_g = xwin + ((ak[g] - klo) * tk + k0) * W;
      float* as = reinterpret_cast<float*>(smem + buf * C::STAGE);
      float* xs = as + TM * C::AS;
      if ((tk & 3) == 0) {  // A rows 16-byte aligned: 16-byte copies
        for (int i = tid; i < TM * C::KCH / 4; i += kNarrowThreads) {
          const int rr = i / (C::KCH / 4);
          const int kk = (i % (C::KCH / 4)) * 4;
          const bool in = k0 + kk < tk;
          cp_async16(as + rr * C::AS + kk, in ? a_g + rr * tk + kk : a, in);
        }
      } else {
#pragma unroll
        for (int j = 0; j < TM * C::KCH / kNarrowThreads; ++j) {
          const int i = tid + j * kNarrowThreads;
          const int rr = i / C::KCH;
          const int kk = i % C::KCH;
          const bool in = k0 + kk < tk;
          cp_async4(as + rr * C::AS + kk, in ? a_g + rr * tk + kk : a, in);
        }
      }
      for (int i = tid; i < C::KCH * W / 4; i += kNarrowThreads) {
        const bool in = k0 + (i * 4) / W < tk;
        cp_async16(xs + i * 4, in ? x_g + i * 4 : xb, in);
      }
    };
#pragma unroll
    for (int p = 0; p < kNarrowStages - 1; ++p) {
      if (p < steps) load_step(p, p);
      cp_async_commit();
    }
    for (int64_t c = 0; c < steps; ++c) {
      cp_async_wait<kNarrowStages - 2>();
      __syncthreads();  // chunk c is visible; chunk c-1's buffer is free
      if (c + kNarrowStages - 1 < steps) {
        load_step(static_cast<int>((c + kNarrowStages - 1) % kNarrowStages),
                  c + kNarrowStages - 1);
      }
      cp_async_commit();
      const float* as = reinterpret_cast<const float*>(
          smem + static_cast<int>(c % kNarrowStages) * C::STAGE);
      const float* xs = as + TM * C::AS;
#pragma unroll
      for (int i = 0; i < C::KCH / C::KS; ++i) {
        const int k = i * C::KS + ks;
        const float av = as[r * C::AS + k];
        const float4* xr = reinterpret_cast<const float4*>(xs + k * W + cc * 8);
        const float4 x0 = xr[0];
        const float4 x1 = xr[1];
        acc[0] = fmaf(av, x0.x, acc[0]);
        acc[1] = fmaf(av, x0.y, acc[1]);
        acc[2] = fmaf(av, x0.z, acc[2]);
        acc[3] = fmaf(av, x0.w, acc[3]);
        acc[4] = fmaf(av, x1.x, acc[4]);
        acc[5] = fmaf(av, x1.y, acc[5]);
        acc[6] = fmaf(av, x1.z, acc[6]);
        acc[7] = fmaf(av, x1.w, acc[7]);
      }
    }
    cp_async_wait<0>();
  }
  // sum the KS slices of each output through shared memory (the stages
  // are free once every thread is past the last chunk), then write the
  // row's tm x W block of Y, coalesced
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // (KS, TM, W)
  float4* mine = reinterpret_cast<float4*>(red + (ks * TM + r) * W + cc * 8);
  mine[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  mine[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  __syncthreads();
  float* y_row = y + row * TM * W;
  for (int o = tid; o < TM * W; o += kNarrowThreads) {
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < C::KS; ++k) v += red[k * TM * W + o];
    y_row[o] = v;
  }
}

template <int TM, int W>
int launch_narrow_w(cudaStream_t stream, const float* a, const float* xb,
                    const int32_t* aptr, const int32_t* ak,
                    const int32_t* kmin, float* y, int64_t gm,
                    int64_t block_rows, int64_t tk, int64_t n_rows) {
  constexpr int smem = NarrowCfg<TM, W>::SMEM;
  static bool ready[kMaxDevices] = {};  // the attribute is set once a device
  const cudaError_t err =
      set_smem_once(spmm_narrow_kernel<TM, W>, smem, false, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  spmm_narrow_kernel<TM, W>
      <<<static_cast<unsigned>(n_rows), kNarrowThreads, smem, stream>>>(
          a, xb, aptr, ak, kmin, y, gm, block_rows, tk);
  return static_cast<int>(cudaGetLastError());
}

template <int TM>
int launch_narrow(int64_t width, cudaStream_t stream, const float* a,
                  const float* xb, const int32_t* aptr, const int32_t* ak,
                  const int32_t* kmin, float* y, int64_t gm,
                  int64_t block_rows, int64_t tk, int64_t n_rows) {
  switch (width) {
    case 8:
      return launch_narrow_w<TM, 8>(stream, a, xb, aptr, ak, kmin, y, gm,
                                    block_rows, tk, n_rows);
    case 16:
      return launch_narrow_w<TM, 16>(stream, a, xb, aptr, ak, kmin, y, gm,
                                     block_rows, tk, n_rows);
    case 32:
      return launch_narrow_w<TM, 32>(stream, a, xb, aptr, ak, kmin, y, gm,
                                     block_rows, tk, n_rows);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted. `kmin` may be
// null (resident form). `k_pad` is the packed width of X and Y: 8, 16 or
// 32 runs the narrow form, a multiple of 128 the 128-column form.
// Launches on `stream`, does not synchronise, allocates nothing.
int spmm_strip_f32(const void* a, const void* xb, const void* aptr,
                   const void* ak, const void* kmin, void* y, int64_t gm,
                   int64_t block_rows, int64_t n_rows, int64_t tm,
                   int64_t tk, int64_t k_pad, void* stream) {
  const bool narrow = k_pad == 8 || k_pad == 16 || k_pad == 32;
  if (n_rows <= 0 || n_rows > INT32_MAX || n_rows < gm || gm < 1 ||
      block_rows < 1 || tk < 1 ||
      (!narrow && (k_pad < kCols || k_pad % kCols != 0 ||
                   k_pad / kCols > 65535))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const auto* av = static_cast<const float*>(a);
  const auto* xv = static_cast<const float*>(xb);
  const auto* ap = static_cast<const int32_t*>(aptr);
  const auto* kk = static_cast<const int32_t*>(ak);
  const auto* km = static_cast<const int32_t*>(kmin);
  auto* yv = static_cast<float*>(y);
  if (narrow) {
    switch (tm) {
      case 64:
        return launch_narrow<64>(k_pad, st, av, xv, ap, kk, km, yv, gm,
                                 block_rows, tk, n_rows);
      case 32:
        return launch_narrow<32>(k_pad, st, av, xv, ap, kk, km, yv, gm,
                                 block_rows, tk, n_rows);
      case 16:
        return launch_narrow<16>(k_pad, st, av, xv, ap, kk, km, yv, gm,
                                 block_rows, tk, n_rows);
      case 8:
        return launch_narrow<8>(k_pad, st, av, xv, ap, kk, km, yv, gm,
                                block_rows, tk, n_rows);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  // the 128-column form reads no kmin: both forms read slab ak[g]
  switch (tm) {
    case 64:
      return launch<64>(st, av, xv, ap, kk, yv, gm, n_rows, tk, k_pad);
    case 32:
      return launch<32>(st, av, xv, ap, kk, yv, gm, n_rows, tk, k_pad);
    case 16:
      return launch<16>(st, av, xv, ap, kk, yv, gm, n_rows, tk, k_pad);
    case 8:
      return launch<8>(st, av, xv, ap, kk, yv, gm, n_rows, tk, k_pad);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
