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
// Tile heights. Any tm % 8 == 0, the tiles the TPU kernels take. Y = A.X
// is row-wise, so a (tm, tk) A tile with tm = q*h is q tiles of height h
// stacked in memory: sub-tile j of tile g is the (h, tk) block at
// a + (g*q + j)*h*tk, and Y's (n_rows, tm, k_pad) layout is (n_rows*q, h,
// k_pad). The kernels are instantiated at h in {8, 16, 32, 64} (the
// largest that divides tm, chunk_rows) and walk "virtual" tile rows
// v = i*q + j: row v takes tile row i's ak list, reads sub-tile j of each
// of its tiles, and writes Y rows v*h .. v*h+h. No copy of A and no other
// plan: the merge stores each row's sub-tile index g*q + j beside the
// slab ak[g]. The q sub-rows of a tall tile row share its ak list, so in
// the 128-column form they land in one row group (when h*q <= 128) and
// each X slab is staged once for all of them.
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
// at k = 1. For k <= 32 the caller packs X and Y at a width W of 1 (SpMV),
// 8, 16 or 32 (k rounded up to a power of two) and spmm_narrow_kernel
// runs (see its comment). What bounds it is bytes, and the dense tiles
// are most of them: at SpMV on banded65536 the 16x128 A tiles hold 67 MB,
// of which only 35 MB lie in 32-byte sectors (8 values of a tile row)
// holding a stored entry; torch.mv reads 34 MB of CSR. So the form reads
// A by sector: the caller packs a sector map (one bit per 32-byte
// sector, from the tile's row masks) beside the tiles, and a thread
// copies its sector only where the sector's bit is set. A skipped sector
// holds zeros, whose products add nothing, unless X holds inf or NaN
// (0*inf is NaN): a batch of steps whose X chunks hold a non-finite value
// reads every sector, so Y stays the dense product's. Bytes alone do not
// set its time, though: a tile row's loads wait on aptr, then on the
// sector map and ak, so the form keeps many rows in flight on each SM,
// their sectors staged by cp.async rather than held in registers. At
// SpMV the X slabs and Y are one column wide (packing them at 8, as
// before, moved and multiplied 8 times the X and Y the product needs).
// Dead ends measured on an H100 (each slower than this form):
// the sectors' A values held in registers (4 or 8 steps a thread, one or
// two rows a CTA), X read through L1 instead of staged, and SpMV at
// width 8.
//
// Limits (checked by the caller, spgemm_tpu_torch/ops/spmm_kernels.py):
//   tm % 8 == 0; any tk >= 1 (16-byte copies of A rows where tk % 4 == 0,
//   4-byte copies otherwise; the narrow form's sectors 16-byte copies
//   where tk % 8 == 0); k_pad a multiple of 128, or 1, 8, 16 or 32
//   (narrow form, with its sector map); n_blocks*block_rows*q < 2^31 (the
//   virtual rows) and ntA_pad*q < 2^31 (sub-tile indices); k_pad/128 <
//   65536. All element offsets are int64.
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

// The sub-tile height for A tiles of tm rows: the largest instantiated
// height that divides tm; 0 where tm % 8 != 0.
constexpr int chunk_rows(int64_t tm) {
  return tm % 64 == 0 ? 64 : tm % 32 == 0 ? 32 : tm % 16 == 0 ? 16
         : tm % 8 == 0 ? 8 : 0;
}

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
                  int64_t gm, int64_t n_rows, int64_t tk, int64_t k_pad,
                  int64_t n_sub) {
  // gm and n_rows count virtual rows (tile rows times n_sub); TM is
  // the sub-tile height
  using C = SpmmCfg<TM>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int32_t sched_v[kSchedCap];          // slab of each entry
  __shared__ int32_t sched_g[kSchedCap * C::R];   // each row's sub-tile or -1
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

  // merge cursors: lane r < R of warp 0 walks virtual row row0 + r, sub
  // j of tile row i
  int cur = 0;
  int end = 0;
  int sub = 0;
  if (warp == 0 && lane < C::R && row0 + lane < gm) {
    const int64_t i = (row0 + lane) / n_sub;
    sub = static_cast<int>(row0 + lane - i * n_sub);
    cur = aptr[i];
    end = aptr[i + 1];
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
        if (lane < C::R) {
          sched_g[nd * C::R + lane] =
              mine == v ? cur * static_cast<int>(n_sub) + sub : -1;
        }
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
           int64_t n_rows, int64_t tk, int64_t k_pad, int64_t n_sub) {
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
      a, xb, aptr, ak, y, gm, n_rows, tk, k_pad, n_sub);
  return static_cast<int>(cudaGetLastError());
}

// ---- narrow form: X and Y W = 1, 8, 16 or 32 columns wide (k <= 32) ---
//
// A 256-thread CTA runs two virtual tile rows (sub-tiles of TM rows), one
// in each 128-thread half; the halves share nothing and sync on their own
// named barriers. In a half, thread (r, q) owns A row r of the sub-tile
// and one 32-byte sector, values 8q .. 8q+7, of each k chunk of KC = 8*Q
// values (Q = 128/TM threads a row), so the sector map's bit for that
// sector alone decides whether the thread reads anything, and the warp's
// copies of a step cover whole sectors of consecutive rows. Steps (tile,
// k chunk) go in batches of NB. The thread copies its occupied sectors of
// the batch into shared memory with cp.async (nothing is read for an
// empty sector), while the half copies the batch's X chunks (KC rows of W
// floats) beside them; so a row's loads are all in flight at once and
// hold no registers, and more rows fit on a SM. Each thread checks the X
// values it copied for inf or NaN and one barrier ORs those checks: where
// X held one, the skipped sectors of the batch are copied too, so 0*inf
// and 0*NaN give the NaN the dense product gives. Then the products of
// each loaded sector with its eight X rows into W running sums; the Q
// partial sums of each output are added by shuffles at the end and each Y
// row is written once. No atomics. What the form waits on is latency (a
// row's loads depend on aptr, then on the sector map and ak), which the
// rows in flight on each SM hide.

constexpr int kNarrowThreads = 256;
constexpr int kNarrowHalf = 128;  // threads on one virtual row

template <int TM, int W>
struct NarrowCfg {
  static constexpr int Q = kNarrowHalf / TM;     // threads on one A row
  static constexpr int KC = 8 * Q;               // k of one step
  // a staged X row of W floats at k*W + (k/8)*4: the pad of 4 floats
  // every 8 rows puts each thread's sector rows in their own banks
  static constexpr int XSTEP = KC * W + KC / 2;  // floats a staged step
  static constexpr int X4 = KC * W / 4;          // float4 copies a step
  static constexpr int VPR = W >= 4 ? W / 4 : 1;  // float4s a row (W >= 4)
  static constexpr int RPV = W >= 4 ? 1 : 4 / W;  // rows a float4 (W 1)
  static constexpr int ASTEP = kNarrowHalf * 8;  // floats of A a step
  // steps a batch: 4, fewer where the two halves' stages would pass 96 KB
  static constexpr int NB_FIT = 12288 / (XSTEP + ASTEP);
  static constexpr int NB = NB_FIT < 1 ? 1 : NB_FIT < 4 ? NB_FIT : 4;
  static constexpr int SMEM = 2 * NB * (XSTEP + ASTEP) * 4;  // bytes
  static constexpr int MIN_CTAS = W <= 8 ? 4 : 2;
  static_assert(Q * TM == kNarrowHalf && Q >= 2 && (Q & (Q - 1)) == 0,
                "a row's threads must be a power-of-two part of a warp");
  // the staged offset of float4 copy i of a step: row kr = (i/VPR)*RPV,
  // column 4*(i%VPR), a pad of 4 floats after every 8 rows
  static __device__ __forceinline__ int x_off(int i) {
    const int kr = (i / VPR) * RPV;
    return kr * W + (kr / 8) * 4 + 4 * (i % VPR);
  }
};

__device__ __forceinline__ bool nonfinite(float v) {
  return (__float_as_uint(v) & 0x7f800000u) == 0x7f800000u;
}

// copies the `left` (<= 8) A values at p into the thread's 8 staged
// floats at dst, zero past `left`; 16-byte copies with `vec` (p then
// 16-byte aligned and left == 8)
__device__ __forceinline__ void copy_sector(float* dst, const float* p,
                                            int left, bool vec) {
  if (vec) {
    sm90::cp_async16(dst, p, true);
    sm90::cp_async16(dst + 4, p + 4, true);
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) sm90::cp_async4(dst + i, i < left ? p + i : p,
                                              i < left);
}

// barrier `id` over the 128 threads of one half; returns whether any of
// them passed `pred`
__device__ __forceinline__ bool half_sync_or(int id, bool pred) {
  uint32_t any;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.u32 q, %1, 0;\n"
      "barrier.red.or.pred p, %2, %3, q;\nselp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(any)
      : "r"(static_cast<uint32_t>(pred)), "r"(id), "n"(kNarrowHalf)
      : "memory");
  return any != 0;
}

__device__ __forceinline__ void half_sync(int id) {
  asm volatile("barrier.sync %0, %1;\n" ::"r"(id), "n"(kNarrowHalf)
               : "memory");
}

template <int TM, int W>
__global__ void __launch_bounds__(kNarrowThreads, NarrowCfg<TM, W>::MIN_CTAS)
spmm_narrow_kernel(const float* __restrict__ a,
                   const float* __restrict__ xb,
                   const int32_t* __restrict__ aptr,
                   const int32_t* __restrict__ ak,
                   const uint32_t* __restrict__ smap,
                   float* __restrict__ y, int64_t gm, int64_t tk,
                   int64_t n_sub, int64_t n_rows, int64_t map_words) {
  // gm counts tile rows, n_rows virtual rows (sub of tile row ti)
  using C = NarrowCfg<TM, W>;
  extern __shared__ __align__(16) unsigned char narrow_smem[];
  const int half = threadIdx.x / kNarrowHalf;
  const int tid = threadIdx.x % kNarrowHalf;
  const int bar = 1 + half;  // named barrier of the half
  const int q = tid % C::Q;
  const int r = tid / C::Q;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 2 + half;
  if (row >= n_rows) return;
  const int64_t ti = row / n_sub;
  const int64_t sub = row - ti * n_sub;
  // the half's stage: NB X chunks, then NB steps of A sectors (a thread's
  // 8 floats at tid*8)
  float* xs = reinterpret_cast<float*>(narrow_smem) +
              half * C::NB * (C::XSTEP + C::ASTEP);
  float* as = xs + C::NB * C::XSTEP + tid * 8;
  // the thread's bit of a tile's sector map at k chunk 0: (tm, ceil(tk/8))
  // bits a tile
  const int64_t bit0 = (sub * TM + r) * ((tk + 7) / 8) + q;
  const bool vec = (tk & 7) == 0;
  float acc[W];
#pragma unroll
  for (int c = 0; c < W; ++c) acc[c] = 0.f;

  if (ti < gm) {
    int g = aptr[ti];                 // tile and k chunk of the next step
    const int g_end = aptr[ti + 1];
    int k0 = 0;
    // the thread's sector of tile g, k chunk k0: a_row + g*n_sub*TM*tk + k0
    const float* a_row = a + (sub * TM + r) * tk + 8 * q;
    while (g < g_end) {
      // the batch's steps (tile, k chunk), then their sector words and
      // slabs, then the copies of the occupied sectors and the X chunks
      int gs[C::NB];
      int ks[C::NB];
      int nb = 0;
#pragma unroll
      for (int j = 0; j < C::NB; ++j) {
        gs[j] = g;
        ks[j] = k0;
        if (g < g_end) {
          nb = j + 1;
          k0 += C::KC;
          if (k0 >= tk) {
            k0 = 0;
            ++g;
          }
        }
      }
      uint32_t word[C::NB];
      int slab[C::NB];
#pragma unroll
      for (int j = 0; j < C::NB; ++j) {
        word[j] = 0u;
        slab[j] = 0;
        if (j < nb) {
          const int64_t b = bit0 + ks[j] / 8;
          if (ks[j] + 8 * q < tk) {
            word[j] = smap[static_cast<int64_t>(gs[j]) * map_words +
                           (b >> 5)] >> (b & 31);
          }
          slab[j] = ak[gs[j]];
        }
      }
      unsigned used = 0u;  // bit j: step j's sector is copied
#pragma unroll
      for (int j = 0; j < C::NB; ++j) {
        const int64_t k = ks[j] + 8 * q;
        const int left = j < nb && k < tk ? (tk - k < 8 ? static_cast<int>(
                                                              tk - k)
                                                        : 8)
                                          : 0;
        if (left > 0 && (word[j] & 1u)) {
          used |= 1u << j;
          copy_sector(as + j * C::ASTEP, a_row + gs[j] * n_sub * TM * tk +
                                             ks[j], left, vec);
        }
        if (j < nb) {
          // stage the chunk's X rows (zero past tk): row kr at
          // kr*W + (kr/8)*4
          const float* xg =
              xb + (static_cast<int64_t>(slab[j]) * tk + ks[j]) * W;
          if (W == 1 && (tk & 3) != 0) {
            // X rows not 16-byte aligned: 4-byte copies
            for (int i = tid; i < C::KC; i += kNarrowHalf) {
              const bool in = ks[j] + i < tk;
              sm90::cp_async4(xs + j * C::XSTEP + i + (i / 8) * 4,
                              in ? xg + i : xb, in);
            }
          } else {
            for (int i = tid; i < C::X4; i += kNarrowHalf) {
              const bool in = ks[j] + (i / C::VPR) * C::RPV < tk;
              sm90::cp_async16(xs + j * C::XSTEP + C::x_off(i),
                               in ? xg + 4 * i : xb, in);
            }
          }
        }
      }
      sm90::cp_async_commit();
      sm90::cp_async_wait<0>();
      // the X values this thread copied, then the half's OR of the checks
      // (the barrier also makes every copy visible)
      bool bad = false;
#pragma unroll
      for (int j = 0; j < C::NB; ++j) {
        if (j >= nb) continue;
        for (int i = tid; i < C::X4; i += kNarrowHalf) {
          const float4 x = *reinterpret_cast<const float4*>(
              xs + j * C::XSTEP + C::x_off(i));
          bad |= nonfinite(x.x) || nonfinite(x.y) || nonfinite(x.z) ||
                 nonfinite(x.w);
        }
      }
      if (half_sync_or(bar, bad)) {
        // inf or NaN in X: every sector of the batch, as the dense
        // product reads them
#pragma unroll
        for (int j = 0; j < C::NB; ++j) {
          const int64_t k = ks[j] + 8 * q;
          if (j < nb && k < tk && !(used >> j & 1u)) {
            used |= 1u << j;
            copy_sector(as + j * C::ASTEP,
                        a_row + gs[j] * n_sub * TM * tk + ks[j],
                        tk - k < 8 ? static_cast<int>(tk - k) : 8, vec);
          }
        }
        sm90::cp_async_commit();
        sm90::cp_async_wait<0>();
      }
#pragma unroll
      for (int j = 0; j < C::NB; ++j) {
        if (!(used >> j & 1u)) continue;
        const int64_t k = ks[j] + 8 * q;
        const int left = tk - k < 8 ? static_cast<int>(tk - k) : 8;
        const float4 a0 = *reinterpret_cast<const float4*>(as + j * C::ASTEP);
        const float4 a1 =
            *reinterpret_cast<const float4*>(as + j * C::ASTEP + 4);
        const float v[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float* xr = xs + j * C::XSTEP + q * (8 * W + 4);
        if constexpr (W == 1) {
          // the sector's 8 X values lie next to each other
          const float4 x0 = *reinterpret_cast<const float4*>(xr);
          const float4 x1 = *reinterpret_cast<const float4*>(xr + 4);
          const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (i < left) acc[0] = fmaf(v[i], x[i], acc[0]);
          }
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (i < left) {
#pragma unroll
              for (int c = 0; c < W / 4; ++c) {
                const float4 x =
                    *reinterpret_cast<const float4*>(xr + i * W + 4 * c);
                acc[4 * c] = fmaf(v[i], x.x, acc[4 * c]);
                acc[4 * c + 1] = fmaf(v[i], x.y, acc[4 * c + 1]);
                acc[4 * c + 2] = fmaf(v[i], x.z, acc[4 * c + 2]);
                acc[4 * c + 3] = fmaf(v[i], x.w, acc[4 * c + 3]);
              }
            }
          }
        }
      }
      if (g < g_end) half_sync(bar);  // the stage is free for the next batch
    }
  }
  // the Q partial sums of each output (the row's Q lanes, Q-aligned in
  // the warp), then lane q writes columns q, q+Q, ... of its Y row
#pragma unroll
  for (int c = 0; c < W; ++c) {
#pragma unroll
    for (int o = C::Q / 2; o > 0; o >>= 1) {
      acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], o);
    }
  }
  float* y_row = y + (row * TM + r) * W;
#pragma unroll
  for (int c = 0; c < W; ++c) {
    if (c % C::Q == q) y_row[c] = acc[c];
  }
}

template <int TM, int W>
int launch_narrow_w(cudaStream_t stream, const float* a, const float* xb,
                    const int32_t* aptr, const int32_t* ak,
                    const uint32_t* smap, float* y, int64_t gm, int64_t tk,
                    int64_t n_rows, int64_t n_sub, int64_t map_words) {
  // n_rows counts virtual rows, two a CTA; the stage is dynamic shared
  // memory (past 48 KB at some widths), the carveout all shared, set once
  // a device
  using C = NarrowCfg<TM, W>;
  static bool ready[kMaxDevices] = {};
  const cudaError_t err =
      set_smem_once(spmm_narrow_kernel<TM, W>, C::SMEM, true, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  spmm_narrow_kernel<TM, W>
      <<<static_cast<unsigned>((n_rows + 1) / 2), kNarrowThreads, C::SMEM,
         stream>>>(a, xb, aptr, ak, smap, y, gm, tk, n_sub, n_rows,
                   map_words);
  return static_cast<int>(cudaGetLastError());
}

template <int TM>
int launch_narrow(int64_t width, cudaStream_t stream, const float* a,
                  const float* xb, const int32_t* aptr, const int32_t* ak,
                  const uint32_t* smap, float* y, int64_t gm, int64_t tk,
                  int64_t n_rows, int64_t n_sub, int64_t map_words) {
  switch (width) {
    case 1:
      return launch_narrow_w<TM, 1>(stream, a, xb, aptr, ak, smap, y, gm,
                                    tk, n_rows, n_sub, map_words);
    case 8:
      return launch_narrow_w<TM, 8>(stream, a, xb, aptr, ak, smap, y, gm,
                                    tk, n_rows, n_sub, map_words);
    case 16:
      return launch_narrow_w<TM, 16>(stream, a, xb, aptr, ak, smap, y, gm,
                                     tk, n_rows, n_sub, map_words);
    case 32:
      return launch_narrow_w<TM, 32>(stream, a, xb, aptr, ak, smap, y, gm,
                                     tk, n_rows, n_sub, map_words);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted. `kmin` may be
// null (resident form); neither form reads it (both read slab ak[g]).
// `smap` is the narrow form's sector map, (ntA_pad, ceil(tm*ceil(tk/8)/32))
// uint32 words (bit (r*ceil(tk/8) + s) of a tile's words: row r's values
// 8s .. 8s+7 hold a stored entry); the 128-column form does not read it.
// `k_pad` is the packed width of X and Y: 1, 8, 16 or 32 runs the narrow
// form, a multiple of 128 the 128-column form. `tm` is any multiple of 8:
// the kernels run its sub-tiles of height chunk_rows(tm). Launches on
// `stream`, does not synchronise, allocates nothing.
int spmm_strip_f32(const void* a, const void* xb, const void* aptr,
                   const void* ak, const void* kmin, const void* smap,
                   void* y, int64_t gm, int64_t block_rows, int64_t n_rows,
                   int64_t tm, int64_t tk, int64_t k_pad, void* stream) {
  (void)kmin;
  const bool narrow = k_pad == 1 || k_pad == 8 || k_pad == 16 || k_pad == 32;
  const int h = tm >= 8 ? chunk_rows(tm) : 0;
  const int64_t q = h > 0 ? tm / h : 0;
  if (h == 0 || n_rows <= 0 || n_rows > INT32_MAX / q || n_rows < gm ||
      gm < 1 || block_rows < 1 || tk < 1 || (narrow && smap == nullptr) ||
      (!narrow && (k_pad < kCols || k_pad % kCols != 0 ||
                   k_pad / kCols > 65535))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const auto* av = static_cast<const float*>(a);
  const auto* xv = static_cast<const float*>(xb);
  const auto* ap = static_cast<const int32_t*>(aptr);
  const auto* kk = static_cast<const int32_t*>(ak);
  auto* yv = static_cast<float*>(y);
  const int64_t rows_v = n_rows * q;  // virtual rows
  if (narrow) {
    const auto* sm = static_cast<const uint32_t*>(smap);
    const int64_t words = (tm * ((tk + 7) / 8) + 31) / 32;
    switch (h) {
      case 64:
        return launch_narrow<64>(k_pad, st, av, xv, ap, kk, sm, yv, gm, tk,
                                 rows_v, q, words);
      case 32:
        return launch_narrow<32>(k_pad, st, av, xv, ap, kk, sm, yv, gm, tk,
                                 rows_v, q, words);
      case 16:
        return launch_narrow<16>(k_pad, st, av, xv, ap, kk, sm, yv, gm, tk,
                                 rows_v, q, words);
      default:
        return launch_narrow<8>(k_pad, st, av, xv, ap, kk, sm, yv, gm, tk,
                                rows_v, q, words);
    }
  }
  // the 128-column form reads no kmin: both forms read slab ak[g]
  const int64_t gm_v = gm * q;
  switch (h) {
    case 64:
      return launch<64>(st, av, xv, ap, kk, yv, gm_v, rows_v, tk, k_pad, q);
    case 32:
      return launch<32>(st, av, xv, ap, kk, yv, gm_v, rows_v, tk, k_pad, q);
    case 16:
      return launch<16>(st, av, xv, ap, kk, yv, gm_v, rows_v, tk, k_pad, q);
    default:
      return launch<8>(st, av, xv, ap, kk, yv, gm_v, rows_v, tk, k_pad, q);
  }
}

}  // extern "C"
