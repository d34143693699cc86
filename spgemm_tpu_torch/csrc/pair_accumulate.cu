// Per-C-tile pair kernel for Hopper (sm_90a), C ABI for ctypes.
//
// Replaces the Pallas kernel spgemm_tpu/ops/pallas_kernels.py:_pair_kernel
// (:32), reached through pair_accumulate_pallas (:101): the JAX package's
// backend="pallas", one program per C tile over its (A tile, B tile)
// pairs, TileSpGEMM's own per-C-tile shape.
//
// What it computes. For every C tile i < num_segments and every pair
// j in [pair_ptr[i], pair_ptr[i+1]) (build_pair_schedule's order:
// ascending k inside a C tile):
//   c_val[i] += a_val[pa[j]] (tm x tk) . b_val[pb[j]] (tk x tn)
//   c_cnt[i] += a_occ[pa[j]]           . b_occ[pb[j]]
// with c_val, c_cnt (num_segments, tm, tn) f32. A C tile with no pairs
// comes out zero. The occupancy planes are bf16 0/1 (the reference feeds
// f32 0/1; the wrapper converts, exactly); the counts are exact f32 sums
// up to 2^24 products per element and are only ever read as > 0.
//
// What differs from the TPU kernel, and why. The TPU kernel walks the
// pairs with a double-buffered DMA of whole (2, tm, tk) and (2, tk, tn)
// tiles into VMEM and accumulates in its output block, over an in-order
// grid (on the TPU it could only run in interpret mode: its per-pair tile
// DMAs break Mosaic's 128-alignment rule). Here one 256-thread CTA owns
// one C tile and runs the strip kernel's tile pipeline (a copy below):
// the 32-deep k chunks of all its pairs, in schedule order, form one
// stream of steps through a cp.async ring in dynamic shared memory (2
// stages at tm 64, 3 below; rows padded against bank conflicts), so the
// next pair's first chunk is in flight under this pair's last products;
// values multiply on mma.sync.m16n8k8 as the strip kernel's exact
// three-way TF32 split (hi + mid + lo per operand, the six partial
// products above 2^-33 |a.b| into a zeroed partial sum that one
// round-to-nearest add folds into the accumulator; in-place 3xTF32 biased
// long positive sums downward through the mma's truncating alignment and
// left about 2^-22 |a.b| per product), with one product on the raw bits
// where a warp's k step is TF32-exact, which keeps the integer model
// bit-equal to the plain f32 version; counts as bf16 mma.sync.m16n8k16
// on the 0/1 planes. The tm x 128 accumulators live in registers (at most
// 128 a thread, two CTAs per SM) and the tile is written once. No
// atomics, a fixed accumulation order. The strip kernel differs only in
// how a C tile finds its pairs (a scan of its block's slot words).
//
// Any tk >= 1: A rows are read with 16-byte copies, so the wrapper pads
// A's rows to lda = tk rounded up to 8 with zero columns when tk % 8 != 0
// (B's rows are 128 wide, always aligned); the tail chunk's rows past tk
// are zero-filled by cp.async's source size.
//
// What bounds it on the card. On the cant-like 62,451^2 A^2 at 64x128 A
// tiles and 128x128 B tiles (1,950 A and 1,462 B tiles, 5,844 pairs,
// 3,896 C tiles of 1 or 2 pairs each) the reference's f32 planes, each
// read or written once, are 575 MB: A 2 x 64 MB, B 2 x 96 MB, C 2 x 128
// MB, 0.172 ms at 3.35 TB/s. With bf16 occupancy the kernel's own inputs
// and outputs are 495 MB. The operations (5,844 dense 64x128x128
// products: 12.3 GFLOP of TF32 at 495 TFLOP/s on the integer model, six
// times that with split values, and 12.3 GFLOP of bf16 at 989) need
// 0.037-0.162 ms. So the bytes bound it, the C planes most.
//
// Limits (checked by the caller, spgemm_tpu_torch/ops/pair_kernels.py):
//   (tm, tn) in {(8,128), (16,128), (32,128), (64,128)} (tm 8 runs
//   half-empty m16 tiles); any tk >= 1 with lda % 8 == 0, lda >= tk;
//   num_segments < 2^31. All element offsets are int64.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC pair_accumulate.cu -o libpair_accumulate.so

#include <cstdint>
#include <cuda_runtime.h>

#include "sm90_common.cuh"

namespace {

using namespace sm90;

// ---- the tile pipeline (the strip kernel's, strip_numeric.cu, which
// keeps its own copy so that its generated code stays as it was) -------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTN = 128;
constexpr int kKC = 32;              // k depth of one pipeline step
constexpr int kStagesTm64 = 2;       // ring depth at tm 64 (others: 3)
// shared-memory row strides in elements, padded against bank conflicts
constexpr int kAvStride = kKC + 4;   // f32 A rows: 36 words
constexpr int kAoStride = kKC + 8;   // bf16 A rows: 80 bytes
constexpr int kBvStride = kTN + 8;   // f32 B rows: 136 words
constexpr int kBoStride = kTN + 8;   // bf16 B rows: 272 bytes

template <int TM>
struct Cfg {
  // each warp owns one m16 row tile and NT n8 column tiles of C, so one
  // A fragment per k step and the accumulators (2 x NT x 4) stay within
  // 128 registers
  static constexpr int MR = TM < 16 ? 16 : TM;  // rows the m16 tiles cover
  static constexpr int WM = MR / 16;            // warps along m
  static constexpr int WN = kWarps / WM;        // warps along n
  static constexpr int NT = kTN / (8 * WN);     // n8 tiles per warp
  static constexpr int STAGES = TM == 64 ? kStagesTm64 : 3;
  static constexpr int AV = MR * kAvStride * 4;  // stage layout, bytes
  static constexpr int AO = MR * kAoStride * 2;
  static constexpr int BV = kKC * kBvStride * 4;
  static constexpr int BO = kKC * kBoStride * 2;
  static constexpr int STAGE = AV + AO + BV + BO;
  static constexpr int SMEM = STAGES * STAGE;
  static_assert(16 * WM == MR && NT * 8 * WN == kTN && NT % 2 == 0,
                "warp tiling must cover the C tile");
  static_assert(AV % 16 == 0 && AO % 16 == 0 && BV % 16 == 0,
                "stage parts must stay 16-byte aligned");
};

// Copies one step into stage `st`: TM rows of A from av_g / ao_g (row
// stride lda elements, the first kmax_a columns; the rest of the 32 are
// zero-filled) and 32 rows of B from bv_g / bo_g (row stride ldb, the
// first kmax_b rows). kmax_a is a multiple of 8 and every row start is
// 16-byte aligned. The base pointers stand in as the (unread) source of a
// zero-filled copy.
template <int TM>
__device__ __forceinline__ void load_stage(
    unsigned char* st, const float* av_g, const uint16_t* ao_g, int64_t lda,
    int kmax_a, const float* bv_g, const uint16_t* bo_g, int64_t ldb,
    int kmax_b, const float* a_val, const uint16_t* a_occ,
    const float* b_val, const uint16_t* b_occ) {
  using C = Cfg<TM>;
  // an opaque copy of the thread index: the copy offsets below are then
  // recomputed per step instead of held in registers across the loop
  int tid = threadIdx.x;
  asm volatile("" : "+r"(tid));
  float* as_v = reinterpret_cast<float*>(st);
  uint16_t* as_o = reinterpret_cast<uint16_t*>(st + C::AV);
  float* bs_v = reinterpret_cast<float*>(st + C::AV + C::AO);
  uint16_t* bs_o = reinterpret_cast<uint16_t*>(st + C::AV + C::AO + C::BV);
#pragma unroll
  for (int j = 0; j < (TM * kKC / 4 + kThreads - 1) / kThreads; ++j) {
    const int i = tid + j * kThreads;
    const int r = i / (kKC / 4);
    const int c = (i % (kKC / 4)) * 4;
    if (i < TM * kKC / 4) {
      const bool in = c < kmax_a;
      cp_async16(as_v + r * kAvStride + c, in ? av_g + r * lda + c : a_val,
                 in);
    }
  }
#pragma unroll
  for (int j = 0; j < (TM * kKC / 8 + kThreads - 1) / kThreads; ++j) {
    const int i = tid + j * kThreads;
    const int r = i / (kKC / 8);
    const int c = (i % (kKC / 8)) * 8;
    if (i < TM * kKC / 8) {
      const bool in = c < kmax_a;
      cp_async16(as_o + r * kAoStride + c, in ? ao_g + r * lda + c : a_occ,
                 in);
    }
  }
#pragma unroll
  for (int j = 0; j < kKC * kTN / 4 / kThreads; ++j) {
    const int i = tid + j * kThreads;
    const int kr = i / (kTN / 4);
    const int c = (i % (kTN / 4)) * 4;
    const bool in = kr < kmax_b;
    cp_async16(bs_v + kr * kBvStride + c, in ? bv_g + kr * ldb + c : b_val,
               in);
  }
#pragma unroll
  for (int j = 0; j < kKC * kTN / 8 / kThreads; ++j) {
    const int i = tid + j * kThreads;
    const int kr = i / (kTN / 8);
    const int c = (i % (kTN / 8)) * 8;
    const bool in = kr < kmax_b;
    cp_async16(bs_o + kr * kBoStride + c, in ? bo_g + kr * ldb + c : b_occ,
               in);
  }
}

// The warp's mma products over stage `st`: its m16 rows from m0 and NT n8
// column tiles from n0.
template <int TM>
__device__ __forceinline__ void mma_stage(const unsigned char* st,
                                          float (&acc_v)[Cfg<TM>::NT][4],
                                          float (&acc_c)[Cfg<TM>::NT][4],
                                          int m0, int n0, int lane) {
  using C = Cfg<TM>;
  const int gid = lane >> 2;  // mma fragment row / column group
  const int tig = lane & 3;   // thread in group
  const float* as_v = reinterpret_cast<const float*>(st);
  const uint16_t* as_o = reinterpret_cast<const uint16_t*>(st + C::AV);
  const float* bs_v = reinterpret_cast<const float*>(st + C::AV + C::AO);
  const uint16_t* bs_o =
      reinterpret_cast<const uint16_t*>(st + C::AV + C::AO + C::BV);
  // values, four k8 steps (not unrolled: one step's fragments live at a
  // time, within the 128-register budget)
#pragma unroll 1
  for (int kk = 0; kk < kKC; kk += 8) {
    const float* ap = as_v + (m0 + gid) * kAvStride + kk + tig;
    const float* bp = bs_v + (kk + tig) * kBvStride + n0 + gid;
    const float a[4] = {ap[0], ap[8 * kAvStride], ap[4],
                        ap[8 * kAvStride + 4]};
    float b[C::NT][2];
    uint32_t low = 0u;  // the bits TF32 drops, over all fragments
#pragma unroll
    for (int q = 0; q < 4; ++q) low |= __float_as_uint(a[q]);
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) {
      b[nt][0] = bp[nt * 8];
      b[nt][1] = bp[nt * 8 + 4 * kBvStride];
      low |= __float_as_uint(b[nt][0]) | __float_as_uint(b[nt][1]);
    }
    if (!__any_sync(0xffffffffu, (low & kTf32Low) != 0u)) {
      // every operand is a TF32 value (integers below 2^11 are): one
      // product each, exact, on the raw bits
      const uint32_t ah[4] = {__float_as_uint(a[0]), __float_as_uint(a[1]),
                              __float_as_uint(a[2]), __float_as_uint(a[3])};
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
        mma_tf32(acc_v[nt], ah, __float_as_uint(b[nt][0]),
                 __float_as_uint(b[nt][1]));
      }
    } else {
      // B is read from shared memory again below instead of held in
      // b[][]: the split needs those registers at tm 64
      asm volatile("" ::: "memory");
      uint32_t ah[4], am[4], al[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) split3_tf32(a[q], ah[q], am[q], al[q]);
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
        uint32_t bh[2], bm[2], bl[2];
        split3_tf32(bp[nt * 8], bh[0], bm[0], bl[0]);
        split3_tf32(bp[nt * 8 + 4 * kBvStride], bh[1], bm[1], bl[1]);
        // the six partial products above 2^-33 |a.b|, smallest first,
        // into a zeroed partial sum; then one round-to-nearest add
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(part, al, bh[0], bh[1]);
        mma_tf32(part, ah, bl[0], bl[1]);
        mma_tf32(part, am, bm[0], bm[1]);
        mma_tf32(part, am, bh[0], bh[1]);
        mma_tf32(part, ah, bm[0], bm[1]);
        mma_tf32(part, ah, bh[0], bh[1]);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc_v[nt][q] += part[q];
      }
    }
  }
  // counts: bf16 0/1 planes, two k16 steps
#pragma unroll 1
  for (int kk = 0; kk < kKC; kk += 16) {
    uint32_t af[4];
    ldmatrix_x4(af, as_o + (m0 + (lane & 15)) * kAoStride + kk +
                        (lane >> 4) * 8);
#pragma unroll
    for (int nt = 0; nt < C::NT; nt += 2) {
      uint32_t bf[4];
      ldmatrix_x4_trans(
          bf, bs_o + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kBoStride +
                  n0 + nt * 8 + (lane >> 4) * 8);
      mma_bf16(acc_c[nt], af, bf[0], bf[1]);
      mma_bf16(acc_c[nt + 1], af, bf[2], bf[3]);
    }
  }
}

// Runs `steps` steps through the ring in `smem`: load(stage, i) issues
// step i's copies (load_stage), and every warp multiplies each step once
// it has landed. Leaves the ring free (all copies waited for, a barrier).
template <int TM, typename Load>
__device__ __forceinline__ void stream_steps(int steps, unsigned char* smem,
                                             Load&& load,
                                             float (&acc_v)[Cfg<TM>::NT][4],
                                             float (&acc_c)[Cfg<TM>::NT][4],
                                             int m0, int n0, int lane) {
  using C = Cfg<TM>;
#pragma unroll
  for (int p = 0; p < C::STAGES - 1; ++p) {
    if (p < steps) load(smem + p * C::STAGE, p);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // this step's copies are visible; the buffer the
                      // next copies overwrite is no longer read
    const int next = step + C::STAGES - 1;
    if (next < steps) load(smem + (next % C::STAGES) * C::STAGE, next);
    cp_async_commit();
    mma_stage<TM>(smem + (step % C::STAGES) * C::STAGE, acc_v, acc_c, m0, n0,
                  lane);
  }
  cp_async_wait<0>();
  __syncthreads();  // the stages are free for the caller
}

// Writes the warp's accumulators into the C tile at cv / co (TM x 128,
// row-major); rows past TM (the m16 padding at tm 8) are dropped.
template <int TM>
__device__ __forceinline__ void store_tile(float* cv, float* co,
                                           const float (&acc_v)[Cfg<TM>::NT][4],
                                           const float (&acc_c)[Cfg<TM>::NT][4],
                                           int m0, int n0, int lane) {
  using C = Cfg<TM>;
  const int gid = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int nt = 0; nt < C::NT; ++nt) {
    const int col = n0 + nt * 8 + 2 * tig;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + gid + 8 * h;
      if (row < TM) {
        const int64_t off = static_cast<int64_t>(row) * kTN + col;
        *reinterpret_cast<float2*>(cv + off) =
            make_float2(acc_v[nt][2 * h], acc_v[nt][2 * h + 1]);
        *reinterpret_cast<float2*>(co + off) =
            make_float2(acc_c[nt][2 * h], acc_c[nt][2 * h + 1]);
      }
    }
  }
}

// ---- the pair kernel -------------------------------------------------

template <int TM>
__global__ void __launch_bounds__(kThreads, 2)
pair_accumulate_kernel(const float* __restrict__ a_val,
                       const uint16_t* __restrict__ a_occ,
                       const float* __restrict__ b_val,
                       const uint16_t* __restrict__ b_occ,
                       const int32_t* __restrict__ pa,
                       const int32_t* __restrict__ pb,
                       const int32_t* __restrict__ pair_ptr,
                       float* __restrict__ c_val,
                       float* __restrict__ c_cnt, int64_t tk, int64_t lda) {
  using C = Cfg<TM>;
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = (warp / C::WN) * 16;          // the warp's C rows
  const int n0 = (warp % C::WN) * C::NT * 8;   // and columns
  const int64_t seg = blockIdx.x;
  const int64_t lo = pair_ptr[seg];
  const int n_pairs = static_cast<int>(pair_ptr[seg + 1] - lo);
  const int nch = static_cast<int>((tk + kKC - 1) / kKC);

  if (TM < 16) {
    // rows TM..15 of the m16 A tiles are never copied: keep them zero
    uint4* z = reinterpret_cast<uint4*>(smem);
    for (int i = tid; i < C::SMEM / 16; i += kThreads) {
      z[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();  // before any copy lands in the same stages
  }

  float acc_v[C::NT][4];
  float acc_c[C::NT][4];
#pragma unroll
  for (int j = 0; j < C::NT; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      acc_v[j][q] = 0.f;
      acc_c[j][q] = 0.f;
    }
  }

  // copies k chunk `step % nch` of pair lo + step / nch into stage `st`
  auto load_step = [&](unsigned char* st, int step) {
    const int pi = step / nch;
    const int64_t k0 = static_cast<int64_t>(step - pi * nch) * kKC;
    const int64_t a_off = static_cast<int64_t>(pa[lo + pi]) * TM * lda + k0;
    const int64_t b_off = (static_cast<int64_t>(pb[lo + pi]) * tk + k0) * kTN;
    const int kmax_a = static_cast<int>(lda - k0 < kKC ? lda - k0 : kKC);
    const int kmax_b = static_cast<int>(tk - k0 < kKC ? tk - k0 : kKC);
    load_stage<TM>(st, a_val + a_off, a_occ + a_off, lda, kmax_a,
                   b_val + b_off, b_occ + b_off, kTN, kmax_b, a_val, a_occ,
                   b_val, b_occ);
  };
  stream_steps<TM>(n_pairs * nch, smem, load_step, acc_v, acc_c, m0, n0,
                   lane);

  store_tile<TM>(c_val + seg * TM * kTN, c_cnt + seg * TM * kTN, acc_v, acc_c,
                 m0, n0, lane);
}

template <int TM>
int launch(unsigned n_seg, cudaStream_t stream, const float* a_val,
           const uint16_t* a_occ, const float* b_val, const uint16_t* b_occ,
           const int32_t* pa, const int32_t* pb, const int32_t* pair_ptr,
           float* c_val, float* c_cnt, int64_t tk, int64_t lda) {
  using C = Cfg<TM>;
  // all of the SM's unified L1/shared memory to shared, so two CTAs fit;
  // set once per device
  static bool ready[kMaxDevices] = {};
  const cudaError_t err =
      set_smem_once(pair_accumulate_kernel<TM>, C::SMEM, true, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_accumulate_kernel<TM><<<n_seg, kThreads, C::SMEM, stream>>>(
      a_val, a_occ, b_val, b_occ, pa, pb, pair_ptr, c_val, c_cnt, tk, lda);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted (and 0 with
// nothing launched when num_segments is 0). a_occ and b_occ are bf16 0/1;
// a_val and a_occ rows are lda elements apart (lda >= tk, lda % 8 == 0,
// columns past tk zero). Launches on `stream`, does not synchronise,
// allocates nothing.
int pair_accumulate_f32(const void* a_val, const void* a_occ,
                        const void* b_val, const void* b_occ, const void* pa,
                        const void* pb, const void* pair_ptr, void* c_val,
                        void* c_cnt, int64_t num_segments, int64_t tm,
                        int64_t tk, int64_t tn, int64_t lda, void* stream) {
  if (num_segments < 0 || num_segments > INT32_MAX || tk < 1 || tn != kTN ||
      lda < tk || lda % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_segments == 0) return 0;
  const auto n = static_cast<unsigned>(num_segments);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* av = static_cast<const float*>(a_val);
  const auto* ao = static_cast<const uint16_t*>(a_occ);
  const auto* bv = static_cast<const float*>(b_val);
  const auto* bo = static_cast<const uint16_t*>(b_occ);
  const auto* p_a = static_cast<const int32_t*>(pa);
  const auto* p_b = static_cast<const int32_t*>(pb);
  const auto* pp = static_cast<const int32_t*>(pair_ptr);
  auto* cv = static_cast<float*>(c_val);
  auto* cc = static_cast<float*>(c_cnt);
  switch (tm) {
    case 64:
      return launch<64>(n, st, av, ao, bv, bo, p_a, p_b, pp, cv, cc, tk, lda);
    case 32:
      return launch<32>(n, st, av, ao, bv, bo, p_a, p_b, pp, cv, cc, tk, lda);
    case 16:
      return launch<16>(n, st, av, ao, bv, bo, p_a, p_b, pp, cv, cc, tk, lda);
    case 8:
      return launch<8>(n, st, av, ao, bv, bo, p_a, p_b, pp, cv, cc, tk, lda);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The version of pair_accumulate_f32's interface: 2 is the one above (bf16
// occupancy, row stride lda). Libraries built before it export no such
// symbol and take f32 occupancy without lda.
int pair_accumulate_abi(void) { return 2; }

}  // extern "C"
