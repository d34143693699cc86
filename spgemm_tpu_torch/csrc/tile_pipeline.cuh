// The tensor-core tile pipeline shared by the strip kernel
// (strip_numeric.cu) and the pair kernel (pair_accumulate.cu), for sm_90a.
//
// One 256-thread CTA accumulates one TM x 128 chunk of a C tile over a
// stream of 32-deep k steps; the two kernels differ only in how a C tile
// finds its (A tile, B tile) pairs (a scan of its block's slot words, or
// a pair_ptr range), which each passes in as the `load` callback of
// stream_steps.
//
//   load_stage   cp.async 16-byte copies of one step: TM rows of A values
//                and bf16 occupancy (row stride lda), 32 rows of B values
//                and occupancy (row stride ldb, 128 columns), the ragged
//                edge zero-filled;
//   mma_stage    the warp's products over one staged step: values on
//                mma.sync.m16n8k8 as an exact three-way TF32 split (one
//                product on the raw bits where the warp's k step is
//                TF32-exact), counts on bf16 mma.sync.m16n8k16;
//   stream_steps the ring of STAGES buffers in dynamic shared memory,
//                one barrier per step;
//   store_tile   the accumulators into C (row stride ldc).
//
// Tile shapes. A C tile of tm x tn (tm % 8 == 0, tn % 128 == 0) is cut
// into chunks of 128 columns and of TM rows, TM one of the instantiated
// heights 64, 32, 16, 8: as many 64-row chunks as fit, then at most one
// each of 32, 16 and 8 rows (launch_row_parts: 128 = 2 x 64, 40 = 32 +
// 8, 24 = 16 + 8), one launch per height, each from its first row
// row_base. C's rows depend only on A's rows and its columns only on
// B's, so each chunk is an independent product with the same per-element
// accumulation order. A launch runs one CTA per (C tile, row chunk,
// column chunk): blockIdx.y is the row chunk of its height and
// blockIdx.z the column chunk. Each chunk CTA finds its pairs and stages
// its A rows and B columns itself, so a tile of several chunks has its
// pairs looked up, and its B columns staged, once per row chunk.
//
// The build key of every library that includes this file covers its bytes
// (spgemm_tpu_torch/utils/native.py:build_shared_library).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "sm90_common.cuh"

namespace tile_pipeline {

using namespace sm90;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTN = 128;             // C columns per CTA (one column chunk)
constexpr int kKC = 32;              // k depth of one pipeline step
constexpr int kStagesTm64 = 2;       // ring depth at TM 64 (others: 3)
constexpr int kMaxChunks = 65535;    // grid.y and grid.z limit
// shared-memory row strides in elements, padded against bank conflicts
constexpr int kAvStride = kKC + 4;   // f32 A rows: 36 words
constexpr int kAoStride = kKC + 8;   // bf16 A rows: 80 bytes
constexpr int kBvStride = kTN + 8;   // f32 B rows: 136 words
constexpr int kBoStride = kTN + 8;   // bf16 B rows: 272 bytes

// Whether the kernels take a tm x tn tile: tm % 8 == 0, tn % 128 == 0,
// and the grid's y (64-row chunks) and z (column chunks) within its limit.
inline bool tile_taken(int64_t tm, int64_t tn) {
  return tm >= 8 && tm % 8 == 0 && tm / 64 <= kMaxChunks && tn >= kTN &&
         tn % kTN == 0 && tn / kTN <= kMaxChunks;
}

// Launches the row chunks of a tm-row tile, as many 64-row chunks as fit
// and then one each of 32, 16 and 8 rows (sm90_common.cuh).
template <typename F>
inline int launch_row_parts(int64_t tm, F&& launch) {
  return for_each_row_part<64, 32, 16, 8>(tm, launch);
}

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
      // b[][]: the split needs those registers at TM 64
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

// Writes the warp's accumulators into the C chunk at cv / co (TM x 128,
// row stride ldc); rows past TM (the m16 padding at TM 8) are dropped.
template <int TM>
__device__ __forceinline__ void store_tile(float* cv, float* co, int64_t ldc,
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
        const int64_t off = static_cast<int64_t>(row) * ldc + col;
        *reinterpret_cast<float2*>(cv + off) =
            make_float2(acc_v[nt][2 * h], acc_v[nt][2 * h + 1]);
        *reinterpret_cast<float2*>(co + off) =
            make_float2(acc_c[nt][2 * h], acc_c[nt][2 * h + 1]);
      }
    }
  }
}

}  // namespace tile_pipeline
