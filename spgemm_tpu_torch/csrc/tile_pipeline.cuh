// The tile pipeline shared by the strip kernel (strip_numeric.cu) and the
// pair kernel (pair_accumulate.cu), for sm_90a: persistent, warp-
// specialised, TMA-fed, with tf32 wgmma on the transposed product.
//
// Both kernels compute, for a C tile, the sum of its pairs' products
//   c_val += A_val[ga] . B_val[gb][:, bcol : bcol + tn]
//   c_cnt += A_occ[ga] . B_occ[gb][:, bcol : bcol + tn]
// with A tiles (tm, tk) f32 and bf16 0/1 occupancy (row stride lda), B
// tiles (tk, ldb) likewise, and C (tm, tn) f32. They differ only in how a
// C tile finds its pairs: the strip kernel by an ordered scan of its
// block's slot words, the pair kernel from a pair_ptr range. Each passes
// that lookup in as a Walk (run_items: `pairs`).
//
// Work items. A tm x tn C tile is cut into chunks of H rows and 128
// columns, H one of the instantiated heights 64, 32, 16, 8: as many
// 64-row chunks as fit, then at most one each of 32, 16 and 8 rows
// (launch_row_parts: 128 = 2 x 64, 40 = 32 + 8, 24 = 16 + 8), one launch
// per height, each from its first row row_base. A launch's items are
// (C tile, column chunk cc, row chunk rc), numbered item = (tile * n_cc +
// cc) * n_rc + rc (item_coords); one CTA per SM takes items blockIdx.x,
// blockIdx.x + gridDim.x, ... in turn. Every item writes its whole chunk,
// as zero where no pair reaches it, so the wrappers allocate C with
// torch.empty.
//
// The transposed product. The CTA computes the chunk as C^T = B^T . A^T
// with wgmma: the chunk's 128 columns are wgmma's M, 64 for each of two
// consumer warpgroups, and its H rows wgmma's N (m64nHk8), so 8- and
// 16-row chunks need no padding. A^T is the shared-memory B operand: A's
// rows are k-contiguous, which is the K-major layout tf32 wgmma requires,
// loaded by TMA in the 128-byte swizzle. B^T is the register A operand,
// read from the N-major B stage with ld.shared: each B column belongs to
// one consumer thread, so each B value is loaded, and split, once.
//
// Arithmetic (unchanged from the mma.sync pipeline this replaced).
//   Values: each f32 operand x is split exactly into three TF32 values,
//   hi = rna(x), mid = rna(x - hi), lo = x - hi - mid. Per k8 step the six
//   partial products larger than 2^-33 |a.b| (lo.hi, hi.lo, mid.mid,
//   mid.hi, hi.mid, hi.hi: a's part first, smallest first) go into a
//   zeroed partial accumulator (scale-d 0 on the first), which one
//   round-to-nearest f32 add folds into the tile's accumulator. Two
//   partial accumulators alternate, so step j's products run while step
//   j-1's partial is folded. (Accumulating in place lets the tensor core's
//   truncating alignment lose up to an ulp of the running sum per
//   product, always downward: long positive sums then miss rtol 1e-5.)
//   Each stage has one flag: the OR of the 13 low bits of every staged A
//   and B value, reduced over the consumer threads by a named barrier.
//   Where it is zero, every operand is already a TF32 value (integers
//   below 2^11, the bench's value model) and each k8 step is one product
//   on the raw bits, accumulated in place: every product and partial sum
//   is then an integer below 2^24, so C equals the plain f32 version bit
//   for bit. Otherwise the consumer threads split A once into hi/mid/lo
//   planes in shared memory (the same swizzled positions, so no layout
//   arithmetic), then fence.proxy.async and a second barrier.
//   Counts: bf16 wgmma (m64nHk16) on the 0/1 planes, both operands from
//   shared memory: the B occupancy as an M-major (transposed) A operand,
//   which bf16 allows, and the A occupancy K-major in the 64-byte swizzle
//   (a 32-deep bf16 row is 64 bytes). Exact f32 counts, read only as > 0.
//
// Warp roles. One 384-thread CTA per SM: warps 0-7 are the two consumer
// warpgroups (setmaxnreg 232: an accumulator, two partials and the counts
// are 4 x H/2 registers a thread); the producer warpgroup drops to 40
// registers, and of it warp 9 looks up pairs, warp 8's lane 0 issues TMA
// loads and the rest leave. The lookup warp walks the CTA's items ahead
// of the others: 32 slot words (or pair_ptr entries) a ballot pass, each
// hit's B tile read by its own lane, the hits compacted in order into a
// ring of kNR records of up to 32 pairs (an item takes as many as it
// needs, the last marked), each guarded by a full and an empty mbarrier.
// The TMA thread issues, per record pair and 32-deep k chunk, one stage
// of loads (A values H x 32 f32, A occupancy H x 32 bf16, B values 32 x
// 128 f32 as four 32-column boxes, B occupancy as two 64-column boxes)
// into a ring of STAGES buffers whose mbarriers run across records and
// items, so the next item's first stages land while this item's last
// products and its store run. TMA boxes lie inside maps whose inner
// dimensions are the tiles' own (k < tk for A, k < tk rows of B), so a
// ragged k tail is zero-filled and never read from the next tile's rows.
// The consumers read each record's pair count, then take its stages:
// all 256 consumer threads load the stage's A values and B^T fragments,
// OR their low bits (a named-barrier reduction); a split stage then
// writes A's hi/mid/lo planes (a fence and a second barrier), and a
// stage's wgmma groups are issued and all waited for within the stage
// (groups left in flight past the branch merge, or the next stage
// prepared under this one's last group, made ptxas serialise the wgmmas:
// C7515, C7513). An item's chunk leaves by TMA stores from swizzled
// shared memory below 64 rows (each warpgroup its 64 columns, the next
// item's products running while the stores drain), and straight from the
// registers at 64 rows, where the 64 KB of staging would cost a ring
// stage and registers that spill.
//
// The build key of every library that includes this file covers its bytes
// (spgemm_tpu_torch/utils/native.py:build_shared_library).

#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "sm90_async.cuh"
#include "sm90_common.cuh"

namespace tile_pipeline {

using namespace sm90;

constexpr int kTN = 128;            // C columns per item
constexpr int kWM = 64;             // of them each consumer warpgroup's
constexpr int kKC = 32;             // k depth of a stage: 128 bytes of f32
constexpr int kThreads = 384;       // two consumer warpgroups, a producer
constexpr int kConsumerThreads = 256;
constexpr int kTmaWarp = 8;         // the producer warpgroup's TMA warp
constexpr int kLookupWarp = 9;      // and its pair-lookup warp
constexpr int kProducerRegs = 40;   // setmaxnreg: 168 a thread at launch
constexpr int kConsumerRegs = 232;
constexpr int kSplitBarrier = 1;    // named barrier of the consumers
constexpr int kStoreBarrier = 2;    // and of each consumer warpgroup (2, 3)
constexpr int kNR = 8;              // pair records in flight
constexpr int kRecPairs = 32;       // pairs a record holds
constexpr int kMaxStages = 8;
constexpr int kMaxChunks = 65535;   // row and column chunks a tile
constexpr int kSmemPerCta = 232448; // an H100 CTA's shared memory at most
constexpr int kBBox = kKC * 128;    // one B box: 32 k rows of 128 bytes

// Whether the kernels take a tm x tn tile: tm % 8 == 0, tn % 128 == 0,
// and at most kMaxChunks 64-row and 128-column chunks (ops/kernels.py:
// chunk_grid mirrors it).
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

// One stage of the ring at chunk height H, byte offsets from its start
// (each swizzled region 1 KB aligned): the A value planes hi (where TMA
// lands the raw values, split in place), mid and lo (H rows of 128
// bytes), the A occupancy (H rows of 64 bytes), four B value boxes and
// two B occupancy boxes (32 rows of 128 bytes each).
template <int H>
struct Stage {
  static constexpr int A = H * 128;
  static constexpr int AO = H * 64;
  static constexpr int AO_OFF = 3 * A;
  static constexpr int B_OFF = (AO_OFF + AO + 1023) / 1024 * 1024;
  static constexpr int BO_OFF = B_OFF + 4 * kBBox;
  static constexpr int BYTES = BO_OFF + 2 * kBBox;
  static constexpr int TX = A + AO + 6 * kBBox;  // bytes TMA writes
  // the chunk's C on its way out below 64 rows: per consumer warpgroup its
  // 64 columns of values and counts as four TMA store boxes of 32 columns x
  // H rows (at 64 rows the 64 KB it would take, one stage of the ring and
  // the registers its writes hold cost more than the stores it frees)
  static constexpr bool STAGED_OUT = H < 64;
  static constexpr int C_BOX = H * 128;
  static constexpr int C_OUT = STAGED_OUT ? 2 * 4 * C_BOX : 0;
  // 1 KB of alignment slack, C's staging, the pair records, the mbarriers
  static constexpr int RECS = kNR * (8 + 12 * kRecPairs);
  static constexpr int FIXED = 1024 + C_OUT + RECS +
                               (2 * kMaxStages + 2 * kNR) * 8;
  static constexpr int FIT = (kSmemPerCta - FIXED) / BYTES;
  static constexpr int STAGES = FIT < kMaxStages ? FIT : kMaxStages;
  static constexpr int SMEM = 1024 + STAGES * BYTES + C_OUT + RECS +
                              (2 * STAGES + 2 * kNR) * 8;
  static_assert(AO_OFF % 1024 == 0 && BYTES % 1024 == 0 && STAGES >= 2,
                "stage layout");
};

struct Items {
  int64_t n_items, n_cc, n_rc, row_base, tm, tn;
  float* c_val;  // C (n_c, tm, tn), written directly at 64-row chunks
  float* c_cnt;
  int nch;  // 32-deep k chunks a pair
};

// One published slice of an item's pair list: n pairs (A tile, B tile, B
// column block's first column), `last` on the item's final slice. An item
// with more than kRecPairs pairs takes several records; one with none
// takes one record of n = 0.
struct Record {
  int32_t n, last;
  int32_t ga[kRecPairs], gb[kRecPairs], bcol[kRecPairs];
};

// (C tile, column chunk, first row) of item `item`
__device__ __forceinline__ void item_coords(const Items& q, int64_t item,
                                            int H, int64_t& tile, int& cc,
                                            int64_t& row_off) {
  const int64_t per_tile = q.n_cc * q.n_rc;
  tile = item / per_tile;
  const int64_t rest = item - tile * per_tile;
  cc = static_cast<int>(rest / q.n_rc);
  row_off = q.row_base + (rest - static_cast<int64_t>(cc) * q.n_rc) * H;
}

// `even` for an even J, `odd` for an odd one
template <int J, typename T>
__device__ __forceinline__ T& pick(T& even, T& odd) {
  if constexpr (J % 2 == 0) {
    return even;
  } else {
    return odd;
  }
}

template <int R>
__device__ __forceinline__ void fold(float (&acc)[R], float (&part)[R]) {
  fence_regs(acc);
  fence_regs(part);
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
}

// The persistent CTA (see the top of the file). `walk.pairs(tile, lane,
// emit)` runs in every lane of the lookup warp and calls emit(hit, ga, gb,
// bcol) once a pass, in every lane, each hitting lane giving one of the
// tile's pairs (A tile, B tile, first column of the B tile's column
// block); the passes and, within one, the lanes are in accumulation order.
template <int H, typename Walk>
__device__ __forceinline__ void run_items(
    unsigned char* smem_raw, const CUtensorMap* map_a,
    const CUtensorMap* map_ao, const CUtensorMap* map_b,
    const CUtensorMap* map_bo, const CUtensorMap* map_cv,
    const CUtensorMap* map_cc, const Walk& walk, const Items& q) {
  using S = Stage<H>;
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  unsigned char* c_out = ring + S::STAGES * S::BYTES;
  Record* recs = reinterpret_cast<Record*>(c_out + S::C_OUT);
  uint64_t* full = reinterpret_cast<uint64_t*>(recs + kNR);
  uint64_t* empty = full + S::STAGES;
  uint64_t* full_r = empty + S::STAGES;
  uint64_t* empty_r = full_r + kNR;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    // full: the TMA warp's expect_tx arrival; empty: lane 0 of each
    // consumer warp; full_r: the lookup warp; empty_r: each consumer warp
    // and the TMA warp
    for (int i = 0; i < S::STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumerThreads / 32);
    }
    for (int i = 0; i < kNR; ++i) {
      mbar_init(&full_r[i], 1);
      mbar_init(&empty_r[i], kConsumerThreads / 32 + 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerThreads / 32) {
    // ---- producer warpgroup ----------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kLookupWarp) {
      // publish each item's pairs, in order, as records
      int rs = 0, rph = 0;
      auto take = [&]() {
        if (lane == 0) mbar_wait(&empty_r[rs], rph ^ 1);
        __syncwarp();
        return &recs[rs];
      };
      auto publish = [&](Record* r, int n, int last) {
        __syncwarp();  // every lane's entries are written
        if (lane == 0) {
          r->n = n;
          r->last = last;
          mbar_arrive(&full_r[rs]);
        }
        if (++rs == kNR) {
          rs = 0;
          rph ^= 1;
        }
      };
      for (int64_t item = blockIdx.x; item < q.n_items; item += gridDim.x) {
        int64_t tile, row_off;
        int cc;
        item_coords(q, item, H, tile, cc, row_off);
        Record* r = take();
        int n = 0;
        walk.pairs(tile, lane, [&](bool hit, int ga, int gb, int bcol) {
          const unsigned ball = __ballot_sync(0xffffffffu, hit);
          const int add = __popc(ball);
          if (n + add > kRecPairs) {
            publish(r, n, 0);
            r = take();
            n = 0;
          }
          if (hit) {
            const int i = n + __popc(ball & ((1u << lane) - 1u));
            r->ga[i] = ga;
            r->gb[i] = gb;
            r->bcol[i] = bcol;
          }
          n += add;
        });
        publish(r, n, 1);
      }
      return;
    }
    if (warp != kTmaWarp || lane != 0) return;
    // one thread issues every stage's TMA loads, record by record
    int rs = 0, rph = 0, st = 0, ph = 0;
    for (int64_t item = blockIdx.x; item < q.n_items; item += gridDim.x) {
      int64_t tile, row_off;
      int cc;
      item_coords(q, item, H, tile, cc, row_off);
      const int c0 = cc * kTN;
      const int r0 = static_cast<int>(row_off);
      int last = 0;
      while (!last) {
        mbar_wait(&full_r[rs], rph);
        const Record* r = &recs[rs];
        const int n = r->n;
        last = r->last;
        for (int i = 0; i < n; ++i) {
          const int ga = r->ga[i], gb = r->gb[i], bcol = r->bcol[i] + c0;
          for (int kc = 0; kc < q.nch; ++kc) {
            const int k0 = kc * kKC;
            mbar_wait(&empty[st], ph ^ 1);
            unsigned char* sb = ring + st * S::BYTES;
            uint64_t* bar = &full[st];
            mbar_expect_tx(bar, S::TX);
            tma_3d(sb, map_a, bar, k0, r0, ga);
            tma_3d(sb + S::AO_OFF, map_ao, bar, k0, r0, ga);
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              tma_3d(sb + S::B_OFF + b * kBBox, map_b, bar, bcol + 32 * b, k0,
                     gb);
            }
#pragma unroll
            for (int b = 0; b < 2; ++b) {
              tma_3d(sb + S::BO_OFF + b * kBBox, map_bo, bar, bcol + 64 * b,
                     k0, gb);
            }
            if (++st == S::STAGES) {
              st = 0;
              ph ^= 1;
            }
          }
        }
        mbar_arrive(&empty_r[rs]);
        if (++rs == kNR) {
          rs = 0;
          rph ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups --------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  constexpr int R = H / 2;  // accumulator registers a thread (m64nH)
  constexpr int AIT = (H * 8 + kConsumerThreads - 1) / kConsumerThreads;
  const int tid = threadIdx.x;
  const int wg = warp >> 2;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  // this thread's B^T fragment at k8 step 0 of a stage: register q holds
  // B[k][n], n = wg*64 + 16*(warp%4) + gid (+8 for q odd), k = tig (+4
  // for q >= 2); B value box n/32 holds 32 rows of 128 bytes, row k's
  // 16-byte chunks swizzled by k % 8. Step j is 8j rows (1 KB) further
  int b_off[4];
#pragma unroll
  for (int qq = 0; qq < 4; ++qq) {
    const int n = wg * kWM + 16 * (warp & 3) + gid + 8 * (qq & 1);
    const int k = tig + 4 * (qq >> 1);
    b_off[qq] = S::B_OFF + (n >> 5) * kBBox + k * 128 +
                ((((n & 31) >> 2) ^ k) << 4) + ((n & 3) << 2);
  }
  // where this thread's C values go in its warpgroup's store boxes (see
  // the store below): register 4j + 2i + e at out_off[e][i] + 1024j
  uint32_t out_off[2][2] = {};
  if constexpr (S::STAGED_OUT) {
    const uint32_t out = smem_u32(c_out) + wg * 4 * S::C_BOX;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = 2 * tig + e;  // + 8j
        const int col = 16 * (warp & 3) + gid + 8 * i;
        out_off[e][i] = out + (col >> 5) * S::C_BOX + row * 128 +
                        ((((col & 31) >> 2) ^ row) << 4) + ((col & 3) << 2);
      }
    }
  }
  float acc[R], cnt[R], p0[R], p1[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    p0[i] = 0.f;
    p1[i] = 0.f;
  }
  int rs = 0, rph = 0, st = 0, ph = 0;
  for (int64_t item = blockIdx.x; item < q.n_items; item += gridDim.x) {
    int64_t tile, row_off;
    int cc;
    item_coords(q, item, H, tile, cc, row_off);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      acc[i] = 0.f;
      cnt[i] = 0.f;
    }
    fence_regs(acc);
    fence_regs(cnt);
    int last = 0;
    while (!last) {
      mbar_wait(&full_r[rs], rph);
      const int n_steps = recs[rs].n * q.nch;
      last = recs[rs].last;
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty_r[rs]);
      if (++rs == kNR) {
        rs = 0;
        rph ^= 1;
      }
      for (int s = 0; s < n_steps; ++s) {
        mbar_wait(&full[st], ph);
        unsigned char* sb = ring + st * S::BYTES;
        // this thread's A values (16 bytes at a time) and B^T fragments
        // for the stage's four k8 steps, and the OR of their low bits
        // over all consumer threads
        float4 ax[AIT];
        uint32_t low = 0u;
#pragma unroll
        for (int it = 0; it < AIT; ++it) {
          const int ci = tid + it * kConsumerThreads;
          ax[it] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (ci < H * 8) {
            ax[it] = reinterpret_cast<const float4*>(sb)[ci];
            low |= __float_as_uint(ax[it].x) | __float_as_uint(ax[it].y) |
                   __float_as_uint(ax[it].z) | __float_as_uint(ax[it].w);
          }
        }
        uint32_t bf[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int qq = 0; qq < 4; ++qq) {
            bf[j][qq] = *reinterpret_cast<const uint32_t*>(sb + b_off[qq] +
                                                           1024 * j);
            low |= bf[j][qq];
          }
        }
        const bool split = bar_red_or(kSplitBarrier, kConsumerThreads,
                                      (low & kTf32Low) != 0u);
        const uint64_t d_hi = sw128_desc(sb);
        const uint64_t d_ao = sw64_desc(sb + S::AO_OFF);
        const uint64_t d_bo = sw128_mn_desc(sb + S::BO_OFF + wg * kBBox);
        auto counts = [&]() {
          wgmma_bf16<H, 1>(cnt, d_bo, d_ao);
          wgmma_bf16<H, 1>(cnt, d_bo + 128, d_ao + 2);
        };
        if (!split) {
          // every operand is a TF32 value: one product a k8 step, exact,
          // on the raw bits, accumulated in place
          wg_fence();
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            wgmma_tf32<H>(acc, bf[j], d_hi + 2 * j, 1);
          }
          counts();
          wg_commit();
          wg_wait<0>();
          fence_regs(acc);
        } else {
          // split A into hi (in place), mid and lo planes and hand them to
          // the async proxy
#pragma unroll
          for (int it = 0; it < AIT; ++it) {
            const int ci = tid + it * kConsumerThreads;
            if (ci < H * 8) {
              uint32_t h[4], m[4], l[4];
              split3_tf32(ax[it].x, h[0], m[0], l[0]);
              split3_tf32(ax[it].y, h[1], m[1], l[1]);
              split3_tf32(ax[it].z, h[2], m[2], l[2]);
              split3_tf32(ax[it].w, h[3], m[3], l[3]);
              reinterpret_cast<uint4*>(sb)[ci] =
                  make_uint4(h[0], h[1], h[2], h[3]);
              reinterpret_cast<uint4*>(sb + S::A)[ci] =
                  make_uint4(m[0], m[1], m[2], m[3]);
              reinterpret_cast<uint4*>(sb + 2 * S::A)[ci] =
                  make_uint4(l[0], l[1], l[2], l[3]);
            }
          }
          fence_proxy_async();
          bar_sync(kSplitBarrier, kConsumerThreads);
          const uint64_t d_mid = sw128_desc(sb + S::A);
          const uint64_t d_lo = sw128_desc(sb + 2 * S::A);
          static_for<0, 4>([&](auto jc) {
            constexpr int J = decltype(jc)::value;
            float(&p)[R] = pick<J>(p0, p1);
            float(&prev)[R] = pick<J + 1>(p0, p1);
            uint32_t bh[4], bm[4], bl[4];
#pragma unroll
            for (int qq = 0; qq < 4; ++qq) {
              split3_tf32(__uint_as_float(bf[J][qq]), bh[qq], bm[qq], bl[qq]);
            }
            wg_fence();
            // (a part, b part): lo.hi, hi.lo, mid.mid, mid.hi, hi.mid,
            // hi.hi, into a zeroed partial sum
            wgmma_tf32<H>(p, bh, d_lo + 2 * J, 0);
            wgmma_tf32<H>(p, bl, d_hi + 2 * J, 1);
            wgmma_tf32<H>(p, bm, d_mid + 2 * J, 1);
            wgmma_tf32<H>(p, bh, d_mid + 2 * J, 1);
            wgmma_tf32<H>(p, bm, d_hi + 2 * J, 1);
            wgmma_tf32<H>(p, bh, d_hi + 2 * J, 1);
            if constexpr (J == 0) counts();
            wg_commit();
            if constexpr (J > 0) {
              wg_wait<1>();  // step J-1's products are done
              fold(acc, prev);
            }
          });
          wg_wait<0>();
          fold(acc, p1);
        }
        // every group of the stage is done: the slot is free (a group in
        // flight past this merge of the two paths made ptxas serialise
        // the wgmmas)
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);
        if (++st == S::STAGES) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    fence_regs(acc);
    fence_regs(cnt);
    // Register 4j + 2i + e holds C row 8j + 2*tig + e, column 16*(warp%4)
    // + gid + 8i of the warpgroup's 64.
    if constexpr (S::STAGED_OUT) {
      // The chunk leaves through shared memory and TMA stores, so the
      // consumers go on to the next item while it is written: this
      // warpgroup's 64 columns of values (boxes 0, 1) and counts (2, 3),
      // 32 columns x H rows each, swizzled as the 128-byte maps read them
      // (the writes then hit distinct banks).
      const bool lead = (threadIdx.x & 127) == 0;
      if (lead) bulk_wait_read();  // the last item's stores have read it
      bar_sync(kStoreBarrier + wg, 128);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const uint32_t a = out_off[r & 1][(r >> 1) & 1] + 1024 * (r >> 2);
        st_shared(a, acc[r]);
        st_shared(a + 2 * S::C_BOX, cnt[r]);
      }
      fence_proxy_async();
      bar_sync(kStoreBarrier + wg, 128);
      if (lead) {
        const int c0 = cc * kTN + wg * kWM;
        const int r0 = static_cast<int>(row_off);
        const int t = static_cast<int>(tile);
        unsigned char* box = c_out + wg * 4 * S::C_BOX;
        tma_store_3d(map_cv, box, c0, r0, t);
        tma_store_3d(map_cv, box + S::C_BOX, c0 + 32, r0, t);
        tma_store_3d(map_cc, box + 2 * S::C_BOX, c0, r0, t);
        tma_store_3d(map_cc, box + 3 * S::C_BOX, c0 + 32, r0, t);
        bulk_commit();
      }
    } else {
      // 64-row chunks: straight from the registers, each warp store
      // filling four 32-byte sectors
      const int64_t base = tile * q.tm * q.tn + row_off * q.tn + cc * kTN +
                           wg * kWM + 16 * (warp & 3) + gid;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int64_t off = base + (8 * (r >> 2) + 2 * tig + (r & 1)) * q.tn +
                            8 * ((r >> 1) & 1);
        q.c_val[off] = acc[r];
        q.c_cnt[off] = cnt[r];
      }
    }
  }
  if constexpr (S::STAGED_OUT) {
    if ((threadIdx.x & 127) == 0) bulk_wait();  // before the smem goes
  }
}

// ---- host ----------------------------------------------------------------

// The operand planes: A (tiles, tm, lda) f32 and bf16, of which the first
// tk columns are read; B (tiles, tk, ldb) f32 and bf16; C (n_c, tm, tn)
// f32 values and counts.
struct Planes {
  const void *a_val, *a_occ, *b_val, *b_occ;
  void *c_val, *c_cnt;
  int64_t tm, tk, lda, ldb, tn, n_c;
};

struct Maps {
  CUtensorMap a, ao, b, bo, cv, cc;
};

// the most tiles of `tile_bytes` the current device's memory can hold:
// the outermost extent of a map (every tile index a plan names is a real
// tile, and no tensor is larger than the card)
inline uint64_t max_tiles(uint64_t tile_bytes) {
  static uint64_t total[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  uint64_t bytes = dev < kMaxDevices ? total[dev] : 0;
  if (bytes == 0) {
    size_t free_b = 0, total_b = 0;
    if (cudaMemGetInfo(&free_b, &total_b) != cudaSuccess) return 0;
    bytes = total_b;
    if (dev < kMaxDevices) total[dev] = bytes;
  }
  const uint64_t n = bytes / tile_bytes;
  return n < INT32_MAX ? n : INT32_MAX;
}

// Encodes the six maps of height H: A values (k, row, tile) boxes of 32 x
// H in the 128-byte swizzle, A occupancy the same in the 64-byte swizzle,
// B values (column, k, tile) boxes of 32 x 32 and B occupancy 64 x 32,
// both in the 128-byte swizzle, and C's two planes (column, row, tile)
// boxes of 32 x H. Needs lda % 8 == 0 and ldb % 8 == 0 (16-byte strides
// of bf16).
template <int H>
inline bool encode_maps(const Planes& p, Maps& m) {
  const uint64_t tm = static_cast<uint64_t>(p.tm);
  const uint64_t tk = static_cast<uint64_t>(p.tk);
  const uint64_t lda = static_cast<uint64_t>(p.lda);
  const uint64_t ldb = static_cast<uint64_t>(p.ldb);
  const uint64_t a_dims[3] = {tk, tm, max_tiles(tm * lda * 4)};
  const uint64_t b_dims[3] = {ldb, tk, max_tiles(tk * ldb * 4)};
  if (a_dims[2] == 0 || b_dims[2] == 0) return false;
  const uint64_t av_str[2] = {lda * 4, tm * lda * 4};
  const uint64_t ao_str[2] = {lda * 2, tm * lda * 2};
  const uint64_t bv_str[2] = {ldb * 4, tk * ldb * 4};
  const uint64_t bo_str[2] = {ldb * 2, tk * ldb * 2};
  const uint32_t a_box[3] = {kKC, H, 1};
  const uint32_t bv_box[3] = {32, kKC, 1};
  const uint32_t bo_box[3] = {64, kKC, 1};
  const uint64_t c_dims[3] = {static_cast<uint64_t>(p.tn), tm,
                              static_cast<uint64_t>(p.n_c)};
  const uint64_t c_str[2] = {c_dims[0] * 4, tm * c_dims[0] * 4};
  const uint32_t c_box[3] = {32, H, 1};
  return make_map(&m.a, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, p.a_val, 3, a_dims,
                  av_str, a_box) &&
         make_map(&m.ao, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.a_occ, 3,
                  a_dims, ao_str, a_box, CU_TENSOR_MAP_SWIZZLE_64B) &&
         make_map(&m.b, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, p.b_val, 3, b_dims,
                  bv_str, bv_box) &&
         make_map(&m.bo, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.b_occ, 3,
                  b_dims, bo_str, bo_box) &&
         make_map(&m.cv, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, p.c_val, 3, c_dims,
                  c_str, c_box) &&
         make_map(&m.cc, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, p.c_cnt, 3, c_dims,
                  c_str, c_box);
}

// Launches `kernel` (a run_items kernel of height H taking the six maps,
// then `args`) over the n_c x n_cc x n_rc items of this row part: one CTA
// per SM, fewer where there are fewer items.
template <int H, typename Kernel, typename... Args>
inline int launch_items(Kernel kernel, const Planes& p, int64_t row_base,
                        unsigned n_rc, cudaStream_t stream, Args... args) {
  using S = Stage<H>;
  static bool ready[kMaxDevices] = {};
  cudaError_t err = set_smem_once(kernel, S::SMEM, true, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  Maps m;
  if (!encode_maps<H>(p, m)) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  Items q{};
  q.n_cc = p.tn / kTN;
  q.n_rc = n_rc;
  q.n_items = p.n_c * q.n_cc * q.n_rc;
  q.row_base = row_base;
  q.tm = p.tm;
  q.tn = p.tn;
  q.c_val = static_cast<float*>(p.c_val);
  q.c_cnt = static_cast<float*>(p.c_cnt);
  q.nch = static_cast<int>((p.tk + kKC - 1) / kKC);
  const unsigned grid =
      static_cast<unsigned>(q.n_items < sms ? q.n_items : sms);
  kernel<<<grid, kThreads, S::SMEM, stream>>>(m.a, m.ao, m.b, m.bo, m.cv,
                                              m.cc, args..., q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tile_pipeline
