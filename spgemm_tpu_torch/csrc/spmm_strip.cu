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
// Tile heights. Any tm % 8 == 0, the tiles the TPU kernels take. Y = A.X
// is row-wise, so a (tm, tk) A tile with tm = q*h is q tiles of height h
// stacked in memory: sub-tile j of tile g is the (h, tk) block at
// a + (g*q + j)*h*tk, and Y's (n_rows, tm, k_pad) layout is (n_rows*q, h,
// k_pad). The kernels are instantiated at h in {8, 16, 32, 64} (the
// largest that divides tm, chunk_rows) and walk "virtual" tile rows
// v = i*q + j: row v takes tile row i's ak list, reads sub-tile j of each
// of its tiles, and writes Y rows v*h .. v*h+h. No copy of A and no other
// plan.
//
// What differs from the TPU kernels, and why (128-column form). The TPU
// kernels hold X (or a block's X window) in VMEM, stream a block's A
// tiles by one DMA and stage a whole block's Y in VMEM, over an in-order
// grid. An H100 CTA has at most 227 KB of shared memory and CTAs run in
// no order. Here the work items are (row group, 128-column chunk of
// k_pad): a group is kN = 64 consecutive Y rows, G = 64/h virtual rows,
// and neighbouring tile rows of a band read the same X slabs, so an item
// stages each slab its rows use once, in ascending ak, for all of them.
// The items of a group's column chunks are numbered back to back (item =
// group * n_cc + cc), so they run at once on neighbouring SMs and the
// group's A tiles come from device memory once and from L2 after.
//
// Design: persistent and warp-specialised, on TMA and tf32 wgmma (the
// strip and pair kernels' pipeline, csrc/tile_pipeline.cuh, with the
// operand roles of SpMM; a sibling loop, not run_items, because an SpMM
// stage gathers one A box per present row, carries a row mask and has no
// counts). One 384-thread CTA per SM walks the items:
//   - a lookup warp merges each item's G ak lists into slab records: the
//     next slab is the least next ak over the rows, each row whose next
//     tile sits on it takes it (so every row adds its tiles in ascending
//     ak and every (row, tile) is visited once), and a record entry holds
//     (slab, the mask of rows present, each present row's sub-tile index).
//     Records run through a ring of kNR, ahead of the loads and products;
//   - one thread issues, per entry and 32-deep k chunk, one stage of TMA
//     loads: X (32 x 128 f32, four 32-column boxes in the 128-byte
//     swizzle) and, for each present row, its sub-tile's A rows (32 x h,
//     the 128-byte swizzle) at the row's place in the stage. The ring of
//     stages runs across records and items, so an item's first stages
//     land while the one before finishes and stores;
//   - two consumer warpgroups compute Y^T = X^T . A^T with wgmma
//     m64n64k8: the chunk's 128 columns are M, 64 for each warpgroup, the
//     group's 64 rows N. X^T is the register A operand (X rows are
//     k-contiguous, so X^T is M-major, which tf32 refuses from shared
//     memory): each consumer thread loads its 16 X values of a stage once
//     with ld.shared and splits them once, in registers, for all the
//     group's rows. A^T is the shared-memory B operand, K-major as TMA
//     lands A's k-contiguous rows.
//
// Arithmetic (the strip and pair kernels'). Each f32 operand x is split
// exactly into three TF32 values hi = rna(x), mid = rna(x - hi), lo =
// x - hi - mid; per k8 step the six partial products larger than 2^-33
// |a.x| (a's part first, smallest first: lo.hi, hi.lo, mid.mid, mid.hi,
// hi.mid, hi.hi) go into a zeroed partial accumulator, which one
// round-to-nearest add folds into the accumulator; two partials
// alternate, so step j's products run while step j-1's partial is folded.
// A stage has two flags, each the OR of the 13 low bits TF32 drops over
// its staged values (named-barrier reductions over the consumers): one
// for A's present rows, one for X. Where a flag is clear its operand's
// mid and lo are zero, so the products with them are left out (they add
// exact zeros) and, for A, its split is skipped: Gaussian X against the
// suite's integer A is three products a step, not six. The consumers
// split A's planes, where they must, in shared memory: hi in place, mid
// and lo into one pair of planes the stages share (a stage's products
// are drained before the next stage's flag barrier, which the split
// follows). Where both flags are clear and every row of the group is
// present, each k8 step is one product on the raw bits accumulated in
// place: integers below 2^11 then give the plain f32 sum bit for bit
// (the masked fold below is exact on them too). No --use_fast_math.
//
// Absent rows receive nothing. A row of the group with no tile on an
// entry's slab gets no A load: its rows of the stage hold whatever an
// earlier stage left there, and its columns of the product are garbage
// (0 * inf or NaN included). A stage whose entry lacks a row never
// accumulates in place: its products go into the partial, and the fold
// adds a row's columns of the partial only where the entry's mask has the
// row (per register, on the CTA-uniform mask: register i of the
// m64n64 accumulator holds group row 8*(i/4) + 2*(lane%4) + i%2, which
// lies in virtual row (8*(i/4))/h for every thread, since h is a multiple
// of 8: a predicated add). The presence never becomes a branch around
// wgmma, and every
// stage drains its wgmma groups before its paths merge: groups in flight
// across a branch merge made ptxas serialise the strip kernel's wgmmas
// (C7515, C7513).
//
// Ragged depth. X is mapped as the 3-D tensor (gk, tk, k_pad) and A as
// (ntA_pad*q, h, tk), so a stage past a slab's tk is zero-filled by TMA
// on both sides and never reads the next slab's rows (0 * inf). TMA needs
// 16-byte global strides, so A's rows need tk % 4 == 0; the wrapper
// (ops/spmm_kernels.py:spmm_strip) pads A's rows and X's slabs with zero
// rows to a multiple of 4 for other tk (one copy of each; the narrow form
// takes any tk as it is).
//
// Y leaves straight from the registers: register i of a warp's 32 lanes
// covers 8 consecutive columns of 4 rows, four whole 32-byte sectors a
// store. Rows past the virtual rows are not written; rows with no tile
// come out zero (the wrapper allocates Y with torch.empty).
//
// Variants of this design measured on the card (H100, banded65536 at
// 16x128 and 64x128, k = 128 and 256, kernel_ab.py in turns; PERF.md):
// 128 rows a group (m64n128k8; the accumulator and two partials need 192
// registers of the consumers' 232, and it spilled 180-308 bytes: 0.155
// against 0.103 ms at k = 128 with Gaussian X); Y staged in shared memory
// for TMA stores (spilled 24-104 bytes, no faster: the store is not what
// bounds the kernel); every stage through the masked partial, without
// the in-place product (integer X 0.073 against 0.064 ms).
//
// What bounds it on the card. At the suite's banded65536 with 16x128
// tiles and k = 128 (8,184 A tiles, gm 4,096, gn 512) the bytes each read
// or written once are A 67 MB, X 33.5 MB and Y 33.5 MB: 40 us at 3.35
// TB/s. The dense-tile work is 2*8,184*16*128*128 = 4.3 GFLOP (the useful
// 2*nnz*k is 1.09 GFLOP): as six split products, 25.8 GFLOP at 495
// TFLOP/s, 52 us; with integer A and Gaussian X three products, 26 us
// (one product on the integer model, 9 us). The groups' rows absent from a
// slab still take products (masked out): about a third more on the band.
// The L2 -> shared stream of X (about 3 slabs of 64 KB per 64-row group
// on the band, against one 64 KB slab per A tile when each tile row
// staged its own) is what the row groups cut.
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
//   tm % 8 == 0; the 128-column form tk % 4 == 0 (TMA strides; the
//   wrapper pads other tk), the narrow form any tk >= 1 (its sectors
//   16-byte copies where tk % 8 == 0); k_pad a multiple of 128, or 1, 8,
//   16 or 32 (narrow form, with its sector map); n_blocks*block_rows*q <
//   2^31 (the virtual rows) and ntA_pad*q < 2^31 (sub-tile indices);
//   k_pad/128 < 65536; every plane 16-byte aligned. All element offsets
//   are int64.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC spmm_strip.cu -o libspmm_strip.so

#include <climits>
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "tile_pipeline.cuh"  // with sm90_async.cuh and sm90_common.cuh

namespace {

using namespace sm90;
using tile_pipeline::pick;

constexpr int kCols = 128;            // Y columns per item
constexpr int kWM = 64;               // of them each consumer warpgroup's
constexpr int kN = 64;                // Y rows per item: wgmma's N
constexpr int kKC = 32;               // k depth of a stage: 128 bytes of f32
constexpr int kThreads = 384;         // two consumer warpgroups, a producer
constexpr int kConsumerThreads = 256;
constexpr int kTmaWarp = 8;           // the producer warpgroup's TMA warp
constexpr int kLookupWarp = 9;        // and its slab-merge warp
constexpr int kProducerRegs = 40;     // setmaxnreg: 168 a thread at launch
constexpr int kConsumerRegs = 232;
constexpr int kFlagBarrier = 1;       // named barrier of the consumers
constexpr int kNR = 8;                // slab records in flight
constexpr int kRecSlabs = 16;         // slabs a record holds
constexpr int kMaxStages = 8;
constexpr int kSmemPerCta = 232448;   // an H100 CTA's shared memory at most
constexpr int kXBox = kKC * 128;      // one X box: 32 k rows of 128 bytes

// The sub-tile height for A tiles of tm rows: the largest instantiated
// height that divides tm; 0 where tm % 8 != 0.
constexpr int chunk_rows(int64_t tm) {
  return tm % 64 == 0 ? 64 : tm % 32 == 0 ? 32 : tm % 16 == 0 ? 16
         : tm % 8 == 0 ? 8 : 0;
}

// One published slice of an item's slab merge: n entries, each a slab,
// the mask of the group's rows with a tile on it (bit r: row r) and each
// such row's sub-tile index; `last` on the item's final slice. An item
// with more than kRecSlabs slabs takes several records; one with none
// takes one record of n = 0.
template <int G>
struct SlabRecord {
  int32_t n, last;
  int32_t slab[kRecSlabs];
  uint32_t mask[kRecSlabs];
  int32_t sub[kRecSlabs][G];
};

// One stage of the ring at sub-tile height H, byte offsets from its start
// (each swizzled region 1 KB aligned): the group's A rows (kN rows of 128
// bytes; TMA lands row r's sub-tile at r*H rows, the consumers split it in
// place into hi), then four X boxes (32 k rows of 128 bytes each). The
// A mid and lo planes of the split are one pair the stages share.
template <int H>
struct SpmmStage {
  static constexpr int G = kN / H;    // virtual rows a group
  static constexpr int A = kN * 128;
  static constexpr int X_OFF = A;
  static constexpr int BYTES = X_OFF + 4 * kXBox;
  static constexpr int SPLIT = 2 * A;
  static constexpr int RECS = kNR * static_cast<int>(sizeof(SlabRecord<G>));
  // 1 KB of alignment slack, the split planes, the records, the mbarriers
  static constexpr int FIXED = 1024 + SPLIT + RECS +
                               (2 * kMaxStages + 2 * kNR) * 8;
  static constexpr int FIT = (kSmemPerCta - FIXED) / BYTES;
  static constexpr int STAGES = FIT < kMaxStages ? FIT : kMaxStages;
  static constexpr int SMEM = 1024 + STAGES * BYTES + SPLIT + RECS +
                              (2 * STAGES + 2 * kNR) * 8;
  static_assert(G * H == kN && A % 1024 == 0 && BYTES % 1024 == 0 &&
                    sizeof(SlabRecord<G>) % 8 == 0 && STAGES >= 2,
                "stage layout");
};

struct SpmmItems {
  const int32_t* aptr;
  const int32_t* ak;
  float* y;                  // (n_rows_v*H, k_pad)
  int64_t n_items, n_cc;     // (row group, column chunk) items
  int64_t gm_v, n_rows_v;    // virtual rows with tiles, and all of them
  int64_t q, k_pad;          // sub-tiles a tile row, Y's row stride
  int nch;                   // 32-deep k chunks a slab
};

// acc += part on the group rows `mask` holds (G rows of H; see the top of
// the file), with round-to-nearest; the other rows keep acc. A predicated
// add a register (a select of part or 0 before the add was 7% slower on
// the card)
template <int H, int R>
__device__ __forceinline__ void fold_rows(float (&acc)[R], float (&part)[R],
                                          uint32_t mask) {
  fence_regs(acc);
  fence_regs(part);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if ((mask >> ((8 * (i >> 2)) / H)) & 1u) {
      acc[i] = __fadd_rn(acc[i], part[i]);
    }
  }
}

template <int H>
__global__ void __launch_bounds__(kThreads, 1)
spmm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_x,
                  const SpmmItems q) {
  using S = SpmmStage<H>;
  constexpr int G = S::G;
  constexpr uint32_t kFull = (1u << G) - 1u;
  using Rec = SlabRecord<G>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  unsigned char* split = ring + S::STAGES * S::BYTES;  // A mid, lo planes
  Rec* recs = reinterpret_cast<Rec*>(split + S::SPLIT);
  uint64_t* full = reinterpret_cast<uint64_t*>(recs + kNR);
  uint64_t* empty = full + S::STAGES;
  uint64_t* full_r = empty + S::STAGES;
  uint64_t* empty_r = full_r + kNR;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    // full: the TMA thread's expect_tx arrival; empty: lane 0 of each
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
      // merge each item's rows' ak lists into slab records, in order
      int rs = 0, rph = 0;
      auto take = [&]() {
        if (lane == 0) mbar_wait(&empty_r[rs], rph ^ 1);
        __syncwarp();
        return &recs[rs];
      };
      auto publish = [&](Rec* r, int n, int last) {
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
        // lane r < G walks virtual row group*G + r: sub-tile `sub` of tile
        // row i, its tiles cur .. end
        const int64_t v = item / q.n_cc * G + lane;
        int cur = 0, end = 0, sub = 0;
        if (lane < G && v < q.gm_v) {
          const int64_t i = v / q.q;
          sub = static_cast<int>(v - i * q.q);
          cur = q.aptr[i];
          end = q.aptr[i + 1];
        }
        Rec* r = take();
        int n = 0;
        for (;;) {
          const int mine = cur < end ? q.ak[cur] : INT_MAX;
          const int s = __reduce_min_sync(0xffffffffu, mine);
          if (s == INT_MAX) break;
          const bool hit = mine == s;
          const uint32_t mask = __ballot_sync(0xffffffffu, hit);
          if (n == kRecSlabs) {
            publish(r, n, 0);
            r = take();
            n = 0;
          }
          if (hit) r->sub[n][lane] = cur * static_cast<int>(q.q) + sub;
          if (lane == 0) {
            r->slab[n] = s;
            r->mask[n] = mask;
          }
          cur += hit;
          ++n;
        }
        publish(r, n, 1);
      }
      return;
    }
    if (warp != kTmaWarp || lane != 0) return;
    // one thread issues every stage's TMA loads, record by record
    int rs = 0, rph = 0, st = 0, ph = 0;
    for (int64_t item = blockIdx.x; item < q.n_items; item += gridDim.x) {
      const int c0 = static_cast<int>(item % q.n_cc) * kCols;
      int last = 0;
      while (!last) {
        mbar_wait(&full_r[rs], rph);
        const Rec* r = &recs[rs];
        const int n = r->n;
        last = r->last;
        for (int e = 0; e < n; ++e) {
          const int slab = r->slab[e];
          const uint32_t mask = r->mask[e];
          const uint32_t tx = 4 * kXBox + __popc(mask) * H * 128;
          for (int kc = 0; kc < q.nch; ++kc) {
            const int k0 = kc * kKC;
            mbar_wait(&empty[st], ph ^ 1);
            unsigned char* sb = ring + st * S::BYTES;
            uint64_t* bar = &full[st];
            mbar_expect_tx(bar, tx);
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              tma_3d(sb + S::X_OFF + b * kXBox, &map_x, bar, c0 + 32 * b, k0,
                     slab);
            }
#pragma unroll
            for (int g = 0; g < G; ++g) {
              if ((mask >> g) & 1u) {
                tma_3d(sb + g * H * 128, &map_a, bar, k0, 0, r->sub[e][g]);
              }
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
  constexpr int R = kN / 2;  // accumulator registers a thread (m64n64)
  constexpr int AIT = kN * 8 / kConsumerThreads;  // A float4s a thread
  const int tid = threadIdx.x;
  const int wg = warp >> 2;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  // this thread's X^T fragment at k8 step 0 of a stage: register qq holds
  // X[k][c], c = wg*64 + 16*(warp%4) + gid (+8 for qq odd), k = tig (+4
  // for qq >= 2); X box c/32 holds 32 rows of 128 bytes, row k's 16-byte
  // chunks swizzled by k % 8. Step j is 8j rows (1 KB) further
  int x_off[4];
#pragma unroll
  for (int qq = 0; qq < 4; ++qq) {
    const int c = wg * kWM + 16 * (warp & 3) + gid + 8 * (qq & 1);
    const int k = tig + 4 * (qq >> 1);
    x_off[qq] = S::X_OFF + (c >> 5) * kXBox + k * 128 +
                ((((c & 31) >> 2) ^ k) << 4) + ((c & 3) << 2);
  }
  const uint64_t d_mid = sw128_desc(split);
  const uint64_t d_lo = sw128_desc(split + S::A);
  float acc[R], p0[R], p1[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    p0[i] = 0.f;
    p1[i] = 0.f;
  }
  int rs = 0, rph = 0, st = 0, ph = 0;
  for (int64_t item = blockIdx.x; item < q.n_items; item += gridDim.x) {
    const int64_t group = item / q.n_cc;
    const int cc = static_cast<int>(item - group * q.n_cc);
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0.f;
    fence_regs(acc);
    int last = 0;
    while (!last) {
      mbar_wait(&full_r[rs], rph);
      const Rec* rec = &recs[rs];
      const int n = rec->n;
      last = rec->last;
      for (int e = 0; e < n; ++e) {
        const uint32_t mask = rec->mask[e];
        for (int kc = 0; kc < q.nch; ++kc) {
          mbar_wait(&full[st], ph);
          unsigned char* sb = ring + st * S::BYTES;
          // this thread's A values of present rows (16 bytes at a time)
          // and X^T fragments for the stage's four k8 steps, and the OR of
          // each operand's low bits over all consumer threads
          float4 ax[AIT];
          uint32_t low_a = 0u, low_x = 0u;
#pragma unroll
          for (int it = 0; it < AIT; ++it) {
            const int ci = tid + it * kConsumerThreads;  // row ci / 8
            ax[it] = make_float4(0.f, 0.f, 0.f, 0.f);
            if ((mask >> ((ci >> 3) / H)) & 1u) {
              ax[it] = reinterpret_cast<const float4*>(sb)[ci];
              low_a |= __float_as_uint(ax[it].x) | __float_as_uint(ax[it].y) |
                       __float_as_uint(ax[it].z) | __float_as_uint(ax[it].w);
            }
          }
          uint32_t xf[4][4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int qq = 0; qq < 4; ++qq) {
              xf[j][qq] = *reinterpret_cast<const uint32_t*>(sb + x_off[qq] +
                                                             1024 * j);
              low_x |= xf[j][qq];
            }
          }
          const bool a_rest = bar_red_or(kFlagBarrier, kConsumerThreads,
                                         (low_a & kTf32Low) != 0u);
          const bool x_rest = bar_red_or(kFlagBarrier, kConsumerThreads,
                                         (low_x & kTf32Low) != 0u);
          const uint64_t d_hi = sw128_desc(sb);
          if (!a_rest && !x_rest && mask == kFull) {
            // every operand is a TF32 value and every row present: one
            // product a k8 step, exact, on the raw bits, in place
            wg_fence();
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              wgmma_tf32<kN>(acc, xf[j], d_hi + 2 * j, 1);
            }
            wg_commit();
            wg_wait<0>();
            fence_regs(acc);
          } else {
            if (a_rest) {
              // split the present rows of A into hi (in place), mid and lo
              // and hand them to the async proxy (the other rows' products
              // are masked out of the fold)
#pragma unroll
              for (int it = 0; it < AIT; ++it) {
                const int ci = tid + it * kConsumerThreads;
                if ((mask >> ((ci >> 3) / H)) & 1u) {
                  uint32_t h[4], m[4], l[4];
                  split3_tf32(ax[it].x, h[0], m[0], l[0]);
                  split3_tf32(ax[it].y, h[1], m[1], l[1]);
                  split3_tf32(ax[it].z, h[2], m[2], l[2]);
                  split3_tf32(ax[it].w, h[3], m[3], l[3]);
                  reinterpret_cast<uint4*>(sb)[ci] =
                      make_uint4(h[0], h[1], h[2], h[3]);
                  reinterpret_cast<uint4*>(split)[ci] =
                      make_uint4(m[0], m[1], m[2], m[3]);
                  reinterpret_cast<uint4*>(split + S::A)[ci] =
                      make_uint4(l[0], l[1], l[2], l[3]);
                }
              }
              fence_proxy_async();
              bar_sync(kFlagBarrier, kConsumerThreads);
            }
            // the split products of the four k8 steps into alternating
            // zeroed partials, each folded on the present rows; AR / XR:
            // A's / X's mid and lo are not all zero
            auto products = [&](auto ar, auto xr) {
              constexpr bool AR = decltype(ar)::value;
              constexpr bool XR = decltype(xr)::value;
              static_for<0, 4>([&](auto jc) {
                constexpr int J = decltype(jc)::value;
                float(&p)[R] = pick<J>(p0, p1);
                float(&prev)[R] = pick<J + 1>(p0, p1);
                uint32_t xh[4];
                [[maybe_unused]] uint32_t xm[4], xl[4];
#pragma unroll
                for (int qq = 0; qq < 4; ++qq) {
                  if constexpr (XR) {
                    split3_tf32(__uint_as_float(xf[J][qq]), xh[qq], xm[qq],
                                xl[qq]);
                  } else {
                    xh[qq] = xf[J][qq];
                  }
                }
                wg_fence();
                // (A part, X part): lo.hi, hi.lo, mid.mid, mid.hi, hi.mid,
                // hi.hi, those with a zero part left out
                if constexpr (AR) wgmma_tf32<kN>(p, xh, d_lo + 2 * J, 0);
                if constexpr (XR) wgmma_tf32<kN>(p, xl, d_hi + 2 * J, AR);
                if constexpr (AR && XR) {
                  wgmma_tf32<kN>(p, xm, d_mid + 2 * J, 1);
                }
                if constexpr (AR) wgmma_tf32<kN>(p, xh, d_mid + 2 * J, 1);
                if constexpr (XR) wgmma_tf32<kN>(p, xm, d_hi + 2 * J, 1);
                wgmma_tf32<kN>(p, xh, d_hi + 2 * J, AR || XR);
                wg_commit();
                if constexpr (J > 0) {
                  wg_wait<1>();  // step J-1's products are done
                  fold_rows<H>(acc, prev, mask);
                }
              });
              wg_wait<0>();
              fold_rows<H>(acc, p1, mask);
            };
            using T = std::true_type;
            using F = std::false_type;
            if (a_rest && x_rest) {
              products(T{}, T{});
            } else if (a_rest) {
              products(T{}, F{});
            } else if (x_rest) {
              products(F{}, T{});
            } else {
              products(F{}, F{});
            }
          }
          // every group of the stage is done: the slot is free (a group
          // in flight past this merge of the paths made ptxas serialise
          // the wgmmas)
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[st]);
          if (++st == S::STAGES) {
            st = 0;
            ph ^= 1;
          }
        }
      }
      // the record's slabs are done
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty_r[rs]);
      if (++rs == kNR) {
        rs = 0;
        rph ^= 1;
      }
    }
    fence_regs(acc);
    // Register 4j + 2i + e holds Y row group*kN + 8j + 2*tig + e, column
    // cc*128 + wg*64 + 16*(warp%4) + gid + 8i: each warp store fills four
    // 32-byte sectors
    const int64_t row0 = group * kN + 2 * tig;
    const int64_t rows = q.n_rows_v * H;
    float* yc = q.y + cc * kCols + wg * kWM + 16 * (warp & 3) + gid;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int64_t row = row0 + 8 * (i >> 2) + (i & 1);
      if (row < rows) yc[row * q.k_pad + 8 * ((i >> 1) & 1)] = acc[i];
    }
  }
}

template <int H>
int launch(cudaStream_t stream, const float* a, const float* xb,
           const int32_t* aptr, const int32_t* ak, float* y, int64_t gm_v,
           int64_t n_rows_v, int64_t tk, int64_t k_pad, int64_t q) {
  using S = SpmmStage<H>;
  static bool ready[kMaxDevices] = {};
  cudaError_t err = set_smem_once(spmm_wgmma_kernel<H>, S::SMEM, true, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  // A as (sub-tiles, H, tk) with boxes of 32 x H, X as (slabs, tk, k_pad)
  // with boxes of 32 x 32, both in the 128-byte swizzle; the outermost
  // extents are as many as the card holds (every index a plan names is
  // real), the inner ones the tiles' own, so TMA zero-fills past tk
  const uint64_t utk = static_cast<uint64_t>(tk);
  const uint64_t ukp = static_cast<uint64_t>(k_pad);
  const uint64_t a_dims[3] = {utk, H, tile_pipeline::max_tiles(H * utk * 4)};
  const uint64_t x_dims[3] = {ukp, utk,
                              tile_pipeline::max_tiles(utk * ukp * 4)};
  if (a_dims[2] == 0 || x_dims[2] == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint64_t a_str[2] = {utk * 4, H * utk * 4};
  const uint64_t x_str[2] = {ukp * 4, utk * ukp * 4};
  const uint32_t a_box[3] = {kKC, H, 1};
  const uint32_t x_box[3] = {32, kKC, 1};
  CUtensorMap ma, mx;
  if (!make_map(&ma, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, a, 3, a_dims, a_str,
                a_box) ||
      !make_map(&mx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, xb, 3, x_dims, x_str,
                x_box)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  SpmmItems it{};
  it.aptr = aptr;
  it.ak = ak;
  it.y = y;
  it.n_cc = k_pad / kCols;
  it.n_items = (n_rows_v + S::G - 1) / S::G * it.n_cc;
  it.gm_v = gm_v;
  it.n_rows_v = n_rows_v;
  it.q = q;
  it.k_pad = k_pad;
  it.nch = static_cast<int>((tk + kKC - 1) / kKC);
  const unsigned grid =
      static_cast<unsigned>(it.n_items < sms ? it.n_items : sms);
  spmm_wgmma_kernel<H><<<grid, kThreads, S::SMEM, stream>>>(ma, mx, it);
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
// form, a multiple of 128 the 128-column form, which takes tk % 4 == 0
// (its TMA strides). `tm` is any multiple of 8: the kernels run its
// sub-tiles of height chunk_rows(tm). Launches on `stream`, does not
// synchronise, allocates nothing.
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
                   k_pad / kCols > 65535 || tk % 4 != 0))) {
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
