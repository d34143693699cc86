// Fused Ozaki-slice f64 strip kernel for Hopper (sm_90a), C ABI for ctypes.
//
// Replaces spgemm_tpu/ops/pallas_kernels.py:_ozaki_strip_kernel_factory
// (:971), reached through ozaki_strip_pallas (:1137).
//
// What it computes. Each A tile g of block blk (tile-rows
// [blk*block_rows, min((blk+1)*block_rows, gm))) has a stacked int8 plane
// av8[g] (stack_rows, tk) whose rows s*tm .. (s+1)*tm hold A slice s
// (s < sa; rows at or past sa*tm are zero padding and are never read).
// For every y < max_b with s_c = slots[g*max_b + y] < max_cblock and every
// B slice t < sb with p = s + t <= pmax:
//   M_p[blk*max_cblock + s_c] += A_s(g) . bv8[ak[g]][:, (t*max_b+y)*tn : +tn]
// in exact int32, and
//   cnt[blk*max_cblock + s_c] += a_occ[g] . b_occ[ak[g]][:, y*tn : +tn].
// Each C element then reduces its n_groups = min(sa+sb-1, pmax+1) group
// sums to a triple float (h, m, l): mh = f32(M_p), ml = f32(M_p - i32(mh)),
// both scaled by 2^(-7p), each added by cascaded TwoSum, in the reference's
// order. Outputs are four f32 planes h, m, l, cnt in the block-padded
// layout (n_blocks*max_cblock, tm, tn); every slot no pair reaches is zero.
// Padded pairs point at slot max_cblock, which no CTA owns.
//
// What bounds it on the card. At the cant-like plan (tm 32, S = 8x8,
// pmax 7, 11,688 pairs over 7,808 slots) the plan's inputs and outputs
// are 914 MB (0.273 ms at 3.35 TB/s; the four f32 output planes alone
// are 512 MB) and its kept slice products 2.2e11 int8 MACs (0.223 ms at
// 1,979 TOP/s). Beside those: the operands a pair stages from L2 (its A
// stack, 32 KB, the B slices, 128 KB, and both occupancy planes: about
// 200 KB a pair, 2.3 GB in all), the shared-memory reads of the tensor-
// core products (each int8 wgmma here reads a 2 KB B slice and a 1 KB A
// slice for 64 x 32 x 32 products), and the TwoSum reduce (about 15 f32
// operations per group and element). The mma.sync kernel this one
// replaced ran its copies, products and reduce one after another
// in the same warps, 16 warps a SM at 64 accumulator registers each.
//
// Design: warp-specialised, TMA-fed int8 wgmma on the transposed product.
//   Transposed product. The kernel computes C^T = B^T . A^T: 64 of a C
//   slot's columns are wgmma's M and the slot's h rows its N, so a row
//   chunk of 8, 16 or 32 rows needs no padding to a 16-row fragment, and
//   a consumer warpgroup holds every group p of its 64 x h block as an
//   int32 accumulator of h/2 registers a thread (up to 128 at h 32, 8
//   groups). The A stack lies in shared memory as sa*h rows (slice s at
//   rows s*h): B slice t times rows s*h .. of the stack is one
//   m64nhk32 wgmma into group t + s, four k steps a 128-deep chunk.
//   K-major operands. int8 wgmma reads both operands K-major from shared
//   memory. av8 and a_occ are k-contiguous already; bv8 and b_occ are
//   n-contiguous, so each call first writes a K-major copy of both
//   (transpose_kernel below: 480 MB moved at the cant-like plan; its time
//   is part of the call's). Every operand then arrives by TMA in the
//   128-byte-swizzled K-major layout wgmma reads without bank conflicts:
//   rows of 128 k bytes (or 64 bf16), 8-row atoms of 1 KB.
//   Producer and consumers. A persistent grid of one 384-thread CTA per
//   SM walks the (slot, 128-column chunk, row chunk) items. Its producer
//   warpgroup hands its registers to the two consumer warpgroups
//   (setmaxnreg: 40 and 232); one of its warps counts an item's pairs (a
//   ballot scan over the block's slot words), passes the count to the
//   consumers through an mbarrier-guarded header, and keeps TMA loads in
//   flight: per pair and 128-deep k chunk the A stack with its occupancy
//   rows into a ring of two A entries (read by both consumers: a pair's A
//   stack is staged once), then the two occupancy halves of B and its sb
//   slices, 128 columns each, into a ring of eight 16 KB slots. Each
//   consumer takes the 64 columns of its half of every slot, issues a
//   slot's wgmmas as one asynchronous group, and frees the slot once the
//   next slot's group is issued and its own is done, so the tensor cores
//   do not drain between slots; the producer keeps loading the next item
//   while the consumers run the TwoSum epilogue.
//   Counts. bf16 wgmma (m64nhk16) on the 0/1 occupancy planes, the same
//   K-major layout, exact in f32 accumulators.
//   Epilogue. Where every group sum of a warp lies in [-2^22, 2^22), the
//   common case, f32(M_p) is exact: its rest ml is +0 and is left out
//   (adding +0 by TwoSum changes no bit, since no sum here is ever -0),
//   and M_p * 2^(-7p) comes from integer and f32 adds instead of a
//   conversion. Otherwise the warp runs the reference's full sequence.
//
// Exactness. Every int8 product and int32 group sum is exact; the host
// plan guarantees |M_p| < 2^30 (ops/ozaki.py:_check_int32_bound), so the
// order of the pairs does not matter. The TwoSum reduce uses
// __fadd_rn/__fsub_rn/__fmul_rn and the library is built with
// --fmad=false and without --use_fast_math or flush-to-zero, so h, m and l
// are bit-equal to the plain PyTorch version on any values.
//
// Tile shapes. Any tm % 8 == 0 and tn % 128 == 0: rows in chunks of h =
// 32, 16 or 8 (as many 32-row chunks as fit, then at most one of 16 and
// 8; sm90_common.cuh:for_each_row_part), one launch per height. Up to 8
// groups (the plans' usual pmax 7) at every height; all 15 groups at h 16
// and 8 (15 x 16 accumulator registers at h 32 would not fit beside the
// rest), so a 32-row chunk then runs as two of 16. Any tk % 16 == 0 in
// 128-deep k chunks: the TMA zero-fills k >= tk.
//
// Dead ends, on the same card. The mma.sync kernel before: four B
// slices' fragments held at once, two cp.async stages instead of three,
// skipping zero TwoSum terms, a persistent grid whose gather ran in the
// same warps as the products, and int8 wgmma with the B fragments in
// registers (A from shared memory) each ran as fast or slower. This
// design: two CTAs a SM of one consumer warpgroup and a producer
// warp (160 threads) were held to 168 registers and spilled the
// accumulators; wgmmas spanning two or four slices (N 64, to read B_t
// fewer times) made ptxas serialise every wgmma (C7511: windows of
// accumulator registers that overlap from one t to the next, aligned or
// not), so each wgmma takes one slice; a per-lane branch around each
// group's rest, instead of one per warp, ran slower than always adding
// the rests; waiting for all of a slot's wgmmas before freeing it
// drained the tensor cores at every slot; and two independent pipelines
// in the CTA (each consumer warpgroup on its own 64-column items, so one's
// epilogue overlaps the other's products) ran slower than the shared one:
// each stages its own A stacks, and the B ring halves.
//
// Limits (checked by the caller, spgemm_tpu_torch/ops/ozaki_kernels.py):
//   tm % 8 == 0, tn % 128 == 0, tk % 16 == 0; 1 <= sa, sb <= 8;
//   stack_rows >= sa*tm; n_blocks*max_cblock*(tn/128)*(tm/8) < 2^31
//   items; ntA_pad*tm, gk_pad*sb*max_b*tn < 2^31 (TMA row coordinates).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC ozaki_strip.cu -o libozaki_strip.so

#include <cstdint>
#include <type_traits>
#include <cuda.h>
#include <cuda_runtime.h>

#include "sm90_async.cuh"
#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int kMaxSlices = 8;
constexpr int kKC = 128;             // k bytes of one unit: one swizzled row
constexpr int kCN = 128;             // C columns per item
constexpr int kWM = 64;              // of them each consumer's: wgmma's M
constexpr int kConsumers = 2;        // consumer warpgroups (warps 0-7)
constexpr int kNA = 2;               // A ring entries
constexpr int kNH = 2;               // item headers in flight
constexpr int kBSlot = kCN * kKC;    // one B ring slot: 128 rows x 128 bytes
constexpr int kThreads = 384;        // two consumer warpgroups, a producer one
constexpr int kProducerWarp = 8;     // the producer warpgroup's one busy warp
// registers a thread after the producer warpgroup hands its surplus to the
// consumers (setmaxnreg): 168 at launch for one CTA of 384 threads a SM
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kSmemPerCta = 232448;  // an H100 CTA's shared memory at most

// one A ring entry: the A stack (up to 8 slices of h rows) and the two
// 64-deep halves of the A occupancy rows, each row 128 bytes
__host__ __device__ constexpr int a_entry_bytes(int h) {
  return (kMaxSlices + 2) * h * kKC;
}

// B ring slots: what the CTA has beside the A ring, 1 KB of alignment
// slack and 512 bytes of mbarriers (at most 8)
__host__ __device__ constexpr int b_slots(int h) {
  constexpr int kLeft = kSmemPerCta - 1024 - 512;
  return (kLeft - kNA * a_entry_bytes(h)) / kBSlot < 8
             ? (kLeft - kNA * a_entry_bytes(h)) / kBSlot
             : 8;
}

// dynamic shared memory: 1 KB of alignment slack, the rings, mbarriers
// and item headers
__host__ __device__ constexpr int smem_bytes(int h) {
  return 1024 + kNA * a_entry_bytes(h) + b_slots(h) * kBSlot +
         (2 * kNA + 2 * b_slots(h) + 2 * kNH) * 8 + kNH * 4;
}

struct Params {
  int64_t gm, block_rows, max_b, max_cblock, tm, tn, n_slots;
  int64_t row_base, n_rc, n_cc, n_items;  // this launch's row chunks
  int sa, sb, n_groups, nkc;
};

// every product of B slice T (rows of `bslot`) with the ns first slices
// of the A stack, four k steps of 32: one wgmma (N = H) a slice, into
// group T + s. (Wider wgmmas over two or four slices, whose accumulator
// windows overlap from one T to the next, made the compiler copy
// accumulators between the asynchronous products and serialise them.)
template <int H, int NG, int T>
__device__ __forceinline__ void slice_products(int32_t (&acc)[NG * H / 2],
                                               const unsigned char* bslot,
                                               const unsigned char* stack,
                                               int ns) {
  const uint64_t da0 = sw128_desc(bslot);
  const uint64_t db0 = sw128_desc(stack);
#pragma unroll
  for (int kk = 0; kk < kKC / 32; ++kk) {
#pragma unroll
    for (int s = 0; s < kMaxSlices && T + s < NG; ++s) {
      if (s < ns) {
        wgmma_s8<H>(&acc[(T + s) * H / 2], da0 + 2 * kk,
                    db0 + s * H * kKC / 16 + 2 * kk);
      }
    }
  }
}

__device__ __forceinline__ void two_sum(float a, float b, float& s,
                                        float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

// One CTA a SM: warps 0-3 and 4-7 the consumer warpgroups (consumer c
// owns columns c*64 .. c*64+63 of the item), warps 8-11 the producer
// warpgroup, of which warp 8 works and the others leave. Items (slot,
// 128-column chunk cc, row chunk rc) in the order item = (slot * n_cc +
// cc) * n_rc + rc, strided over the grid.
template <int H, int NG>
__global__ void __launch_bounds__(kThreads, 1)
ozaki_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_ao,
                   const __grid_constant__ CUtensorMap map_b,
                   const __grid_constant__ CUtensorMap map_bo,
                   const int32_t* __restrict__ aptr,
                   const int32_t* __restrict__ ak,
                   const int32_t* __restrict__ slots,
                   float* __restrict__ c_h, float* __restrict__ c_m,
                   float* __restrict__ c_l, float* __restrict__ c_cnt,
                   const Params q) {
  constexpr int NB = b_slots(H);
  constexpr int AE = a_entry_bytes(H);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  unsigned char* a_ring = smem;
  unsigned char* b_ring = smem + kNA * AE;
  uint64_t* full_a = reinterpret_cast<uint64_t*>(b_ring + NB * kBSlot);
  uint64_t* empty_a = full_a + kNA;
  uint64_t* full_b = empty_a + kNA;
  uint64_t* empty_b = full_b + NB;
  uint64_t* full_h = empty_b + NB;
  uint64_t* empty_h = full_h + kNH;
  int32_t* hdr = reinterpret_cast<int32_t*>(empty_h + kNH);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    // full: the producer's expect_tx arrival; empty: lane 0 of each
    // consumer warp once its products are done
    constexpr int kWarps = 4 * kConsumers;
    for (int i = 0; i < kNA; ++i) {
      mbar_init(&full_a[i], 1);
      mbar_init(&empty_a[i], kWarps);
    }
    for (int i = 0; i < NB; ++i) {
      mbar_init(&full_b[i], 1);
      mbar_init(&empty_b[i], kWarps);
    }
    for (int i = 0; i < kNH; ++i) {
      mbar_init(&full_h[i], 1);
      mbar_init(&empty_h[i], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int64_t per_slot = q.n_cc * q.n_rc;
  if (warp >= 4 * kConsumers) {
    // ---- producer ------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp != kProducerWarp) return;
    int hs = 0, hph = 0, ai = 0, aph = 0, bi = 0, bph = 0;
    for (int64_t item = blockIdx.x; item < q.n_items; item += gridDim.x) {
      const int64_t slot_id = item / per_slot;
      const int64_t rest = item - slot_id * per_slot;
      const int cc = static_cast<int>(rest / q.n_rc);
      const int64_t row_off =
          q.row_base + (rest - static_cast<int64_t>(cc) * q.n_rc) * H;
      const int64_t blk = slot_id / q.max_cblock;
      const int32_t s_c = static_cast<int32_t>(slot_id - blk * q.max_cblock);
      const int64_t r0 = blk * q.block_rows;
      const int64_t r1 = r0 + q.block_rows < q.gm ? r0 + q.block_rows : q.gm;
      const int64_t e_begin = static_cast<int64_t>(aptr[r0]) * q.max_b;
      const int64_t e_end = static_cast<int64_t>(aptr[r1]) * q.max_b;
      // count the slot's pairs, then hand the item's unit count over
      int n = 0;
      for (int64_t e0 = e_begin; e0 < e_end; e0 += 32) {
        const int64_t e = e0 + lane;
        n += __popc(__ballot_sync(0xffffffffu, e < e_end && slots[e] == s_c));
      }
      if (lane == 0) {
        mbar_wait(&empty_h[hs], hph ^ 1);
        hdr[hs] = n * q.nkc;
        mbar_arrive(&full_h[hs]);
        if (++hs == kNH) {
          hs = 0;
          hph ^= 1;
        }
      }
      // stream the pairs in order: per pair and k chunk, the A stack and
      // its occupancy rows, then the B occupancy halves and slices
      const int c0 = cc * kCN;
      for (int64_t e0 = e_begin; e0 < e_end; e0 += 32) {
        const int64_t e = e0 + lane;
        unsigned hits =
            __ballot_sync(0xffffffffu, e < e_end && slots[e] == s_c);
        if (lane == 0) {
          while (hits) {
            const int b = __ffs(hits) - 1;
            hits &= hits - 1;
            const int64_t g = (e0 + b) / q.max_b;
            const int y = static_cast<int>(e0 + b - g * q.max_b);
            const int ks = ak[g];
            for (int kc = 0; kc < q.nkc; ++kc) {
              const int k0 = kc * kKC;
              mbar_wait(&empty_a[ai], aph ^ 1);
              unsigned char* ae = a_ring + ai * AE;
              mbar_expect_tx(&full_a[ai], (q.sa + 2) * H * kKC);
              tma_4d(ae, &map_a, &full_a[ai], k0, static_cast<int>(row_off),
                     0, static_cast<int>(g));
              const int ao_row = static_cast<int>(g * q.tm + row_off);
              tma_2d(ae + kMaxSlices * H * kKC, &map_ao, &full_a[ai], k0,
                     ao_row);
              tma_2d(ae + (kMaxSlices + 1) * H * kKC, &map_ao, &full_a[ai],
                     k0 + 64, ao_row);
              if (++ai == kNA) {
                ai = 0;
                aph ^= 1;
              }
              for (int u = 0; u < 2 + q.sb; ++u) {
                mbar_wait(&empty_b[bi], bph ^ 1);
                unsigned char* bs = b_ring + bi * kBSlot;
                mbar_expect_tx(&full_b[bi], kBSlot);
                if (u < 2) {
                  tma_3d(bs, &map_bo, &full_b[bi], k0 + 64 * u,
                         static_cast<int>(y * q.tn + c0), ks);
                } else {
                  tma_3d(bs, &map_b, &full_b[bi], k0,
                         static_cast<int>(((u - 2) * q.max_b + y) * q.tn + c0),
                         ks);
                }
                if (++bi == NB) {
                  bi = 0;
                  bph ^= 1;
                }
              }
            }
          }
        }
        __syncwarp();
      }
    }
    return;
  }

  // ---- consumer warpgroups ------------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  int32_t acc[NG * H / 2];
  float cnt[H / 2];
  int hs = 0, hph = 0, ai = 0, aph = 0, bi = 0, bph = 0;
  const int wg = warp >> 2;   // consumer: its 64 rows of each B slot
  const int fa = lane >> 2;   // accumulator fragment: row n = 16*(warp%4)
  const int fb = lane & 3;    // + fa (+8), column m = 8j + 2*fb (+1)
  const int b_rows = wg * kWM * kKC;
  for (int64_t item = blockIdx.x; item < q.n_items; item += gridDim.x) {
    const int64_t slot_id = item / per_slot;
    const int64_t rest = item - slot_id * per_slot;
    const int cc = static_cast<int>(rest / q.n_rc);
    const int64_t row_off =
        q.row_base + (rest - static_cast<int64_t>(cc) * q.n_rc) * H;
    mbar_wait(&full_h[hs], hph);
    const int n_units = hdr[hs];
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty_h[hs]);
    if (++hs == kNH) {
      hs = 0;
      hph ^= 1;
    }
#pragma unroll
    for (int i = 0; i < NG * H / 2; ++i) acc[i] = 0;
#pragma unroll
    for (int i = 0; i < H / 2; ++i) cnt[i] = 0.f;

    fence_regs(acc);
    fence_regs(cnt);
    for (int u = 0; u < n_units; ++u) {
      mbar_wait(&full_a[ai], aph);
      const unsigned char* stack = a_ring + ai * AE;
      const unsigned char* a_occ = stack + kMaxSlices * H * kKC;
      // one batch of wgmmas a B slot, committed as a group; a slot is
      // freed once the batch after it is issued and its own is done, so
      // the tensor cores never drain between two batches of a unit
      int held = -1;  // the slot of the batch still in flight
      auto next_slot = [&]() {
        wg_commit();
        wg_wait<1>();
        __syncwarp();
        if (held >= 0 && lane == 0) mbar_arrive(&empty_b[held]);
        held = bi;
        if (++bi == NB) {
          bi = 0;
          bph ^= 1;
        }
      };
      // counts: the two 64-deep halves, four k16 steps each
      for (int half = 0; half < 2; ++half) {
        mbar_wait(&full_b[bi], bph);
        const uint64_t da = sw128_desc(b_ring + bi * kBSlot + b_rows);
        const uint64_t db = sw128_desc(a_occ + half * H * kKC);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_bf16<H>(cnt, da + 2 * kk, db + 2 * kk);
        }
        next_slot();
      }
      // products: B slice t against the A slices s with t + s < n_groups
      static_for<0, kMaxSlices>([&](auto tc) {
        constexpr int T = decltype(tc)::value;
        if (T < q.sb) {
          int ns = q.n_groups - T < q.sa ? q.n_groups - T : q.sa;
          mbar_wait(&full_b[bi], bph);
          wg_fence();
          slice_products<H, NG, T>(acc, b_ring + bi * kBSlot + b_rows,
                                   stack, ns);
          next_slot();
        }
      });
      wg_wait_all();
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&empty_b[held]);
        mbar_arrive(&empty_a[ai]);
      }
      if (++ai == kNA) {
        ai = 0;
        aph ^= 1;
      }
    }
    fence_regs(acc);
    fence_regs(cnt);

    // triple-float reduce of the group sums, in the reference's order;
    // register 4j + 2i + e holds row n = 16*(warp%4) + fa + 8i, column
    // m = 8j + 2*fb + e of the consumer's transposed 64 x h block.
    // Where every group sum of a warp lies in [-2^22, 2^22) (the common
    // case), mh = f32(M_p) is exact and its rest ml is +0; adding +0 by
    // TwoSum changes no bit (no sum here is ever -0), so the rests are
    // left out, and mh * 2^(-7p) is formed exactly without a conversion:
    // the bits of 1.5 * 2^(23-7p) plus M_p, less 1.5 * 2^(23-7p)
    const int64_t base = slot_id * q.tm * q.tn + row_off * q.tn + cc * kCN +
                         wg * kWM + 16 * (warp & 3) + fa;
    bool rounded = false;
#pragma unroll
    for (int i = 0; i < NG * H / 2; ++i) {
      rounded |= static_cast<uint32_t>(acc[i] + (1 << 22)) >= (1u << 23);
    }
    // in two halves of the registers, each unrolled, so fewer values are
    // live at once
    auto reduce_store = [&](auto with_rests, auto part) {
      constexpr int R0 = decltype(part)::value * H / 4;
#pragma unroll
      for (int r = R0; r < R0 + H / 4; ++r) {
        float hh = 0.f, mm = 0.f, ll = 0.f;
#pragma unroll
        for (int p = 0; p < NG; ++p) {
          if (p < q.n_groups) {
            const int32_t mp = acc[p * H / 2 + r];
            float e, e2;
            if constexpr (decltype(with_rests)::value) {
              const float mh = __int2float_rn(mp);
              const float scale = __int_as_float((127 - 7 * p) << 23);
              const float ml = __int2float_rn(mp - __float2int_rz(mh));
              two_sum(hh, __fmul_rn(mh, scale), hh, e);
              two_sum(mm, e, mm, e2);
              ll = __fadd_rn(ll, e2);
              two_sum(hh, __fmul_rn(ml, scale), hh, e);
              two_sum(mm, e, mm, e2);
              ll = __fadd_rn(ll, e2);
            } else {
              const int magic = ((150 - 7 * p) << 23) | 0x400000;
              const float x = __fsub_rn(__int_as_float(magic + mp),
                                        __int_as_float(magic));
              two_sum(hh, x, hh, e);
              two_sum(mm, e, mm, e2);
              ll = __fadd_rn(ll, e2);
            }
          }
        }
        const int m = 8 * (r >> 2) + 2 * fb + (r & 1);
        const int64_t off = base + m * q.tn + 8 * ((r >> 1) & 1);
        c_h[off] = hh;
        c_m[off] = mm;
        c_l[off] = ll;
        c_cnt[off] = cnt[r];
      }
    };
    using Lo = std::integral_constant<int, 0>;
    using Hi = std::integral_constant<int, 1>;
    if (__any_sync(0xffffffffu, rounded)) {
      reduce_store(std::true_type{}, Lo{});
      reduce_store(std::true_type{}, Hi{});
    } else {
      reduce_store(std::false_type{}, Lo{});
      reduce_store(std::false_type{}, Hi{});
    }
  }
}

// out[b][n][k] = in[b][k][n] (batch b, K x N -> N x K) for elements of
// E = 1 or 2 bytes: a tile of 64 k rows and 128 bytes of n goes through
// shared memory as 32-bit words; each thread turns 4x4 bytes (E 1) or 2x2
// halves (E 2) around with byte permutes, and the threads of a warp write
// whole 64- or 128-byte runs of output rows. Needs N*E % 128 == 0 and
// K*E % 4 == 0 (K a multiple of 16 here); rows k >= K are not written.
template <int E>
__global__ void __launch_bounds__(256)
transpose_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                 int64_t K, int64_t N, int64_t n_tiles) {
  constexpr int S = 33;           // words a tile row: 32 and one of skew
  constexpr int B = 4 / E;        // the square block a thread turns
  constexpr int KW = 64 / B;      // k blocks of the tile (words a row out)
  __shared__ uint32_t tile[64 * S];
  const int64_t b = blockIdx.x / n_tiles;
  const int64_t n0 = (blockIdx.x - b * n_tiles) * (128 / E);  // elements
  const int64_t k0 = static_cast<int64_t>(blockIdx.y) * 64;
  const uint8_t* src = in + (b * K * N + n0) * E;
  uint8_t* dst = out + b * N * K * E;
  for (int i = threadIdx.x; i < 64 * 8; i += 256) {
    const int kr = i >> 3;
    const int c = i & 7;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (k0 + kr < K) {
      v = *reinterpret_cast<const uint4*>(src + (k0 + kr) * N * E + c * 16);
    }
    uint32_t* t = tile + kr * S + c * 4;
    t[0] = v.x;
    t[1] = v.y;
    t[2] = v.z;
    t[3] = v.w;
  }
  __syncthreads();
  // block (kq, nw): k rows kq*B .. +B, the n elements of word nw
  for (int i = threadIdx.x; i < KW * 32; i += 256) {
    const int kq = i % KW;
    const int nw = i / KW;
    if (k0 + kq * B >= K) continue;
    uint32_t w[B];
#pragma unroll
    for (int j = 0; j < B; ++j) w[j] = tile[(kq * B + j) * S + nw];
    uint32_t o[B];
    if constexpr (E == 1) {
      const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
      const uint32_t t1 = __byte_perm(w[2], w[3], 0x5140);
      const uint32_t t2 = __byte_perm(w[0], w[1], 0x7362);
      const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
      o[0] = __byte_perm(t0, t1, 0x5410);
      o[1] = __byte_perm(t0, t1, 0x7632);
      o[2] = __byte_perm(t2, t3, 0x5410);
      o[3] = __byte_perm(t2, t3, 0x7632);
    } else {
      o[0] = __byte_perm(w[0], w[1], 0x5410);
      o[1] = __byte_perm(w[0], w[1], 0x7632);
    }
#pragma unroll
    for (int j = 0; j < B; ++j) {
      const int64_t n = n0 + nw * B + j;
      *reinterpret_cast<uint32_t*>(dst + (n * K + k0) * E + kq * 4) = o[j];
    }
  }
}

template <int E>
int launch_transpose(const void* in, void* out, int64_t batch, int64_t K,
                     int64_t N, cudaStream_t stream) {
  const int64_t n_tiles = N * E / 128;
  const dim3 grid(static_cast<unsigned>(batch * n_tiles),
                  static_cast<unsigned>((K + 63) / 64));
  transpose_kernel<E><<<grid, 256, 0, stream>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), K, N,
      n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// ---- host: tensor maps and launches --------------------------------------

struct Operands {
  const void *av8, *a_occ, *bt8, *bt_occ;
  const int32_t *aptr, *ak, *slots;
  float *c_h, *c_m, *c_l, *c_cnt;
  int64_t ntp, stack_rows, gk, tk;
};

template <int H, int NG>
int launch_height(const Operands& o, Params q, int64_t row_base,
                  unsigned n_rc, cudaStream_t stream) {
  constexpr int smem = smem_bytes(H);
  static bool ready[sm90::kMaxDevices] = {};
  cudaError_t err = sm90::set_smem_once(ozaki_wgmma_kernel<H, NG>, smem,
                                        true, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint64_t tk = static_cast<uint64_t>(o.tk);
  const uint64_t tm = static_cast<uint64_t>(q.tm);
  const uint64_t nb = static_cast<uint64_t>(q.sb * q.max_b * q.tn);
  const uint64_t no = static_cast<uint64_t>(q.max_b * q.tn);
  CUtensorMap map_a, map_ao, map_b, map_bo;
  // av8 as (k, row in slice, slice, tile): the A stack of a row chunk is
  // one box, slice s at rows s*h
  const uint64_t a_dims[4] = {tk, tm, static_cast<uint64_t>(o.stack_rows) / tm,
                              static_cast<uint64_t>(o.ntp)};
  const uint64_t a_strides[3] = {tk, tm * tk,
                                 static_cast<uint64_t>(o.stack_rows) * tk};
  const uint32_t a_box[4] = {kKC, H, static_cast<uint32_t>(q.sa), 1};
  // a_occ as (k, row), 64-deep boxes
  const uint64_t ao_dims[2] = {tk, static_cast<uint64_t>(o.ntp) * tm};
  const uint64_t ao_strides[1] = {2 * tk};
  const uint32_t ao_box[2] = {64, H};
  // the K-major B copies as (k, column, slab)
  const uint64_t b_dims[3] = {tk, nb, static_cast<uint64_t>(o.gk)};
  const uint64_t b_strides[2] = {tk, nb * tk};
  const uint32_t b_box[3] = {kKC, kCN, 1};
  const uint64_t bo_dims[3] = {tk, no, static_cast<uint64_t>(o.gk)};
  const uint64_t bo_strides[2] = {2 * tk, 2 * no * tk};
  const uint32_t bo_box[3] = {64, kCN, 1};
  if (!make_map(&map_a, CU_TENSOR_MAP_DATA_TYPE_UINT8, o.av8, 4, a_dims,
                a_strides, a_box) ||
      !make_map(&map_ao, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, o.a_occ, 2,
                ao_dims, ao_strides, ao_box) ||
      !make_map(&map_b, CU_TENSOR_MAP_DATA_TYPE_UINT8, o.bt8, 3, b_dims,
                b_strides, b_box) ||
      !make_map(&map_bo, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, o.bt_occ, 3,
                bo_dims, bo_strides, bo_box)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  q.row_base = row_base;
  q.n_rc = n_rc;
  q.n_items = q.n_slots * q.n_cc * q.n_rc;
  const unsigned grid =
      static_cast<unsigned>(q.n_items < sms ? q.n_items : sms);
  ozaki_wgmma_kernel<H, NG><<<grid, kThreads, smem, stream>>>(
      map_a, map_ao, map_b, map_bo, o.aptr, o.ak, o.slots, o.c_h, o.c_m,
      o.c_l, o.c_cnt, q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launches were accepted. `bt8` (gk,
// sb*max_b*tn, tk) int8 and `bt_occ` (gk, max_b*tn, tk) bf16 are scratch
// the caller allocates: the K-major copies of bv8 and b_occ. Launches on
// `stream`, does not synchronise, allocates nothing.
int ozaki_strip_f32(const void* av8, const void* a_occ, const void* bv8,
                    const void* b_occ, const void* aptr, const void* ak,
                    const void* slots, void* bt8, void* bt_occ, void* c_h,
                    void* c_m, void* c_l, void* c_cnt, int64_t gm,
                    int64_t block_rows, int64_t max_b, int64_t max_cblock,
                    int64_t n_blocks, int64_t tm, int64_t tk, int64_t tn,
                    int64_t stack_rows, int64_t sa, int64_t sb, int64_t pmax,
                    int64_t ntp, int64_t gk, void* stream) {
  const int64_t n_slots = n_blocks * max_cblock;
  const int64_t n_cc = tn / kCN;
  if (n_slots <= 0 || tm < 8 || tm % 8 != 0 || tn < 128 || tn % 128 != 0 ||
      tk < 16 || tk % 16 != 0 || max_b < 1 || block_rows < 1 || gm < 1 ||
      sa < 1 || sa > kMaxSlices || sb < 1 || sb > kMaxSlices || pmax < 0 ||
      stack_rows < sa * tm || ntp < 1 || gk < 1 ||
      n_slots * n_cc * (tm / 8) > INT32_MAX || ntp * tm > INT32_MAX ||
      sb * max_b * tn > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  // the K-major copies of B's slices and occupancy
  int err = launch_transpose<1>(bv8, bt8, gk, tk, sb * max_b * tn, st);
  if (err == 0) {
    err = launch_transpose<2>(b_occ, bt_occ, gk, tk, max_b * tn, st);
  }
  if (err != 0) return err;
  const int64_t ng64 = sa + sb - 1 < pmax + 1 ? sa + sb - 1 : pmax + 1;
  Params q{};
  q.gm = gm;
  q.block_rows = block_rows;
  q.max_b = max_b;
  q.max_cblock = max_cblock;
  q.tm = tm;
  q.tn = tn;
  q.n_cc = n_cc;
  q.sa = static_cast<int>(sa);
  q.sb = static_cast<int>(sb);
  q.n_groups = static_cast<int>(ng64);
  q.nkc = static_cast<int>((tk + kKC - 1) / kKC);
  q.n_slots = n_slots;
  const Operands o{av8,
                   a_occ,
                   bt8,
                   bt_occ,
                   static_cast<const int32_t*>(aptr),
                   static_cast<const int32_t*>(ak),
                   static_cast<const int32_t*>(slots),
                   static_cast<float*>(c_h),
                   static_cast<float*>(c_m),
                   static_cast<float*>(c_l),
                   static_cast<float*>(c_cnt),
                   ntp,
                   stack_rows,
                   gk,
                   tk};
  if (ng64 <= 8) {
    // as many 32-row chunks as fit, then one each of 16 and 8 rows
    return sm90::for_each_row_part<32, 16, 8>(
        tm, [&](auto h, int64_t row_base, unsigned n) {
          return launch_height<decltype(h)::value, 8>(o, q, row_base, n, st);
        });
  }
  // all 15 groups: 16-row chunks at most
  return sm90::for_each_row_part<16, 8>(
      tm, [&](auto h, int64_t row_base, unsigned n) {
        return launch_height<decltype(h)::value, 15>(o, q, row_base, n, st);
      });
}

}  // extern "C"
