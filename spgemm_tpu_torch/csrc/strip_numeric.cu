// Strip SpGEMM numeric kernel for Hopper (sm_90a), C ABI for ctypes.
//
// Replaces both Pallas strip kernels of the JAX package:
//   spgemm_tpu/ops/pallas_kernels.py:_strip_window_kernel_factory (:406)
//   spgemm_tpu/ops/pallas_kernels.py:_strip_kernel_factory        (:219)
// reached through gustavson_strip_pallas (:538). Both compute the same
// function from the same plan (the windowed variant's `meta` rows hold
// exactly [ak, slots] per tile), so one kernel that reads ak/slots serves
// both plan shapes (kwin set or not).
//
// What it computes. For every A tile g of block blk (tile-rows
// [blk*block_rows, min((blk+1)*block_rows, gm))) and every y < max_b with
// slots[g*max_b + y] = s < max_cblock:
//   c_val[blk*max_cblock + s] += A_val[g] . B_val[ak[g]][:, y*tn:(y+1)*tn]
//   c_cnt[blk*max_cblock + s] += A_occ[g] . B_occ[ak[g]][:, y*tn:(y+1)*tn]
// in the same block-padded layout (n_blocks*max_cblock, tm, tn) as the
// TPU kernel. Padded pairs point at slot max_cblock, which no CTA owns,
// so they are dropped; every slot no pair reaches is written as zero.
// Counts are f32 sums of the 0/1 bfloat16 planes: exact up to 2^24
// products per element, and only ever read as > 0.
//
// What differs from the TPU kernel, and why. The TPU kernel keeps a whole
// block's C tiles in VMEM ((max_cblock+1)*tm*tn values and counts, about
// 6.3 MB per buffer on the cant-like headline) and carries a B-slab cache
// from grid step to grid step. An H100 CTA has at most 227 KB of shared
// memory, and CTAs run in no order. So here a C slot's tile is cut into
// h x 128 chunks, and the chunk's value and count tiles live in the
// registers of one CTA as wgmma accumulators and are written once. The
// CTA finds the slot's pairs by an ordered ballot scan of the block's slot
// words (ascending word index, as the TPU kernel walks them), so the
// accumulation order is fixed and runs are reproducible. No atomics, no
// host re-bucketing.
//
// Design: the shared tile pipeline (tile_pipeline.cuh, with the pair
// kernel, pair_accumulate.cu, which differs only in its pair lookup):
// one persistent, warp-specialised 384-thread CTA per SM walks the (slot,
// 128-column chunk, row chunk) items. A lookup warp scans an item's slot
// words 32 at a time with a ballot (ascending word order) and publishes
// the matched (A tile g, B slab ak[g], column block y) triples as pair
// records; one thread streams, per pair and 32-deep k chunk, TMA loads
// of the A rows (k-contiguous, the K-major layout tf32 wgmma needs) and
// the B columns (y*tn + the chunk's 128) into a ring that runs across
// items; two consumer warpgroups compute C^T = B^T . A^T with tf32 wgmma
// (B^T from registers, A^T from shared memory), values as an exact
// three-way TF32 split (six products into a zeroed partial sum, one
// round-to-nearest add, bit-equal to the plain version on TF32-exact
// operands), counts with bf16 wgmma. The pipeline's header gives the
// details.
//
// Variants of this design that lost on the card (H100, the cant-like
// plan, integer and Gaussian values): one producer warp doing both the
// lookups and the TMA loads (the lookups' global-memory latency stalled
// the ring); ring slots released a stage late with wgmma groups left in
// flight across stages, and the next stage prepared under this stage's
// last group (ptxas serialised the wgmmas, C7515 and C7513); the flag
// and the split done by two producer warps so the consumer warpgroups
// share no barrier (they spill at the producer's 40 registers); C staged
// through shared memory for TMA stores at 64-row chunks (one ring stage
// fewer, spills: slower than direct stores there, faster below, so the
// pipeline takes each where it won).
//
// Tile shapes. Any tm % 8 == 0 and tn % 128 == 0, the tiles the TPU
// kernels take: chunks of h x 128, h one of 64, 32, 16, 8 (as many 64-row
// chunks as fit, then at most one of each smaller height; 128 -> 64 + 64,
// 40 -> 32 + 8), one launch per height. A chunk reads rows r .. r+h of its
// A tiles and columns z*128 .. +128 of each B column block y (B slab row
// stride max_b*tn, block y at column y*tn). Each chunk scans the block's
// slot words itself: a tile of q row chunks and n column chunks scans
// them q*n times and stages each A chunk n times and each B chunk q times.
//
// What bounds it on the card. At the cant-like headline (64x128 A tiles,
// 5,844 pairs, 3,968 padded slots) the bytes each read or written once
// are 503 MB: A planes 97 MB, B slab 144 MB, C planes 260 MB, so 0.150 ms
// at 3.35 TB/s. The operations (12.3 GFLOP of TF32 on the integer model,
// six times that with split values, at 495 TFLOP/s, and 12.3 GFLOP of
// bf16 at 989) need 0.037-0.162 ms. So the bytes bound it on integer
// values, and the C planes' block padding is the largest part of them.
// What the mma.sync design before this one lost to (0.379 ms integer,
// 0.727 ms Gaussian, PERF.md): one 256-thread CTA per padded slot filled
// a 2-stage cp.async ring from empty for about six steps, drained it and
// stored its 64 KB before the SM took another slot, and split each B
// value once per warp along m.
//
// Limits (checked by the caller, spgemm_tpu_torch/ops/kernels.py):
//   tm % 8 == 0 and tn % 128 == 0, at most 65,535 chunks of each; tk %
//   8 == 0 (the bf16 rows' 16-byte TMA strides); n_blocks*max_cblock <
//   2^31 slots, max_b*tn < 2^31 (TMA column coordinates); every plane
//   16-byte aligned. All element offsets are int64.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC strip_numeric.cu -o libstrip_numeric.so

#include <cstdint>
#include <cuda_runtime.h>

#include "tile_pipeline.cuh"

namespace {

using namespace tile_pipeline;

// The strip plan's pair lookup: slot s of block blk is reached by every
// slot word e of the block's A tiles with slots[e] == s, A tile g = e /
// max_b and B column block y = e % max_b, in ascending e.
struct StripWalk {
  const int32_t* aptr;
  const int32_t* ak;
  const int32_t* slots;
  int64_t gm, block_rows, max_b, max_cblock, tn;

  __device__ __forceinline__ void words(int64_t slot_id, int64_t& e_begin,
                                        int64_t& e_end, int32_t& s) const {
    const int64_t blk = slot_id / max_cblock;
    s = static_cast<int32_t>(slot_id - blk * max_cblock);
    const int64_t r0 = blk * block_rows;
    const int64_t r1 = r0 + block_rows < gm ? r0 + block_rows : gm;
    e_begin = static_cast<int64_t>(aptr[r0]) * max_b;
    e_end = static_cast<int64_t>(aptr[r1]) * max_b;
  }

  // every lane scans one of each 32 consecutive words and emits it
  template <typename Emit>
  __device__ __forceinline__ void pairs(int64_t slot_id, int lane,
                                        Emit&& emit) const {
    int64_t e_begin, e_end;
    int32_t s;
    words(slot_id, e_begin, e_end, s);
    for (int64_t e0 = e_begin; e0 < e_end; e0 += 32) {
      const int64_t e = e0 + lane;
      const bool hit = e < e_end && slots[e] == s;
      int ga = 0, gb = 0, bcol = 0;
      if (hit) {
        const int64_t g = e / max_b;
        ga = static_cast<int>(g);
        gb = ak[g];
        bcol = static_cast<int>((e - g * max_b) * tn);
      }
      emit(hit, ga, gb, bcol);
    }
  }
};

template <int H>
__global__ void __launch_bounds__(kThreads, 1)
strip_numeric_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_ao,
                     const __grid_constant__ CUtensorMap map_b,
                     const __grid_constant__ CUtensorMap map_bo,
                     const __grid_constant__ CUtensorMap map_cv,
                     const __grid_constant__ CUtensorMap map_cc,
                     const StripWalk walk, const Items q) {
  extern __shared__ unsigned char smem_raw[];
  run_items<H>(smem_raw, &map_a, &map_ao, &map_b, &map_bo, &map_cv, &map_cc,
               walk, q);
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launches were accepted. Launches on
// `stream`, does not synchronise, allocates nothing.
int strip_numeric_f32(const void* a_val, const void* a_occ,
                      const void* b_val, const void* b_occ,
                      const void* aptr, const void* ak, const void* slots,
                      void* c_val, void* c_cnt, int64_t gm,
                      int64_t block_rows, int64_t max_b, int64_t max_cblock,
                      int64_t n_blocks, int64_t tm, int64_t tk, int64_t tn,
                      void* stream) {
  const int64_t n_slots = n_blocks * max_cblock;
  if (n_slots <= 0 || n_slots > INT32_MAX || tk < 8 || tk % 8 != 0 ||
      max_b < 1 || block_rows < 1 || gm < 1 || !tile_taken(tm, tn) ||
      max_b * tn > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const StripWalk walk{static_cast<const int32_t*>(aptr),
                       static_cast<const int32_t*>(ak),
                       static_cast<const int32_t*>(slots),
                       gm,
                       block_rows,
                       max_b,
                       max_cblock,
                       tn};
  const Planes p{a_val, a_occ, b_val, b_occ, c_val,      c_cnt,
                 tm,    tk,    tk,    max_b * tn, tn, n_slots};
  return launch_row_parts(tm, [&](auto h, int64_t row_base, unsigned n) {
    constexpr int H = decltype(h)::value;
    return launch_items<H>(strip_numeric_kernel<H>, p, row_base, n, st, walk);
  });
}

}  // extern "C"
