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
// DMAs break Mosaic's 128-alignment rule). Here the strip kernel's tile
// pipeline (tile_pipeline.cuh, shared with csrc/strip_numeric.cu) runs
// it: one persistent, warp-specialised 384-thread CTA per SM walks the
// (C tile, 128-column chunk, row chunk) items; a lookup warp reads each
// tile's pair_ptr range, 32 entries a pass, and publishes the pairs as
// records; one thread streams, per pair in schedule order and 32-deep k
// chunk, TMA loads of the A rows and B columns into a ring that runs
// across items, so the next pair's and the next item's first stages land
// under this one's products; two consumer warpgroups compute C^T =
// B^T . A^T with tf32 wgmma, values as the strip kernel's exact three-way
// TF32 split (hi + mid + lo per operand, the six partial products above
// 2^-33 |a.b| into a zeroed partial sum that one round-to-nearest add
// folds into the accumulator), with one product on the raw bits where a
// stage's operands are all TF32 values, which keeps the integer model
// bit-equal to the plain f32 version; counts as bf16 wgmma on the 0/1
// planes. The chunk's accumulators live in registers and the chunk is
// written once, as zero where the tile has no pair. No atomics, a fixed
// accumulation order. The strip kernel differs only in how a C tile finds
// its pairs (a scan of its block's slot words).
//
// Tile shapes. Any tm % 8 == 0 and tn % 128 == 0, the tiles the TPU
// kernel takes: a tm x tn C tile is cut into chunks of h x 128 (as many
// 64-row chunks as fit, then at most one of 32, 16 and 8 rows,
// tile_pipeline.cuh:launch_row_parts), one launch per height, each chunk
// reading rows r .. r+h of its A tiles and columns z*128 .. +128 of its B
// tiles. So a tile's pair list is walked once per chunk, and each B tile
// staged once per row chunk.
//
// Any tk >= 1: the bf16 occupancy rows need 16-byte strides for TMA, so
// the wrapper pads A's rows to lda = tk rounded up to 8 with zero columns
// when tk % 8 != 0 (B's rows are tn wide, a multiple of 128, always
// aligned); the maps' inner extents are tk, so the tail stage's columns
// and rows past tk are zero-filled by TMA.
//
// What bounds it on the card. On the cant-like 62,451^2 A^2 at 64x128 A
// tiles and 128x128 B tiles (1,950 A and 1,462 B tiles, 5,844 pairs,
// 3,896 C tiles of 1 or 2 pairs each) the reference's f32 planes, each
// read or written once, are 575 MB: A 2 x 64 MB, B 2 x 96 MB, C 2 x 128
// MB, 0.172 ms at 3.35 TB/s. With bf16 occupancy the kernel's own inputs
// and outputs are 495 MB. The operations (5,844 dense 64x128x128
// products: 12.3 GFLOP of TF32 at 495 TFLOP/s on the integer model, six
// times that with split values, and 12.3 GFLOP of bf16 at 989) need
// 0.037-0.162 ms. So the bytes bound it, the C planes most. The
// mma.sync design before this one (0.372 ms integer, 0.700 ms Gaussian,
// PERF.md) ran one 256-thread CTA per chunk that filled and drained a
// 2-stage cp.async ring for one or two pairs.
//
// Limits (checked by the caller, spgemm_tpu_torch/ops/pair_kernels.py):
//   tm % 8 == 0 and tn % 128 == 0, at most 65,535 chunks of each; any tk
//   >= 1 with lda % 8 == 0, lda >= tk; num_segments < 2^31; every plane
//   16-byte aligned. All element offsets are int64.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC pair_accumulate.cu -o libpair_accumulate.so

#include <cstdint>
#include <cuda_runtime.h>

#include "tile_pipeline.cuh"

namespace {

using namespace tile_pipeline;

// The pair schedule's lookup: C tile i takes pairs pair_ptr[i] ..
// pair_ptr[i+1] - 1 in order, A tile pa[j] and B tile pb[j].
struct PairWalk {
  const int32_t* pa;
  const int32_t* pb;
  const int32_t* pair_ptr;

  // the lanes read 32 consecutive pairs a pass
  template <typename Emit>
  __device__ __forceinline__ void pairs(int64_t seg, int lane,
                                        Emit&& emit) const {
    const int hi = pair_ptr[seg + 1];
    for (int j0 = pair_ptr[seg]; j0 < hi; j0 += 32) {
      const int j = j0 + lane;
      const bool hit = j < hi;
      emit(hit, hit ? pa[j] : 0, hit ? pb[j] : 0, 0);
    }
  }
};

template <int H>
__global__ void __launch_bounds__(kThreads, 1)
pair_accumulate_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_ao,
                       const __grid_constant__ CUtensorMap map_b,
                       const __grid_constant__ CUtensorMap map_bo,
                       const __grid_constant__ CUtensorMap map_cv,
                       const __grid_constant__ CUtensorMap map_cc,
                       const PairWalk walk, const Items q) {
  extern __shared__ unsigned char smem_raw[];
  run_items<H>(smem_raw, &map_a, &map_ao, &map_b, &map_bo, &map_cv, &map_cc,
               walk, q);
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launches were accepted (and 0 with
// nothing launched when num_segments is 0). a_occ and b_occ are bf16 0/1;
// a_val and a_occ rows are lda elements apart (lda >= tk, lda % 8 == 0,
// columns past tk zero). Launches on `stream`, does not synchronise,
// allocates nothing.
int pair_accumulate_f32(const void* a_val, const void* a_occ,
                        const void* b_val, const void* b_occ, const void* pa,
                        const void* pb, const void* pair_ptr, void* c_val,
                        void* c_cnt, int64_t num_segments, int64_t tm,
                        int64_t tk, int64_t tn, int64_t lda, void* stream) {
  if (num_segments < 0 || num_segments > INT32_MAX || tk < 1 ||
      lda < tk || lda % 8 != 0 || !tile_taken(tm, tn)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_segments == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const PairWalk walk{static_cast<const int32_t*>(pa),
                      static_cast<const int32_t*>(pb),
                      static_cast<const int32_t*>(pair_ptr)};
  const Planes p{a_val, a_occ, b_val, b_occ, c_val, c_cnt,
                 tm,    tk,    lda,   tn,    tn,    num_segments};
  return launch_row_parts(tm, [&](auto h, int64_t row_base, unsigned n) {
    constexpr int H = decltype(h)::value;
    return launch_items<H>(pair_accumulate_kernel<H>, p, row_base, n, st,
                           walk);
  });
}

// The version of pair_accumulate_f32's interface: 2 is the one above (bf16
// occupancy, row stride lda). Libraries built before it export no such
// symbol and take f32 occupancy without lda.
int pair_accumulate_abi(void) { return 2; }

}  // extern "C"
