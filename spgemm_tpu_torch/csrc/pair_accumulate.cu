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
// one h x 128 chunk of a C tile and runs the strip kernel's tile pipeline
// (tile_pipeline.cuh, shared with csrc/strip_numeric.cu):
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
// Tile shapes. Any tm % 8 == 0 and tn % 128 == 0, the tiles the TPU
// kernel takes: a tm x tn C tile is cut into chunks of h x 128 (as many
// 64-row chunks as fit, then at most one of 32, 16 and 8 rows,
// tile_pipeline.cuh:launch_row_parts), one launch per height and in it
// one CTA per (C tile, row chunk = blockIdx.y, column chunk =
// blockIdx.z), each reading rows r .. r+h of its A tiles (r = row_base +
// blockIdx.y*h) and columns z*128 .. +128 of its B tiles. So a tile's
// pair list is walked once per chunk, and each B tile staged once per row
// chunk.
//
// Any tk >= 1: A rows are read with 16-byte copies, so the wrapper pads
// A's rows to lda = tk rounded up to 8 with zero columns when tk % 8 != 0
// (B's rows are tn wide, a multiple of 128, always aligned); the tail
// chunk's rows past tk are zero-filled by cp.async's source size.
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
//   tm % 8 == 0 and tn % 128 == 0 (h 8 runs half-empty m16 tiles), tm/64
//   and tn/128 <= 65,535 (grid y and z); any tk >= 1 with lda % 8 == 0,
//   lda >= tk; num_segments < 2^31 (grid x). All element offsets are
//   int64.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC pair_accumulate.cu -o libpair_accumulate.so

#include <cstdint>
#include <cuda_runtime.h>

#include "tile_pipeline.cuh"

namespace {

using namespace tile_pipeline;

// One CTA per (C tile, row chunk, column chunk); TM is the chunk height
// h, row_base the first row of this launch's chunks, tm and tn the
// tile's.
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
                       float* __restrict__ c_cnt, int64_t row_base,
                       int64_t tm, int64_t tk, int64_t tn, int64_t lda) {
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
  // this CTA's chunk: A rows from row_base + blockIdx.y * TM, B and C
  // columns from blockIdx.z * 128
  const int64_t row_off = row_base + static_cast<int64_t>(blockIdx.y) * TM;
  const int64_t col_off = static_cast<int64_t>(blockIdx.z) * kTN;
  const int64_t a_tile = tm * lda;  // A tile stride, elements
  const int64_t b_tile = tk * tn;   // B tile stride, elements
  const float* a_chunk = a_val + row_off * lda;
  const uint16_t* ao_chunk = a_occ + row_off * lda;
  const float* b_chunk = b_val + col_off;
  const uint16_t* bo_chunk = b_occ + col_off;

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
    const int64_t a_off = static_cast<int64_t>(pa[lo + pi]) * a_tile + k0;
    const int64_t b_off = static_cast<int64_t>(pb[lo + pi]) * b_tile +
                          k0 * tn;
    const int kmax_a = static_cast<int>(lda - k0 < kKC ? lda - k0 : kKC);
    const int kmax_b = static_cast<int>(tk - k0 < kKC ? tk - k0 : kKC);
    load_stage<TM>(st, a_chunk + a_off, ao_chunk + a_off, lda, kmax_a,
                   b_chunk + b_off, bo_chunk + b_off, tn, kmax_b, a_val,
                   a_occ, b_val, b_occ);
  };
  stream_steps<TM>(n_pairs * nch, smem, load_step, acc_v, acc_c, m0, n0,
                   lane);

  const int64_t c_off = seg * tm * tn + row_off * tn + col_off;
  store_tile<TM>(c_val + c_off, c_cnt + c_off, tn, acc_v, acc_c, m0, n0,
                 lane);
}

template <int TM>
int launch(dim3 grid, cudaStream_t stream, const float* a_val,
           const uint16_t* a_occ, const float* b_val, const uint16_t* b_occ,
           const int32_t* pa, const int32_t* pb, const int32_t* pair_ptr,
           float* c_val, float* c_cnt, int64_t row_base, int64_t tm,
           int64_t tk, int64_t tn, int64_t lda) {
  using C = Cfg<TM>;
  // all of the SM's unified L1/shared memory to shared, so two CTAs fit;
  // set once per device
  static bool ready[kMaxDevices] = {};
  const cudaError_t err =
      set_smem_once(pair_accumulate_kernel<TM>, C::SMEM, true, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_accumulate_kernel<TM><<<grid, kThreads, C::SMEM, stream>>>(
      a_val, a_occ, b_val, b_occ, pa, pb, pair_ptr, c_val, c_cnt, row_base,
      tm, tk, tn, lda);
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
  if (num_segments < 0 || num_segments > INT32_MAX || tk < 1 ||
      lda < tk || lda % 8 != 0 || !tile_taken(tm, tn)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_segments == 0) return 0;
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
  const auto col_chunks = static_cast<unsigned>(tn / kTN);
  return launch_row_parts(tm, [&](auto h, int64_t row_base, unsigned n) {
    const dim3 grid(static_cast<unsigned>(num_segments), n, col_chunks);
    return launch<decltype(h)::value>(grid, st, av, ao, bv, bo, p_a, p_b, pp,
                                      cv, cc, row_base, tm, tk, tn, lda);
  });
}

// The version of pair_accumulate_f32's interface: 2 is the one above (bf16
// occupancy, row stride lda). Libraries built before it export no such
// symbol and take f32 occupancy without lda.
int pair_accumulate_abi(void) { return 2; }

}  // extern "C"
