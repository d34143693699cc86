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
// memory, and CTAs run in no order. So here one 256-thread CTA owns one
// padded C slot (blk, s). All eight warps scan the block's slot words,
// 256 per pass, and compact the hits in order (ballot, popc and a prefix
// over the warps), so the accumulation order is fixed and runs are
// reproducible. The tm x tn value and count tiles live in registers as
// mma accumulators, and the slot's tile is written once. No atomics, no
// host re-bucketing.
//
// Arithmetic on the tensor cores.
//   Values: TF32 mma.sync.m16n8k8 (tf32 in, f32 accumulate) on an exact
//   three-way split. Each f32 operand x is hi + mid + lo, three TF32
//   values (hi = cvt.rna.tf32(x), mid = cvt.rna.tf32(x - hi), lo the at
//   most 3 bits left), and the six partial products larger than 2^-33
//   |a.b| (lo.hi, hi.lo, mid.mid, mid.hi, hi.mid, hi.hi) go, smallest
//   first, into a zeroed partial sum that is then added to the
//   accumulator with an ordinary (round-to-nearest) f32 add. So every
//   product is exact to far below f32 rounding, and the sum is as
//   accurate as a sequential f32 sum, which the reference's
//   Precision.HIGHEST is. Two cheaper schemes were measured short of it:
//   3xTF32 (hi, lo = cvt.rna.tf32(x - hi), three products) leaves about
//   2^-22 |a.b| per product, four times an f32 product's rounding; and
//   accumulating the products in place lets the mma's truncating
//   alignment lose up to an ulp of the running sum per product, always
//   downward (1.6x rtol 1e-5 on sums of ~370 positive products, where
//   this kernel now stays at 0.1x; kernel_ab.py).
//   Where every operand of a warp's k step is already a TF32 value (its
//   low 13 mantissa bits zero: integers below 2^11, the bench's value
//   model), the split is not needed: the step runs one product on the raw
//   bits. With integer values every product and partial sum is an integer
//   below 2^24, so C equals the plain f32 version bit for bit.
//   Counts: the occupancy planes are already bf16 0/1, so they go
//   straight into mma.sync.m16n8k16 (bf16 in, f32 accumulate), loaded
//   with ldmatrix (.trans for the N-major B slab): exact counts, no
//   conversion pass.
//   wgmma is not used: tf32 wgmma needs a K-major B in shared memory and
//   the B slab is N-major, and a C slot's few k-steps leave little for
//   an asynchronous warpgroup product to hide.
//
// The tile pipeline (staging ring, products, store) lives in
// tile_pipeline.cuh, shared with the pair kernel (pair_accumulate.cu),
// which feeds it from a pair_ptr range instead of the slot scan.
//
// Tile shapes. Any tm % 8 == 0 and tn % 128 == 0, the tiles the TPU
// kernels take. A C slot's tm x tn tile is cut into chunks of h x 128, h
// one of the instantiated heights: as many 64-row chunks as fit, then at
// most one 32-, 16- and 8-row chunk (tile_pipeline.cuh:launch_row_parts;
// 128 -> 64 + 64, 40 -> 32 + 8, 24 -> 16 + 8, an 8-row chunk a
// half-empty m16 tile), one launch per height and in it one CTA per
// (slot, row chunk = blockIdx.y, column chunk = blockIdx.z). A chunk
// reads rows r .. r+h of its A tiles (r = row_base + blockIdx.y*h) and
// columns z*128 .. +128 of each B column block y (B slab row stride
// max_b*tn, block y at column y*tn), and writes that part of the slot's
// tile. Each chunk CTA scans the block's slot words itself: a tile of q
// row chunks and n column chunks scans them q*n times and stages each A
// chunk n times and each B chunk q times.
//
// Staging. The k range of every matched (g, y) pair is cut into 32-deep
// chunks, and the chunks of all the slot's pairs form one stream of
// steps. A ring of STAGES buffers in dynamic shared memory (A values and
// occupancy TM x 32, B values and occupancy 32 x 128, rows padded against
// bank conflicts) is filled by cp.async 16-byte copies, one barrier per
// step, so the next step's copies run under this step's mma. With at most
// 128 registers a thread (__launch_bounds__(256, 2)) and 81-100 KB of
// shared memory, two CTAs share an SM, so one slot's epilogue (64 KB of
// stores at 64x128) overlaps another slot's loads.
//
// What bounds it on the card. At the cant-like headline (64x128 A tiles,
// 5,844 pairs, 3,968 padded slots) the bytes each read or written once
// are 503 MB: A planes 97 MB, B slab 144 MB, C planes 260 MB, so 0.150 ms
// at 3.35 TB/s. The operations (12.3 GFLOP of TF32 on the integer model,
// six times that with split values, at 495 TFLOP/s, and 12.3 GFLOP of
// bf16 at 989) need 0.037-0.162 ms. So the bytes bound it on integer
// values, and the C planes' block padding is the largest part of them.
//
// Limits (checked by the caller, spgemm_tpu_torch/ops/kernels.py):
//   tm % 8 == 0 and tn % 128 == 0, tm/64 and tn/128 <= 65,535 (grid y
//   and z); tk % 8 == 0 (16-byte copies of bf16 rows);
//   n_blocks*max_cblock < 2^31 (grid x); one block's A tiles times
//   max_b < 2^31. All element offsets are int64.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC strip_numeric.cu -o libstrip_numeric.so

#include <cstdint>
#include <cuda_runtime.h>

#include "tile_pipeline.cuh"

namespace {

using namespace tile_pipeline;

constexpr int kScan = kThreads;      // slot words scanned per pass

// One CTA per (padded C slot, row chunk, column chunk); TM is the chunk
// height h, row_base the first row of this launch's chunks, tm and tn
// the tile's.
template <int TM>
__global__ void __launch_bounds__(kThreads, 2)
strip_numeric_kernel(const float* __restrict__ a_val,
                     const uint16_t* __restrict__ a_occ,
                     const float* __restrict__ b_val,
                     const uint16_t* __restrict__ b_occ,
                     const int32_t* __restrict__ aptr,
                     const int32_t* __restrict__ ak,
                     const int32_t* __restrict__ slots,
                     float* __restrict__ c_val,
                     float* __restrict__ c_cnt,
                     int64_t gm, int64_t block_rows, int64_t max_b,
                     int64_t max_cblock, int64_t row_base, int64_t tm,
                     int64_t tk, int64_t tn) {
  using C = Cfg<TM>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int32_t match_g[kScan];  // A tile of each matched entry
  __shared__ int32_t match_y[kScan];  // and its B column block
  __shared__ int32_t warp_hits[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = (warp / C::WN) * 16;          // the warp's C rows
  const int n0 = (warp % C::WN) * C::NT * 8;   // and columns
  const int64_t slot_id = blockIdx.x;
  const int64_t blk = slot_id / max_cblock;
  const int32_t s = static_cast<int32_t>(slot_id - blk * max_cblock);
  const int64_t r0 = blk * block_rows;
  const int64_t r1 = r0 + block_rows < gm ? r0 + block_rows : gm;
  const int64_t e_begin = static_cast<int64_t>(aptr[r0]) * max_b;
  const int64_t e_end = static_cast<int64_t>(aptr[r1]) * max_b;
  const int64_t ldb = max_b * tn;  // B slab row stride, elements
  const int64_t a_tile = tm * tk;  // A tile stride, elements
  // this CTA's chunk: A rows from row_base + blockIdx.y * TM, B and C
  // columns from blockIdx.z * 128
  const int64_t row_off = row_base + static_cast<int64_t>(blockIdx.y) * TM;
  const int64_t col_off = static_cast<int64_t>(blockIdx.z) * kTN;
  const float* a_chunk = a_val + row_off * tk;
  const uint16_t* ao_chunk = a_occ + row_off * tk;
  const float* b_chunk = b_val + col_off;
  const uint16_t* bo_chunk = b_occ + col_off;
  const int nch = static_cast<int>((tk + kKC - 1) / kKC);

  if (TM < 16) {
    // rows TM..15 of the m16 A tiles are never copied: keep them zero
    // (the scan's barriers below land this before any copy)
    uint4* z = reinterpret_cast<uint4*>(smem);
    for (int i = tid; i < C::SMEM / 16; i += kThreads) {
      z[i] = make_uint4(0u, 0u, 0u, 0u);
    }
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

  // copies k chunk `step % nch` of match `step / nch` into stage `st`
  auto load_step = [&](unsigned char* st, int step) {
    const int mi = step / nch;
    const int64_t k0 = static_cast<int64_t>(step - mi * nch) * kKC;
    const int64_t g = match_g[mi];
    const int64_t a_off = g * a_tile + k0;
    const int64_t b_off = (static_cast<int64_t>(ak[g]) * tk + k0) * ldb +
                          static_cast<int64_t>(match_y[mi]) * tn;
    const int kmax = static_cast<int>(tk - k0 < kKC ? tk - k0 : kKC);
    load_stage<TM>(st, a_chunk + a_off, ao_chunk + a_off, tk, kmax,
                   b_chunk + b_off, bo_chunk + b_off, ldb, kmax, a_val,
                   a_occ, b_val, b_occ);
  };

  for (int64_t e0 = e_begin; e0 < e_end; e0 += kScan) {
    // ordered compaction of this pass's slot words that name slot s
    const int64_t e = e0 + tid;
    const bool hit = e < e_end && slots[e] == s;
    const unsigned ball = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[warp] = __popc(ball);
    __syncthreads();
    int base = 0;
    int nm = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int h = warp_hits[w];
      base += w < warp ? h : 0;
      nm += h;
    }
    if (hit) {
      const int idx = base + __popc(ball & ((1u << lane) - 1u));
      const int64_t g = e / max_b;
      match_g[idx] = static_cast<int32_t>(g);
      match_y[idx] = static_cast<int32_t>(e - g * max_b);
    }
    __syncthreads();
    if (nm == 0) continue;
    // the stream of (match, k chunk) steps through the cp.async ring; it
    // ends with a barrier, so the matches are free for the next pass
    stream_steps<TM>(nm * nch, smem, load_step, acc_v, acc_c, m0, n0, lane);
  }

  const int64_t c_off = slot_id * tm * tn + row_off * tn + col_off;
  store_tile<TM>(c_val + c_off, c_cnt + c_off, tn, acc_v, acc_c, m0, n0,
                 lane);
}

template <int TM>
int launch(dim3 grid, cudaStream_t stream, const float* a_val,
           const uint16_t* a_occ, const float* b_val, const uint16_t* b_occ,
           const int32_t* aptr, const int32_t* ak, const int32_t* slots,
           float* c_val, float* c_cnt, int64_t gm, int64_t block_rows,
           int64_t max_b, int64_t max_cblock, int64_t row_base, int64_t tm,
           int64_t tk, int64_t tn) {
  using C = Cfg<TM>;
  // all of the SM's unified L1/shared memory to shared, so two CTAs fit;
  // set once per device
  static bool ready[kMaxDevices] = {};
  const cudaError_t err =
      set_smem_once(strip_numeric_kernel<TM>, C::SMEM, true, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  strip_numeric_kernel<TM><<<grid, kThreads, C::SMEM, stream>>>(
      a_val, a_occ, b_val, b_occ, aptr, ak, slots, c_val, c_cnt, gm,
      block_rows, max_b, max_cblock, row_base, tm, tk, tn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted. Launches on
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
      max_b < 1 || block_rows < 1 || gm < 1 || !tile_taken(tm, tn)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const auto* av = static_cast<const float*>(a_val);
  const auto* ao = static_cast<const uint16_t*>(a_occ);
  const auto* bv = static_cast<const float*>(b_val);
  const auto* bo = static_cast<const uint16_t*>(b_occ);
  const auto* ap = static_cast<const int32_t*>(aptr);
  const auto* kk = static_cast<const int32_t*>(ak);
  const auto* sl = static_cast<const int32_t*>(slots);
  auto* cv = static_cast<float*>(c_val);
  auto* cc = static_cast<float*>(c_cnt);
  const auto col_chunks = static_cast<unsigned>(tn / kTN);
  return launch_row_parts(tm, [&](auto h, int64_t row_base, unsigned n) {
    const dim3 grid(static_cast<unsigned>(n_slots), n, col_chunks);
    return launch<decltype(h)::value>(grid, st, av, ao, bv, bo, ap, kk, sl,
                                      cv, cc, gm, block_rows, max_b,
                                      max_cblock, row_base, tm, tk, tn);
  });
}

}  // extern "C"
