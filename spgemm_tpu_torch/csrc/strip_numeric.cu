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
// The pair kernel (pair_accumulate.cu) runs the same tile pipeline on a
// pair_ptr range instead of the slot scan; it keeps its own copy, so this
// kernel's generated code stays as it was.
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
//   (tm, tn) in {(8,128), (16,128), (32,128), (64,128)} (tm 8 runs
//   half-empty m16 tiles); tk % 8 == 0 (16-byte copies of bf16 rows);
//   n_blocks*max_cblock < 2^31 (grid size); one block's A tiles times
//   max_b < 2^31. All element offsets are int64.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC strip_numeric.cu -o libstrip_numeric.so

#include <cstdint>
#include <cuda_runtime.h>

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTN = 128;
constexpr int kKC = 32;              // k depth of one pipeline step
constexpr int kStagesTm64 = 2;       // ring depth at tm 64 (others: 3)
constexpr int kScan = kThreads;      // slot words scanned per pass
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

// x = hi + mid + lo exactly, each a TF32 value: hi and mid carry 11
// significant bits each, and lo the at most 3 that remain of f32's 24
__device__ __forceinline__ void split3_tf32(float x, uint32_t& hi,
                                            uint32_t& mid, uint32_t& lo) {
  uint32_t m;
  split_tf32(x, hi, m);  // m = rna(x - hi)
  mid = m;
  const float rest = x - __uint_as_float(hi) - __uint_as_float(mid);
  lo = __float_as_uint(rest);  // exact in f32, and TF32-exact
}

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
                     int64_t max_cblock, int64_t tk) {
  using C = Cfg<TM>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int32_t match_g[kScan];  // A tile of each matched entry
  __shared__ int32_t match_y[kScan];  // and its B column block
  __shared__ int32_t warp_hits[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;  // mma fragment row / column group
  const int tig = lane & 3;   // thread in group
  const int m0 = (warp / C::WN) * 16;          // the warp's C rows
  const int n0 = (warp % C::WN) * C::NT * 8;   // and columns
  const int64_t slot_id = blockIdx.x;
  const int64_t blk = slot_id / max_cblock;
  const int32_t s = static_cast<int32_t>(slot_id - blk * max_cblock);
  const int64_t r0 = blk * block_rows;
  const int64_t r1 = r0 + block_rows < gm ? r0 + block_rows : gm;
  const int64_t e_begin = static_cast<int64_t>(aptr[r0]) * max_b;
  const int64_t e_end = static_cast<int64_t>(aptr[r1]) * max_b;
  const int64_t ldb = max_b * kTN;  // B slab row stride, elements
  const int nch = static_cast<int>((tk + kKC - 1) / kKC);

  if (TM < 16) {
    // rows TM..15 of the m16 A tiles are never copied: keep them zero
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

  // copies k chunk `step % nch` of match `step / nch` into stage `buf`
  auto load_step = [&](int buf, int step) {
    // an opaque copy of the thread index: the copy offsets below are then
    // recomputed per step instead of held in registers across the loop
    int tid = threadIdx.x;
    asm volatile("" : "+r"(tid));
    const int mi = step / nch;
    const int64_t k0 = static_cast<int64_t>(step - mi * nch) * kKC;
    const int64_t g = match_g[mi];
    unsigned char* st = smem + buf * C::STAGE;
    float* as_v = reinterpret_cast<float*>(st);
    uint16_t* as_o = reinterpret_cast<uint16_t*>(st + C::AV);
    float* bs_v = reinterpret_cast<float*>(st + C::AV + C::AO);
    uint16_t* bs_o = reinterpret_cast<uint16_t*>(st + C::AV + C::AO + C::BV);
    const int64_t a_off = g * TM * tk + k0;
    const float* av_g = a_val + a_off;
    const uint16_t* ao_g = a_occ + a_off;
    const int64_t b_off = (static_cast<int64_t>(ak[g]) * tk + k0) * ldb +
                          static_cast<int64_t>(match_y[mi]) * kTN;
    const float* bv_g = b_val + b_off;
    const uint16_t* bo_g = b_occ + b_off;
    const int kmax = static_cast<int>(tk - k0 < kKC ? tk - k0 : kKC);
#pragma unroll
    for (int j = 0; j < (TM * kKC / 4 + kThreads - 1) / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / (kKC / 4);
      const int c = (i % (kKC / 4)) * 4;
      if (i < TM * kKC / 4) {
        const bool in = c < kmax;
        cp_async16(as_v + r * kAvStride + c, in ? av_g + r * tk + c : a_val,
                   in);
      }
    }
#pragma unroll
    for (int j = 0; j < (TM * kKC / 8 + kThreads - 1) / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / (kKC / 8);
      const int c = (i % (kKC / 8)) * 8;
      if (i < TM * kKC / 8) {
        const bool in = c < kmax;
        cp_async16(as_o + r * kAoStride + c, in ? ao_g + r * tk + c : a_occ,
                   in);
      }
    }
#pragma unroll
    for (int j = 0; j < kKC * kTN / 4 / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int kr = i / (kTN / 4);
      const int c = (i % (kTN / 4)) * 4;
      const bool in = kr < kmax;
      cp_async16(bs_v + kr * kBvStride + c, in ? bv_g + kr * ldb + c : b_val,
                 in);
    }
#pragma unroll
    for (int j = 0; j < kKC * kTN / 8 / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int kr = i / (kTN / 8);
      const int c = (i % (kTN / 8)) * 8;
      const bool in = kr < kmax;
      cp_async16(bs_o + kr * kBoStride + c, in ? bo_g + kr * ldb + c : b_occ,
                 in);
    }
  };

  // the warp's mma products over stage buffer `buf`
  auto compute_step = [&](int buf) {
    const unsigned char* st = smem + buf * C::STAGE;
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
  };

  // (the zero fill above lands before any copy: the scan's barriers
  // come first)
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

    // the stream of (match, k chunk) steps through the cp.async ring
    const int steps = nm * nch;
#pragma unroll
    for (int p = 0; p < C::STAGES - 1; ++p) {
      if (p < steps) load_step(p, p);
      cp_async_commit();
    }
    for (int step = 0; step < steps; ++step) {
      cp_async_wait<C::STAGES - 2>();
      __syncthreads();  // this step's copies are visible; the buffer the
                        // next copies overwrite is no longer read
      const int next = step + C::STAGES - 1;
      if (next < steps) load_step(next % C::STAGES, next);
      cp_async_commit();
      compute_step(step % C::STAGES);
    }
    cp_async_wait<0>();
    __syncthreads();  // stages and matches are free for the next pass
  }

  float* cv = c_val + slot_id * TM * kTN;
  float* co = c_cnt + slot_id * TM * kTN;
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

template <int TM>
int launch(dim3 grid, cudaStream_t stream, const float* a_val,
           const uint16_t* a_occ, const float* b_val, const uint16_t* b_occ,
           const int32_t* aptr, const int32_t* ak, const int32_t* slots,
           float* c_val, float* c_cnt, int64_t gm, int64_t block_rows,
           int64_t max_b, int64_t max_cblock, int64_t tk) {
  using C = Cfg<TM>;
  // all of the SM's unified L1/shared memory to shared, so two CTAs fit;
  // set once per device
  static bool ready[kMaxDevices] = {};
  const cudaError_t err =
      set_smem_once(strip_numeric_kernel<TM>, C::SMEM, true, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  strip_numeric_kernel<TM><<<grid, kThreads, C::SMEM, stream>>>(
      a_val, a_occ, b_val, b_occ, aptr, ak, slots, c_val, c_cnt, gm,
      block_rows, max_b, max_cblock, tk);
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
      max_b < 1 || block_rows < 1 || gm < 1 || tn != kTN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(n_slots));
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
  switch (tm) {
    case 64:
      return launch<64>(grid, st, av, ao, bv, bo, ap, kk, sl, cv, cc, gm,
                        block_rows, max_b, max_cblock, tk);
    case 32:
      return launch<32>(grid, st, av, ao, bv, bo, ap, kk, sl, cv, cc, gm,
                        block_rows, max_b, max_cblock, tk);
    case 16:
      return launch<16>(grid, st, av, ao, bv, bo, ap, kk, sl, cv, cc, gm,
                        block_rows, max_b, max_cblock, tk);
    case 8:
      return launch<8>(grid, st, av, ao, bv, bo, ap, kk, sl, cv, cc, gm,
                       block_rows, max_b, max_cblock, tk);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
