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
// comes out zero. The occupancy planes are f32 0/1, as the reference
// feeds them; the counts are exact f32 sums up to 2^24 products per
// element and are only ever read as > 0.
//
// What differs from the TPU kernel, and why. The TPU kernel walks the
// pairs with a double-buffered DMA of whole (2, tm, tk) and (2, tk, tn)
// tiles into VMEM and accumulates in its output block, over an in-order
// grid (on the TPU it could only run in interpret mode: its per-pair tile
// DMAs break Mosaic's 128-alignment rule). Here one 256-thread CTA owns
// one C tile: it loops over its pairs in schedule order, stages the A
// tile (tm x 16, rows padded to 17 words) and a 16-deep k-chunk of the B
// tile (float4 rows) of both planes through 25 KB of static shared memory
// at 64x128, keeps the tm x tn value and count accumulators in registers
// (RM rows x 4*NV columns per thread) and writes its tile once. No
// atomics, a fixed accumulation order.
//
// Arithmetic: f32 FFMA on the CUDA cores, never TF32 tensor cores (the
// reference multiplies at Precision.HIGHEST). Built without
// --use_fast_math.
//
// What bounds it on the card. On the cant-like 62,451^2 A^2 at 64x128 A
// tiles and 128x128 B tiles (5,844 pairs, 3,896 C tiles, at most 2 pairs
// per C tile) each pair is a dense 64x128x128 product done twice (values
// and counts): 24.5 GFLOP of FFMA against 67 TFLOP/s of f32 peak, about
// 0.37 ms at peak. The operands are read once per pair (A 32 KB, B 64 KB
// per plane: 1.1 GB of f32 planes in all, 0.34 ms at 3.35 TB/s) and C is
// written once (2 x 128 MB). Operand FLOP per byte is about 22, just over
// the FFMA ridge of 20 (67 TFLOP/s over 3.35 TB/s), so the kernel sits at
// the balance point; the register micro-tile with float4 shared reads keeps the
// arithmetic side from being the first limit, and the grid of one CTA per
// C tile (3,896 CTAs) fills the 132 SMs. TMA staging, bf16/uint8
// occupancy planes (a quarter of the bytes) and wgmma are later work.
//
// Limits (checked by the caller, spgemm_tpu_torch/ops/pair_kernels.py):
//   (tm, tn) in {(8,128), (16,128), (32,128), (64,128)}; any tk >= 1;
//   num_segments < 2^31. All element offsets are int64.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC pair_accumulate.cu -o libpair_accumulate.so

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;            // k depth staged per step
constexpr int kAStride = kChunk + 1;  // A rows padded: no bank conflicts

// TM x TN output tile per CTA; each thread owns RM rows and NV float4
// column groups spaced TN/NV apart (conflict-free float4 reads of B).
template <int TM, int TN, int RM, int NV>
__global__ void __launch_bounds__(kThreads)
pair_accumulate_kernel(const float* __restrict__ a_val,
                       const float* __restrict__ a_occ,
                       const float* __restrict__ b_val,
                       const float* __restrict__ b_occ,
                       const int32_t* __restrict__ pa,
                       const int32_t* __restrict__ pb,
                       const int32_t* __restrict__ pair_ptr,
                       float* __restrict__ c_val,
                       float* __restrict__ c_cnt, int64_t tk) {
  constexpr int TX = TN / (4 * NV);
  constexpr int TY = TM / RM;
  constexpr int CW = TN / NV;
  static_assert(TX * TY == kThreads, "thread layout must cover the tile");

  __shared__ float as_v[TM * kAStride];
  __shared__ float as_o[TM * kAStride];
  __shared__ __align__(16) float bs_v[kChunk * TN];
  __shared__ __align__(16) float bs_o[kChunk * TN];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int64_t seg = blockIdx.x;
  const int64_t lo = pair_ptr[seg];
  const int64_t hi = pair_ptr[seg + 1];

  float acc_v[RM][4 * NV];
  float acc_o[RM][4 * NV];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int j = 0; j < 4 * NV; ++j) {
      acc_v[i][j] = 0.f;
      acc_o[i][j] = 0.f;
    }
  }

  for (int64_t j = lo; j < hi; ++j) {
    const int64_t ga = pa[j];
    const int64_t gb = pb[j];
    const float* av_g = a_val + ga * TM * tk;
    const float* ao_g = a_occ + ga * TM * tk;
    const float* bv_g = b_val + gb * tk * TN;
    const float* bo_g = b_occ + gb * tk * TN;
    for (int64_t k0 = 0; k0 < tk; k0 += kChunk) {
      for (int i = tid; i < TM * kChunk; i += kThreads) {
        const int r = i / kChunk;
        const int kk = i % kChunk;
        const int64_t k = k0 + kk;
        const bool in = k < tk;
        as_v[r * kAStride + kk] = in ? av_g[r * tk + k] : 0.f;
        as_o[r * kAStride + kk] = in ? ao_g[r * tk + k] : 0.f;
      }
      for (int i = tid; i < kChunk * TN / 4; i += kThreads) {
        const int kk = i / (TN / 4);
        const int c4 = i % (TN / 4);
        const int64_t k = k0 + kk;
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        const bool in = k < tk;
        reinterpret_cast<float4*>(bs_v)[i] =
            in ? *reinterpret_cast<const float4*>(bv_g + k * TN + c4 * 4)
               : zero;
        reinterpret_cast<float4*>(bs_o)[i] =
            in ? *reinterpret_cast<const float4*>(bo_g + k * TN + c4 * 4)
               : zero;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kChunk; ++kk) {
        float av[RM];
        float ao[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          av[i] = as_v[(ty * RM + i) * kAStride + kk];
          ao[i] = as_o[(ty * RM + i) * kAStride + kk];
        }
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const float4 bv =
              *reinterpret_cast<const float4*>(&bs_v[kk * TN + v * CW + tx * 4]);
          const float4 bo =
              *reinterpret_cast<const float4*>(&bs_o[kk * TN + v * CW + tx * 4]);
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            acc_v[i][v * 4 + 0] = fmaf(av[i], bv.x, acc_v[i][v * 4 + 0]);
            acc_v[i][v * 4 + 1] = fmaf(av[i], bv.y, acc_v[i][v * 4 + 1]);
            acc_v[i][v * 4 + 2] = fmaf(av[i], bv.z, acc_v[i][v * 4 + 2]);
            acc_v[i][v * 4 + 3] = fmaf(av[i], bv.w, acc_v[i][v * 4 + 3]);
            acc_o[i][v * 4 + 0] = fmaf(ao[i], bo.x, acc_o[i][v * 4 + 0]);
            acc_o[i][v * 4 + 1] = fmaf(ao[i], bo.y, acc_o[i][v * 4 + 1]);
            acc_o[i][v * 4 + 2] = fmaf(ao[i], bo.z, acc_o[i][v * 4 + 2]);
            acc_o[i][v * 4 + 3] = fmaf(ao[i], bo.w, acc_o[i][v * 4 + 3]);
          }
        }
      }
      __syncthreads();
    }
  }

  float* cv = c_val + seg * TM * TN;
  float* co = c_cnt + seg * TM * TN;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int64_t row = ty * RM + i;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int64_t off = row * TN + v * CW + tx * 4;
      *reinterpret_cast<float4*>(cv + off) =
          make_float4(acc_v[i][v * 4 + 0], acc_v[i][v * 4 + 1],
                      acc_v[i][v * 4 + 2], acc_v[i][v * 4 + 3]);
      *reinterpret_cast<float4*>(co + off) =
          make_float4(acc_o[i][v * 4 + 0], acc_o[i][v * 4 + 1],
                      acc_o[i][v * 4 + 2], acc_o[i][v * 4 + 3]);
    }
  }
}

template <int TM, int TN, int RM, int NV>
void launch(dim3 grid, cudaStream_t stream, const float* a_val,
            const float* a_occ, const float* b_val, const float* b_occ,
            const int32_t* pa, const int32_t* pb, const int32_t* pair_ptr,
            float* c_val, float* c_cnt, int64_t tk) {
  pair_accumulate_kernel<TM, TN, RM, NV><<<grid, kThreads, 0, stream>>>(
      a_val, a_occ, b_val, b_occ, pa, pb, pair_ptr, c_val, c_cnt, tk);
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted (and 0 with
// nothing launched when num_segments is 0). Launches on `stream`, does
// not synchronise, allocates nothing.
int pair_accumulate_f32(const void* a_val, const void* a_occ,
                        const void* b_val, const void* b_occ, const void* pa,
                        const void* pb, const void* pair_ptr, void* c_val,
                        void* c_cnt, int64_t num_segments, int64_t tm,
                        int64_t tk, int64_t tn, void* stream) {
  if (num_segments < 0 || num_segments > INT32_MAX || tk < 1 || tn != 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_segments == 0) return 0;
  const dim3 grid(static_cast<unsigned>(num_segments));
  auto st = static_cast<cudaStream_t>(stream);
  const auto* av = static_cast<const float*>(a_val);
  const auto* ao = static_cast<const float*>(a_occ);
  const auto* bv = static_cast<const float*>(b_val);
  const auto* bo = static_cast<const float*>(b_occ);
  const auto* p_a = static_cast<const int32_t*>(pa);
  const auto* p_b = static_cast<const int32_t*>(pb);
  const auto* pp = static_cast<const int32_t*>(pair_ptr);
  auto* cv = static_cast<float*>(c_val);
  auto* cc = static_cast<float*>(c_cnt);
  switch (tm) {
    case 64:
      launch<64, 128, 4, 2>(grid, st, av, ao, bv, bo, p_a, p_b, pp, cv, cc,
                            tk);
      break;
    case 32:
      launch<32, 128, 2, 2>(grid, st, av, ao, bv, bo, p_a, p_b, pp, cv, cc,
                            tk);
      break;
    case 16:
      launch<16, 128, 1, 2>(grid, st, av, ao, bv, bo, p_a, p_b, pp, cv, cc,
                            tk);
      break;
    case 8:
      launch<8, 128, 1, 1>(grid, st, av, ao, bv, bo, p_a, p_b, pp, cv, cc,
                           tk);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
