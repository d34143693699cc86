// Strip SpMM kernel for Hopper (sm_90a), C ABI for ctypes: Y = A . X.
//
// Replaces both Pallas SpMM kernels of the JAX package:
//   spgemm_tpu/ops/pallas_kernels.py:_spmm_kernel_factory        (:679)
//   spgemm_tpu/ops/pallas_kernels.py:_spmm_window_kernel_factory (:805)
// reached through spmm_strip_pallas (:757) and spmm_window_pallas (:894).
// Both compute the same Y from the same (aptr, ak, arow) plan; the window
// form only reads X through a per-block window [kmin[blk], kmin[blk]+kwin)
// and rebases ak by kmin[blk]. So one kernel serves both: `kmin` null is
// the resident form, `kmin` set the window form, where tile g of tile-row
// i (block blk = i / block_rows) reads X slab kmin[blk] + (ak[g] - kmin[blk]).
//
// What it computes. For every tile-row i < gm and every A tile g in
// [aptr[i], aptr[i+1]):
//   y[i] += a[g] (tm x tk) . xb[ak[g]] (tk x k_pad)
// with y laid out (n_blocks*block_rows, tm, k_pad) as the TPU kernels
// emit it; the padding rows i >= gm of the last block come out zero.
//
// What differs from the TPU kernels, and why. The TPU kernels hold X (or
// a block's X window) in VMEM, stream a block's A tiles by one DMA and
// stage a whole block's Y in VMEM, over an in-order grid. An H100 CTA has
// at most 227 KB of shared memory and CTAs run in no order. Here one
// 256-thread CTA owns one tile-row and one 128-wide chunk of k_pad: it
// walks the row's A tiles in order, stages A (tm x 16) and X (16 x 128)
// k-chunks through shared memory (conflict-free float4 reads of X, A rows
// padded to 17 words), keeps its tm x 128 accumulator in registers and
// writes its Y rows once. No atomics, a fixed accumulation order, and X
// is read from device memory through the 50 MB L2 in both forms ("X
// resident" on this card means "X held in L2", which is what
// ops/spmm.py:_spmm_mode budgets for).
//
// Arithmetic: f32 FFMA on the CUDA cores, never TF32 tensor cores (the
// JAX reference multiplies at Precision.HIGHEST). Built without
// --use_fast_math.
//
// What bounds it on the card. At the suite's banded65536 with 16x128
// tiles and k = 128 (8,184 A tiles, gm 4,096, gn 512) the dense-tile work
// is 2*8,184*16*128*128 = 4.3 GFLOP (the useful 2*nnz*k is 1.09 GFLOP),
// against 67 TFLOP/s of f32 FFMA peak: about 64 us at peak. The bytes are
// A 67 MB, X 32 MB (its slabs re-read by neighbouring rows hit L2 on a
// band) and Y 32 MB, about 40 us at 3.35 TB/s. So the FFMA rate and the
// shared-memory operand reads that feed it bound the kernel, not bytes;
// at tm 16 each thread does 8 FMAs per 3 shared loads, so the shared
// loads are the first limit. A register micro-tile per thread (RM rows x
// 4 columns, float4 X reads) is what this design does about it; wgmma
// and TMA staging are later work.
//
// Limits (checked by the caller, spgemm_tpu_torch/ops/spmm_kernels.py):
//   tm in {8, 16, 32, 64}; any tk >= 1; k_pad a multiple of 128;
//   n_blocks*block_rows < 2^31 (grid size); k_pad/128 < 65536. All
//   element offsets are int64.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC spmm_strip.cu -o libspmm_strip.so

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;            // k depth staged per step
constexpr int kAStride = kChunk + 1;  // A rows padded: no bank conflicts
constexpr int kCols = 128;            // k_pad columns per CTA
constexpr int kTX = kCols / 4;        // threads across the columns (float4)
constexpr int kTY = kThreads / kTX;   // threads down the rows

template <int TM>
__global__ void __launch_bounds__(kThreads)
spmm_strip_kernel(const float* __restrict__ a,
                  const float* __restrict__ xb,
                  const int32_t* __restrict__ aptr,
                  const int32_t* __restrict__ ak,
                  const int32_t* __restrict__ kmin,
                  float* __restrict__ y,
                  int64_t gm, int64_t block_rows, int64_t tk,
                  int64_t k_pad) {
  constexpr int RM = TM / kTY;
  static_assert(RM * kTY == TM, "tm must be a multiple of 8");

  __shared__ float as[TM * kAStride];
  __shared__ __align__(16) float xs[kChunk * kCols];

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int64_t row = blockIdx.x;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * kCols;

  float acc[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  if (row < gm) {
    const int64_t g0 = aptr[row];
    const int64_t g1 = aptr[row + 1];
    // window form: the block's X window starts at slab klo
    const int64_t klo = kmin != nullptr ? kmin[row / block_rows] : 0;
    const float* xwin = xb + klo * tk * k_pad;
    for (int64_t g = g0; g < g1; ++g) {
      const float* a_g = a + g * TM * tk;
      const float* x_g = xwin + (ak[g] - klo) * tk * k_pad + c0;
      for (int64_t k0 = 0; k0 < tk; k0 += kChunk) {
        for (int i = tid; i < TM * kChunk; i += kThreads) {
          const int r = i / kChunk;
          const int kk = i % kChunk;
          const int64_t k = k0 + kk;
          as[r * kAStride + kk] = k < tk ? a_g[r * tk + k] : 0.f;
        }
        for (int i = tid; i < kChunk * kTX; i += kThreads) {
          const int kk = i / kTX;
          const int c4 = i % kTX;
          const int64_t k = k0 + kk;
          reinterpret_cast<float4*>(xs)[i] =
              k < tk ? *reinterpret_cast<const float4*>(x_g + k * k_pad +
                                                        c4 * 4)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kChunk; ++kk) {
          const float4 xv = reinterpret_cast<const float4*>(xs)[kk * kTX + tx];
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const float av = as[(ty * RM + i) * kAStride + kk];
            acc[i][0] = fmaf(av, xv.x, acc[i][0]);
            acc[i][1] = fmaf(av, xv.y, acc[i][1]);
            acc[i][2] = fmaf(av, xv.z, acc[i][2]);
            acc[i][3] = fmaf(av, xv.w, acc[i][3]);
          }
        }
        __syncthreads();
      }
    }
  }

  float* y_row = y + row * TM * k_pad + c0 + tx * 4;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    *reinterpret_cast<float4*>(y_row + (ty * RM + i) * k_pad) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

template <int TM>
void launch(dim3 grid, cudaStream_t stream, const float* a, const float* xb,
            const int32_t* aptr, const int32_t* ak, const int32_t* kmin,
            float* y, int64_t gm, int64_t block_rows, int64_t tk,
            int64_t k_pad) {
  spmm_strip_kernel<TM><<<grid, kThreads, 0, stream>>>(
      a, xb, aptr, ak, kmin, y, gm, block_rows, tk, k_pad);
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted. `kmin` may be
// null (resident form). Launches on `stream`, does not synchronise,
// allocates nothing.
int spmm_strip_f32(const void* a, const void* xb, const void* aptr,
                   const void* ak, const void* kmin, void* y, int64_t gm,
                   int64_t block_rows, int64_t n_rows, int64_t tm,
                   int64_t tk, int64_t k_pad, void* stream) {
  if (n_rows <= 0 || n_rows > INT32_MAX || n_rows < gm || gm < 1 ||
      block_rows < 1 || tk < 1 || k_pad < kCols || k_pad % kCols != 0 ||
      k_pad / kCols > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(n_rows),
                  static_cast<unsigned>(k_pad / kCols));
  auto st = static_cast<cudaStream_t>(stream);
  const auto* av = static_cast<const float*>(a);
  const auto* xv = static_cast<const float*>(xb);
  const auto* ap = static_cast<const int32_t*>(aptr);
  const auto* kk = static_cast<const int32_t*>(ak);
  const auto* km = static_cast<const int32_t*>(kmin);
  auto* yv = static_cast<float*>(y);
  switch (tm) {
    case 64:
      launch<64>(grid, st, av, xv, ap, kk, km, yv, gm, block_rows, tk, k_pad);
      break;
    case 32:
      launch<32>(grid, st, av, xv, ap, kk, km, yv, gm, block_rows, tk, k_pad);
      break;
    case 16:
      launch<16>(grid, st, av, xv, ap, kk, km, yv, gm, block_rows, tk, k_pad);
      break;
    case 8:
      launch<8>(grid, st, av, xv, ap, kk, km, yv, gm, block_rows, tk, k_pad);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
