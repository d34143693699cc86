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
// Narrow form (k <= 32, SpMV first). The TPU pads k to 128 lanes; the
// 128-column form above would then spend 127/128 of its work on padding
// at k = 1. For k <= 32 the caller packs X and Y at a width W of 8, 16 or
// 32 (k rounded up to a power of two) and spmm_narrow_kernel runs: one
// CTA per tile row, A and X streamed through a cp.async ring in shared
// memory, every thread on a k slice of 8 output columns, and the k slices
// of each output summed once in shared memory (see its comment).
// There the bytes bound it: at SpMV on banded65536 the 67 MB of dense
// 16x128 A tiles, about 20 us at 3.35 TB/s, where cuSPARSE's SpMV reads
// about 35 MB of CSR. The tile format's padding is the price of the
// format, not of the kernel.
//
// Limits (checked by the caller, spgemm_tpu_torch/ops/spmm_kernels.py):
//   tm in {8, 16, 32, 64}; any tk >= 1; k_pad a multiple of 128, or 8,
//   16 or 32 (narrow form); n_blocks*block_rows < 2^31 (grid size);
//   k_pad/128 < 65536. All element offsets are int64.
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

// ---- narrow form: X and Y W = 8, 16 or 32 columns wide (k <= 32) ------
//
// One 256-thread CTA per tile row. The row's A tiles and their X slabs
// stream through a 3-stage cp.async ring in shared memory, in k chunks of
// NarrowCfg::KCH, one barrier per chunk, so two chunks' loads are in
// flight while one is multiplied. Thread t owns A row r = t % tm, columns
// cc*8 .. cc*8+7 of Y and the k slice k = i*KS + ks of each chunk
// (KS = 256 / (tm * W/8) slices), and keeps 8 partial sums in registers
// across all the row's tiles. The lanes of a warp differ in r first, so
// they read one X row segment together (a broadcast) and A words in
// distinct banks. The KS slices of each output are summed once, at the
// end, through shared memory. So the A bytes stream once with many loads
// in flight, and the multiply-adds (8 per 3 shared loads) stay far below
// them. At most 64 registers a thread (__launch_bounds__(256, 4)) keep
// four CTAs, 1,024 threads, on each SM.

constexpr int kNarrowThreads = 256;
constexpr int kNarrowStages = 3;

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? bytes : 0;  // 0: zero-fill, nothing read
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  }
}

template <int TM, int W>
struct NarrowCfg {
  static constexpr int CC = W / 8;                        // column groups
  static constexpr int KS = kNarrowThreads / (TM * CC);   // k slices
  static constexpr int KCH = TM * W >= 1024 ? 64 : 128;   // k per stage
  static constexpr int AS = KCH + 4;  // A row stride: 16-byte rows
  static constexpr int STAGE = (TM * AS + KCH * W) * 4;   // bytes
  static constexpr int SMEM = kNarrowStages * STAGE;
  static_assert(CC * 8 == W && KS * TM * CC == kNarrowThreads && KS <= 32 &&
                    (KS & (KS - 1)) == 0 && KCH % KS == 0,
                "the thread layout must cover the tile");
  static_assert((TM * AS * 4) % 16 == 0, "X must stay 16-byte aligned");
  static_assert(KS * TM * W <= SMEM / 4, "the slice sums must fit");
};

template <int TM, int W>
__global__ void __launch_bounds__(kNarrowThreads, 4)
spmm_narrow_kernel(const float* __restrict__ a,
                   const float* __restrict__ xb,
                   const int32_t* __restrict__ aptr,
                   const int32_t* __restrict__ ak,
                   const int32_t* __restrict__ kmin,
                   float* __restrict__ y,
                   int64_t gm, int64_t block_rows, int64_t tk) {
  using C = NarrowCfg<TM, W>;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int r = tid % TM;
  const int cc = (tid / TM) % C::CC;
  const int ks = tid / (TM * C::CC);
  const int64_t row = blockIdx.x;
  float acc[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) acc[q] = 0.f;

  if (row < gm) {
    const int64_t g0 = aptr[row];
    const int64_t nkc = (tk + C::KCH - 1) / C::KCH;
    const int64_t steps = (aptr[row + 1] - g0) * nkc;
    const int64_t klo = kmin != nullptr ? kmin[row / block_rows] : 0;
    const float* xwin = xb + klo * tk * W;
    // chunk c: k0 = (c % nkc) * KCH of tile g0 + c / nkc, into stage buf
    auto load_step = [&](int buf, int64_t c) {
      const int64_t g = g0 + c / nkc;
      const int64_t k0 = (c % nkc) * C::KCH;
      const float* a_g = a + g * TM * tk + k0;
      const float* x_g = xwin + ((ak[g] - klo) * tk + k0) * W;
      float* as = reinterpret_cast<float*>(smem + buf * C::STAGE);
      float* xs = as + TM * C::AS;
      if ((tk & 3) == 0) {  // A rows 16-byte aligned: 16-byte copies
        for (int i = tid; i < TM * C::KCH / 4; i += kNarrowThreads) {
          const int rr = i / (C::KCH / 4);
          const int kk = (i % (C::KCH / 4)) * 4;
          const bool in = k0 + kk < tk;
          cp_async(as + rr * C::AS + kk, in ? a_g + rr * tk + kk : a, in, 16);
        }
      } else {
#pragma unroll
        for (int j = 0; j < TM * C::KCH / kNarrowThreads; ++j) {
          const int i = tid + j * kNarrowThreads;
          const int rr = i / C::KCH;
          const int kk = i % C::KCH;
          const bool in = k0 + kk < tk;
          cp_async(as + rr * C::AS + kk, in ? a_g + rr * tk + kk : a, in, 4);
        }
      }
      for (int i = tid; i < C::KCH * W / 4; i += kNarrowThreads) {
        const bool in = k0 + (i * 4) / W < tk;
        cp_async(xs + i * 4, in ? x_g + i * 4 : xb, in, 16);
      }
    };
#pragma unroll
    for (int p = 0; p < kNarrowStages - 1; ++p) {
      if (p < steps) load_step(p, p);
      cp_async_commit();
    }
    for (int64_t c = 0; c < steps; ++c) {
      cp_async_wait<kNarrowStages - 2>();
      __syncthreads();  // chunk c is visible; chunk c-1's buffer is free
      if (c + kNarrowStages - 1 < steps) {
        load_step(static_cast<int>((c + kNarrowStages - 1) % kNarrowStages),
                  c + kNarrowStages - 1);
      }
      cp_async_commit();
      const float* as = reinterpret_cast<const float*>(
          smem + static_cast<int>(c % kNarrowStages) * C::STAGE);
      const float* xs = as + TM * C::AS;
#pragma unroll
      for (int i = 0; i < C::KCH / C::KS; ++i) {
        const int k = i * C::KS + ks;
        const float av = as[r * C::AS + k];
        const float4* xr = reinterpret_cast<const float4*>(xs + k * W + cc * 8);
        const float4 x0 = xr[0];
        const float4 x1 = xr[1];
        acc[0] = fmaf(av, x0.x, acc[0]);
        acc[1] = fmaf(av, x0.y, acc[1]);
        acc[2] = fmaf(av, x0.z, acc[2]);
        acc[3] = fmaf(av, x0.w, acc[3]);
        acc[4] = fmaf(av, x1.x, acc[4]);
        acc[5] = fmaf(av, x1.y, acc[5]);
        acc[6] = fmaf(av, x1.z, acc[6]);
        acc[7] = fmaf(av, x1.w, acc[7]);
      }
    }
    cp_async_wait<0>();
  }
  // sum the KS slices of each output through shared memory (the stages
  // are free once every thread is past the last chunk), then write the
  // row's tm x W block of Y, coalesced
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // (KS, TM, W)
  float4* mine = reinterpret_cast<float4*>(red + (ks * TM + r) * W + cc * 8);
  mine[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  mine[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  __syncthreads();
  float* y_row = y + row * TM * W;
  for (int o = tid; o < TM * W; o += kNarrowThreads) {
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < C::KS; ++k) v += red[k * TM * W + o];
    y_row[o] = v;
  }
}

template <int TM, int W>
int launch_narrow_w(cudaStream_t stream, const float* a, const float* xb,
                    const int32_t* aptr, const int32_t* ak,
                    const int32_t* kmin, float* y, int64_t gm,
                    int64_t block_rows, int64_t tk, int64_t n_rows) {
  constexpr int smem = NarrowCfg<TM, W>::SMEM;
  const cudaError_t err = cudaFuncSetAttribute(
      spmm_narrow_kernel<TM, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  spmm_narrow_kernel<TM, W>
      <<<static_cast<unsigned>(n_rows), kNarrowThreads, smem, stream>>>(
          a, xb, aptr, ak, kmin, y, gm, block_rows, tk);
  return static_cast<int>(cudaGetLastError());
}

template <int TM>
int launch_narrow(int64_t width, cudaStream_t stream, const float* a,
                  const float* xb, const int32_t* aptr, const int32_t* ak,
                  const int32_t* kmin, float* y, int64_t gm,
                  int64_t block_rows, int64_t tk, int64_t n_rows) {
  switch (width) {
    case 8:
      return launch_narrow_w<TM, 8>(stream, a, xb, aptr, ak, kmin, y, gm,
                                    block_rows, tk, n_rows);
    case 16:
      return launch_narrow_w<TM, 16>(stream, a, xb, aptr, ak, kmin, y, gm,
                                     block_rows, tk, n_rows);
    case 32:
      return launch_narrow_w<TM, 32>(stream, a, xb, aptr, ak, kmin, y, gm,
                                     block_rows, tk, n_rows);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted. `kmin` may be
// null (resident form). `k_pad` is the packed width of X and Y: 8, 16 or
// 32 runs the narrow form, a multiple of 128 the 128-column form.
// Launches on `stream`, does not synchronise, allocates nothing.
int spmm_strip_f32(const void* a, const void* xb, const void* aptr,
                   const void* ak, const void* kmin, void* y, int64_t gm,
                   int64_t block_rows, int64_t n_rows, int64_t tm,
                   int64_t tk, int64_t k_pad, void* stream) {
  const bool narrow = k_pad == 8 || k_pad == 16 || k_pad == 32;
  if (n_rows <= 0 || n_rows > INT32_MAX || n_rows < gm || gm < 1 ||
      block_rows < 1 || tk < 1 ||
      (!narrow && (k_pad < kCols || k_pad % kCols != 0 ||
                   k_pad / kCols > 65535))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const auto* av = static_cast<const float*>(a);
  const auto* xv = static_cast<const float*>(xb);
  const auto* ap = static_cast<const int32_t*>(aptr);
  const auto* kk = static_cast<const int32_t*>(ak);
  const auto* km = static_cast<const int32_t*>(kmin);
  auto* yv = static_cast<float*>(y);
  if (narrow) {
    switch (tm) {
      case 64:
        return launch_narrow<64>(k_pad, st, av, xv, ap, kk, km, yv, gm,
                                 block_rows, tk, n_rows);
      case 32:
        return launch_narrow<32>(k_pad, st, av, xv, ap, kk, km, yv, gm,
                                 block_rows, tk, n_rows);
      case 16:
        return launch_narrow<16>(k_pad, st, av, xv, ap, kk, km, yv, gm,
                                 block_rows, tk, n_rows);
      case 8:
        return launch_narrow<8>(k_pad, st, av, xv, ap, kk, km, yv, gm,
                                block_rows, tk, n_rows);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const dim3 grid(static_cast<unsigned>(n_rows),
                  static_cast<unsigned>(k_pad / kCols));
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
