// Device building blocks shared by the kernels of the port (spmm_strip.cu,
// ozaki_strip.cu, dyngather.cu, and strip_numeric.cu / pair_accumulate.cu
// through tile_pipeline.cuh), for sm_90a.
//
//   cp.async copies into shared memory, with zero fill for the ragged edge
//   (the narrow SpMM form's);
//   the TF32 splits of an f32 value (hi/lo, and the exact hi/mid/lo) and
//   the TF32-exactness test;
//   a host helper that sets a kernel's shared-memory attributes once per
//   device instead of before every launch, and one that launches a tile's
//   row chunks by height (for_each_row_part).
//
// The build key of every library that includes this file covers its bytes
// (spgemm_tpu_torch/utils/native.py:build_shared_library), so an edit here
// rebuilds each of them.

#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace sm90 {

// 16-byte copy global -> shared; `valid` false zero-fills and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

// 4-byte copy (rows whose start is not 16-byte aligned)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the 13 low mantissa bits TF32 drops: zero for a TF32 value (integers
// below 2^11 are), whose split has lo = 0
constexpr uint32_t kTf32Low = 0x1fffu;

// x = hi + lo + (a rest below f32 accuracy of x), hi and lo TF32 values
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);  // exact in f32
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

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

constexpr int kMaxDevices = 64;

// Sets `kernel`'s dynamic shared-memory limit to `smem` bytes (and, with
// `max_shared`, the carveout to all of the SM's unified L1/shared memory)
// the first time it launches on the current device. `ready` is the
// caller's per-instantiation flag array. Returns a cudaError_t.
template <typename Kernel>
inline cudaError_t set_smem_once(Kernel kernel, int smem, bool max_shared,
                                 bool (&ready)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && ready[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess && max_shared) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err == cudaSuccess && dev < kMaxDevices) ready[dev] = true;
  return err;
}

template <int H, typename F>
inline int row_part(int64_t tm, int64_t& row0, F& launch) {
  const int64_t n = (tm - row0) / H;
  if (n == 0) return 0;
  const int err = launch(std::integral_constant<int, H>{}, row0,
                         static_cast<unsigned>(n));
  row0 += n * H;
  return err;
}

// Calls launch(H, row_base, n) for the row chunks of a tm-row tile (tm a
// multiple of the last height): for each H of Heights in turn (largest
// first), the n chunks of H rows that fit from row row_base on, one call
// per height that has any (H an std::integral_constant). So with 64, 32,
// 16, 8: 128 = 2 x 64, 40 = 32 + 8, 24 = 16 + 8. Returns the first
// nonzero result.
template <int... Heights, typename F>
inline int for_each_row_part(int64_t tm, F&& launch) {
  int64_t row0 = 0;
  int err = 0;
  ((err = err != 0 ? err : row_part<Heights>(tm, row0, launch)), ...);
  return err;
}

}  // namespace sm90
