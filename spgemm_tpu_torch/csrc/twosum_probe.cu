// Rounding probe for Hopper (sm_90a), C ABI for ctypes.
//
// The double-double scan kernel (esc_scan.cu) and the Ozaki strip kernel
// (ozaki_strip.cu) are exact only while every multiply and add rounds on
// its own. They write that arithmetic with __fadd_rn/__fmul_rn, which
// nvcc never contracts, and are built with --fmad=false (no contraction
// of a multiply into the following add), no fast-math and no FTZ. This
// kernel is built with the same flags and writes the same kind of
// arithmetic with plain operators, so it shows what those flags allow:
//
// - contract_err: for b = 1 + 2^-12, p = b*b rounds 1 + 2^-11 + 2^-24 to
//   1 + 2^-11 (a tie, to even), and b*b - p is 0 when the multiply rounds
//   before the subtract, 2^-24 when nvcc fuses them into one FMA. It is
//   0 under --fmad=false and 2^-24 under --fmad=true, so this term tells
//   the flags apart (spgemm_tpu_torch/tools/verify_cuda.py builds both).
// - twosum_err: TwoSum's error term (x - (s - bb)) + (y - bb) for x = 1,
//   y = 2^-30 is 2^-30 unless the adds are reassociated (nvcc does not
//   reassociate, with or without fast-math); it is the JAX package's
//   Mosaic probe (tools/verify_tpu.py:180-193) on the card.
//
// p comes from __fmul_rn so that it is not the same expression as the
// b*b of the subtract (which the compiler would compute once).

#include <cstdint>
#include <cuda_runtime.h>

__global__ void rounding_probe_kernel(const float* x, float* twosum_err,
                                      float* contract_err, int64_t n) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
  float a = x[i];
  float y = a * 9.313225746154785e-10f;  // 2^-30
  float s = a + y;
  float bb = s - a;
  twosum_err[i] = (a - (s - bb)) + (y - bb);
  float b = a + 2.44140625e-4f;          // 1 + 2^-12
  float p = __fmul_rn(b, b);
  contract_err[i] = b * b - p;
}

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted. Launches on
// `stream`, does not synchronise, allocates nothing.
int twosum_probe(const void* x, void* twosum_err, void* contract_err,
                 int64_t n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int blocks = (int)((n + threads - 1) / threads);
  rounding_probe_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)twosum_err, (float*)contract_err, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
