// ESC scan kernels for Hopper (sm_90a), C ABI for ctypes.
//
// Replaces the three Pallas scan kernels of the JAX package, which share
// one streaming pipeline (_scan_stream_call, spgemm_tpu/ops/esc.py:560) and
// one plan (ScanPlan, :400):
//   spgemm_tpu/ops/esc.py:esc_scan_pallas     (:662)  -> esc_scan_f32
//   spgemm_tpu/ops/esc.py:esc_scan_mul_pallas (:713)  -> esc_scan_mul_f32
//   spgemm_tpu/ops/esc.py:esc_scan_dd_pallas  (:760)  -> esc_scan_dd_f32
// One templated kernel serves all three.
//
// What it computes. The plan lays C's products out as (R, 128) rows,
// sorted by destination; meta (int16) packs per lane bits 0-6 idx (the
// lane whose in-row run this slot gathers), bit 7 present and bits 8-14
// dist (lanes to the end of this lane's run). For each output row
// o < R/G, over its input rows r = o*G .. o*G+G-1:
//   1. `passes` steps, d = 1, 2, 4, ...: q[i] += (dist[i] >= d) ? q[i+d] : 0
//      (each step reads the values of the step before: a segmented
//      suffix sum, so lane i ends with the sum of its run from i on);
//   2. y[j] = q[idx[j]] * present[j];
//   3. out[o] = y_0 + y_1 + ... + y_{G-1}, left to right.
// mul first forms q = av*bv (rounded once). dd carries (s, e) through a
// 2Sum in every step (esc.py:788-798), gathers both, and reduces the G
// rows with the same compensated sum (esc.py:808-817).
//
// The order of every addition is the reference's, and the build uses
// --fmad=false (no contraction of a multiply into the following add) and
// no fast-math or FTZ, so the kernel is bit-equal to its plain PyTorch
// version (spgemm_tpu_torch/ops/scan_kernels.py) and the 2Sum stays
// IEEE-exact. The arithmetic is written with __fadd_rn/__fmul_rn, which
// nvcc never contracts, as a second guard.
//
// What differs from the TPU kernel, and why. The TPU kernel streams
// 2048-row blocks through a hand double-buffered DMA pipeline that relies
// on grid steps running in order, and moves lanes with pltpu.roll and a
// take_along_axis gather. None of that carries over. Here one 128-thread
// CTA owns one output row at a time (one thread per lane), walking
// output rows in a grid-stride loop; each step exchanges lane values
// through shared memory (two ping-pong buffers, one barrier per step), and
// the gather reads the same buffers. The G rows accumulate in a
// register, and each output row is one coalesced 512-byte store.
//
// What bounds it on the card. Device memory traffic: 6 B per product in
// (f32 value + int16 meta; 10 B for mul, 10 B for dd) and 4/G B per lane
// out (8/G for dd), against a few shared-memory operations and adds per
// pass. At the rmat65536 A^2 plan that is 2.96 GB in and 1.98 GB out per
// launch. The design's answer is occupancy: 128-thread CTAs with few
// registers (up to 16 resident per SM) keep many rows' loads in flight
// while other CTAs sit at their barriers. Warp shuffles for d < 32, wider
// loads and TMA bulk copies are later work.
//
// Limits (checked here and by the caller): group_rows in {1, 2, 4, 8},
// R a multiple of group_rows, passes in [0, 7]. Element offsets are
// int64 (R*128 is 494 M at rmat65536 and passes 2^31 on larger graphs).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC esc_scan.cu -o libesc_scan.so

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;          // SCAN_WIN: one thread per lane
constexpr int64_t kMaxGrid = 1 << 16;

enum Mode { kPremul = 0, kMul = 1, kDD = 2 };

// One 2Sum step of the double-double accumulation:
//   t = s + x; bp = t - s; err = (s - (t - bp)) + (x - bp);
//   s = t; e = (e + ex) + err
__device__ __forceinline__ void two_sum_acc(float& s, float& e, float x,
                                            float ex) {
  const float t = __fadd_rn(s, x);
  const float bp = __fsub_rn(t, s);
  const float err =
      __fadd_rn(__fsub_rn(s, __fsub_rn(t, bp)), __fsub_rn(x, bp));
  s = t;
  e = __fadd_rn(__fadd_rn(e, ex), err);
}

template <int MODE>
__global__ void __launch_bounds__(kLanes, 16)
esc_scan_kernel(const float* __restrict__ x0, const float* __restrict__ x1,
                const int16_t* __restrict__ meta, float* __restrict__ out_s,
                float* __restrict__ out_e, int64_t n_out, int passes,
                int group_rows) {
  __shared__ float sh_s[2][kLanes];
  __shared__ float sh_e[2][MODE == kDD ? kLanes : 1];
  const int lane = threadIdx.x;
  // ping-pong selector, carried across rows: every phase writes
  // buffer phase&1, waits at one barrier, then reads it, so a thread that
  // runs ahead writes the other buffer, and reaches this one again only
  // after every thread has passed the barrier that follows its reads
  int phase = 0;

  for (int64_t o = blockIdx.x; o < n_out; o += gridDim.x) {
    float acc_s = 0.f;
    float acc_e = 0.f;
    for (int j = 0; j < group_rows; ++j) {
      const int64_t off =
          (o * group_rows + j) * static_cast<int64_t>(kLanes) + lane;
      // int16 -> int32 with sign extension (esc.py:394-396)
      const int m = static_cast<int>(meta[off]);
      const int idx = m & 127;
      const float present = static_cast<float>((m >> 7) & 1);
      const int dist = m >> 8;
      float s;
      float e = 0.f;
      if constexpr (MODE == kMul) {
        s = __fmul_rn(x0[off], x1[off]);
      } else {
        s = x0[off];
      }
      if constexpr (MODE == kDD) e = x1[off];

      for (int k = 0; k < passes; ++k, ++phase) {
        const int d = 1 << k;
        const int p = phase & 1;
        sh_s[p][lane] = s;
        if constexpr (MODE == kDD) sh_e[p][lane] = e;
        __syncthreads();
        const bool ok = dist >= d;
        const int src = (lane + d) & (kLanes - 1);
        const float sr = ok ? sh_s[p][src] : 0.f;
        if constexpr (MODE == kDD) {
          const float er = ok ? sh_e[p][src] : 0.f;
          two_sum_acc(s, e, sr, er);
        } else {
          s = __fadd_rn(s, sr);
        }
      }

      const int p = phase & 1;
      ++phase;
      sh_s[p][lane] = s;
      if constexpr (MODE == kDD) sh_e[p][lane] = e;
      __syncthreads();
      const float ys = __fmul_rn(sh_s[p][idx], present);
      if constexpr (MODE == kDD) {
        const float ye = __fmul_rn(sh_e[p][idx], present);
        if (j == 0) {
          acc_s = ys;
          acc_e = ye;
        } else {
          two_sum_acc(acc_s, acc_e, ys, ye);
        }
      } else {
        acc_s = j == 0 ? ys : __fadd_rn(acc_s, ys);
      }
    }
    const int64_t oo = o * static_cast<int64_t>(kLanes) + lane;
    out_s[oo] = acc_s;
    if constexpr (MODE == kDD) out_e[oo] = acc_e;
  }
}

int launch(int mode, const void* x0, const void* x1, const void* meta,
           void* out_s, void* out_e, int64_t n_rows, int64_t passes,
           int64_t group_rows, void* stream) {
  if (n_rows < 0 || passes < 0 || passes > 7 ||
      !(group_rows == 1 || group_rows == 2 || group_rows == 4 ||
        group_rows == 8) ||
      n_rows % group_rows != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_out = n_rows / group_rows;
  if (n_out == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(static_cast<unsigned>(n_out < kMaxGrid ? n_out : kMaxGrid));
  auto st = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const float*>(x0);
  const auto* b = static_cast<const float*>(x1);
  const auto* mt = static_cast<const int16_t*>(meta);
  auto* os = static_cast<float*>(out_s);
  auto* oe = static_cast<float*>(out_e);
  const int ps = static_cast<int>(passes);
  const int g = static_cast<int>(group_rows);
  switch (mode) {
    case kPremul:
      esc_scan_kernel<kPremul><<<grid, kLanes, 0, st>>>(a, b, mt, os, oe,
                                                         n_out, ps, g);
      break;
    case kMul:
      esc_scan_kernel<kMul><<<grid, kLanes, 0, st>>>(a, b, mt, os, oe, n_out,
                                                      ps, g);
      break;
    default:
      esc_scan_kernel<kDD><<<grid, kLanes, 0, st>>>(a, b, mt, os, oe, n_out,
                                                     ps, g);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns a cudaError_t: 0 when the launch was accepted (or there was
// nothing to launch). Launches on `stream`, does not synchronise,
// allocates nothing. Inputs are (n_rows, 128); outputs (n_rows/G, 128).

int esc_scan_f32(const void* qv, const void* meta, void* out, int64_t n_rows,
                 int64_t passes, int64_t group_rows, void* stream) {
  return launch(kPremul, qv, nullptr, meta, out, nullptr, n_rows, passes,
                group_rows, stream);
}

int esc_scan_mul_f32(const void* av, const void* bv, const void* meta,
                     void* out, int64_t n_rows, int64_t passes,
                     int64_t group_rows, void* stream) {
  return launch(kMul, av, bv, meta, out, nullptr, n_rows, passes, group_rows,
                stream);
}

int esc_scan_dd_f32(const void* qh, const void* ql, const void* meta,
                    void* out_s, void* out_e, int64_t n_rows, int64_t passes,
                    int64_t group_rows, void* stream) {
  return launch(kDD, qh, ql, meta, out_s, out_e, n_rows, passes, group_rows,
                stream);
}

}  // extern "C"
