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
// take_along_axis gather. None of that carries over. Here one warp owns
// one 128-lane row at a time, four lanes per thread (thread t holds lanes
// 4t .. 4t+3), so a row arrives as one 16-byte value load and one 8-byte
// meta load per thread and leaves as one 16-byte store. The doubling steps
// never cross a barrier: the source of lane i at step d is lane
// (i + d) mod 128, which for d = 1, 2 is partly in the thread's own
// registers and partly in thread t+1's (one and two shuffles), and for
// d >= 4 is the same register of thread (t + d/4) mod 32 (four shuffles).
// The wrap mirrors the plain version's roll; the plan never adds a
// wrapped value, since it caps dist at 127 - lane (esc.py:547). Every
// lane still adds q[i+d] of the step before, so the order is unchanged.
// The gather goes through a 512-byte shared row per warp between two
// __syncwarp; there is no __syncthreads. The G rows accumulate in
// registers.
//
// What bounds it on the card. Device memory traffic: 6 B per product in
// (f32 value + int16 meta; 10 B for mul, 10 B for dd) and 4/G B per lane
// out (8/G for dd), against a few shuffles and adds per lane and pass. At
// the rmat65536 A^2 plan that is 2.96 GB in and 1.98 GB out per launch.
// The design's answer is bytes in flight: a persistent grid (as many
// 256-thread CTAs as fit on the card) whose warps walk rows in a stride
// loop and issue the next row's loads before scanning the current one (a
// register double buffer), so each warp keeps two rows' loads, 1.5 KB
// (premul) to 2.5 KB (mul, dd), in flight.
//
// Limits (checked here and by the caller): group_rows in {1, 2, 4, 8},
// R a multiple of group_rows, passes in [0, 7], every plane 16-byte
// aligned. Element offsets are int64 (R*128 is 494 M at rmat65536 and
// passes 2^31 on larger graphs).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC esc_scan.cu -o libesc_scan.so

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;          // SCAN_WIN: lanes per plane row
constexpr int kThreads = 256;        // 8 warps, one row each at a time
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPasses = 7;

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

// One input row's loads for this thread: lanes 4t .. 4t+3.
struct RowLoad {
  float4 x0;
  float4 x1;  // mul: bv; dd: the lo plane; premul: unused
  uint2 meta;
};

template <int MODE>
__device__ __forceinline__ RowLoad load_row(const float* __restrict__ x0,
                                            const float* __restrict__ x1,
                                            const int16_t* __restrict__ meta,
                                            int64_t row, int t) {
  RowLoad r;
  const int64_t off = row * kLanes + 4 * t;
  r.x0 = __ldcs(reinterpret_cast<const float4*>(x0 + off));
  if constexpr (MODE != kPremul) {
    r.x1 = __ldcs(reinterpret_cast<const float4*>(x1 + off));
  } else {
    r.x1 = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  r.meta = __ldcs(reinterpret_cast<const uint2*>(meta + off));
  return r;
}

// The values of lanes 4t+j+d (mod 128), j = 0..3, for one doubling step.
template <int D>
__device__ __forceinline__ void step_sources(const float (&q)[4],
                                             float (&r)[4], int t) {
  const int nb = (t + 1) & 31;
  if constexpr (D == 1) {
    r[0] = q[1];
    r[1] = q[2];
    r[2] = q[3];
    r[3] = __shfl_sync(0xffffffffu, q[0], nb);
  } else if constexpr (D == 2) {
    r[0] = q[2];
    r[1] = q[3];
    r[2] = __shfl_sync(0xffffffffu, q[0], nb);
    r[3] = __shfl_sync(0xffffffffu, q[1], nb);
  } else {
    const int src = (t + D / 4) & 31;
#pragma unroll
    for (int j = 0; j < 4; ++j) r[j] = __shfl_sync(0xffffffffu, q[j], src);
  }
}

template <int MODE, int D>
__device__ __forceinline__ void scan_step(float (&s)[4], float (&e)[4],
                                          const int (&dist)[4], int t) {
  float sr[4];
  step_sources<D>(s, sr, t);
  if constexpr (MODE == kDD) {
    float er[4];
    step_sources<D>(e, er, t);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = dist[j] >= D;
      two_sum_acc(s[j], e[j], ok ? sr[j] : 0.f, ok ? er[j] : 0.f);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[j] = __fadd_rn(s[j], dist[j] >= D ? sr[j] : 0.f);
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, 4)
esc_scan_kernel(const float* __restrict__ x0, const float* __restrict__ x1,
                const int16_t* __restrict__ meta, float* __restrict__ out_s,
                float* __restrict__ out_e, int64_t n_out, int passes,
                int group_rows) {
  // per-warp gather rows: the s plane, and for dd the e plane
  __shared__ __align__(16) float sh_s[kWarps][kLanes];
  __shared__ __align__(16) float sh_e[kWarps][MODE == kDD ? kLanes : 4];
  const int t = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  int64_t o = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (o >= n_out) return;

  RowLoad cur = load_row<MODE>(x0, x1, meta, o * group_rows, t);
  for (;;) {
    float acc_s[4] = {0.f, 0.f, 0.f, 0.f};
    float acc_e[4] = {0.f, 0.f, 0.f, 0.f};
    const int64_t o_next = o + stride;
    for (int j = 0; j < group_rows; ++j) {
      // the next row's loads go out before this row's scan
      RowLoad nxt = cur;
      if (j + 1 < group_rows) {
        nxt = load_row<MODE>(x0, x1, meta, o * group_rows + j + 1, t);
      } else if (o_next < n_out) {
        nxt = load_row<MODE>(x0, x1, meta, o_next * group_rows, t);
      }

      // int16 -> int32 with sign extension (esc.py:394-396)
      const int m[4] = {
          static_cast<int>(static_cast<int16_t>(cur.meta.x & 0xffffu)),
          static_cast<int>(static_cast<int16_t>(cur.meta.x >> 16)),
          static_cast<int>(static_cast<int16_t>(cur.meta.y & 0xffffu)),
          static_cast<int>(static_cast<int16_t>(cur.meta.y >> 16))};
      int dist[4];
      float s[4];
      float e[4] = {0.f, 0.f, 0.f, 0.f};
      const float a[4] = {cur.x0.x, cur.x0.y, cur.x0.z, cur.x0.w};
      const float b[4] = {cur.x1.x, cur.x1.y, cur.x1.z, cur.x1.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        dist[q] = m[q] >> 8;
        if constexpr (MODE == kMul) {
          s[q] = __fmul_rn(a[q], b[q]);
        } else {
          s[q] = a[q];
        }
        if constexpr (MODE == kDD) e[q] = b[q];
      }

      if (passes > 0) scan_step<MODE, 1>(s, e, dist, t);
      if (passes > 1) scan_step<MODE, 2>(s, e, dist, t);
      if (passes > 2) scan_step<MODE, 4>(s, e, dist, t);
      if (passes > 3) scan_step<MODE, 8>(s, e, dist, t);
      if (passes > 4) scan_step<MODE, 16>(s, e, dist, t);
      if (passes > 5) scan_step<MODE, 32>(s, e, dist, t);
      if (passes > 6) scan_step<MODE, 64>(s, e, dist, t);

      // gather y[i] = q[idx[i]] * present[i] through the warp's row
      __syncwarp();  // the previous row's gather reads are done
      *reinterpret_cast<float4*>(&sh_s[warp][4 * t]) =
          make_float4(s[0], s[1], s[2], s[3]);
      if constexpr (MODE == kDD) {
        *reinterpret_cast<float4*>(&sh_e[warp][4 * t]) =
            make_float4(e[0], e[1], e[2], e[3]);
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int idx = m[q] & 127;
        const float present = static_cast<float>((m[q] >> 7) & 1);
        const float ys = __fmul_rn(sh_s[warp][idx], present);
        if constexpr (MODE == kDD) {
          const float ye = __fmul_rn(sh_e[warp][idx], present);
          if (j == 0) {
            acc_s[q] = ys;
            acc_e[q] = ye;
          } else {
            two_sum_acc(acc_s[q], acc_e[q], ys, ye);
          }
        } else {
          acc_s[q] = j == 0 ? ys : __fadd_rn(acc_s[q], ys);
        }
      }
      cur = nxt;
    }
    const int64_t oo = o * kLanes + 4 * t;
    __stcs(reinterpret_cast<float4*>(out_s + oo),
           make_float4(acc_s[0], acc_s[1], acc_s[2], acc_s[3]));
    if constexpr (MODE == kDD) {
      __stcs(reinterpret_cast<float4*>(out_e + oo),
             make_float4(acc_e[0], acc_e[1], acc_e[2], acc_e[3]));
    }
    o = o_next;
    if (o >= n_out) break;
  }
}

// A persistent grid: as many CTAs as fit on the card at once (resident
// CTAs per SM asked of the runtime at the first launch), or fewer when
// there are fewer rows.
template <int MODE>
int grid_size(int64_t n_out, cudaError_t& err) {
  static int per_sm = 0;
  int dev = 0;
  int n_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess && per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, esc_scan_kernel<MODE>, kThreads, 0);
  }
  if (err != cudaSuccess) return 0;
  const int64_t need = (n_out + kWarps - 1) / kWarps;
  const int64_t full = static_cast<int64_t>(n_sm) * (per_sm > 0 ? per_sm : 1);
  return static_cast<int>(need < full ? need : full);
}

template <int MODE>
int launch_mode(const float* a, const float* b, const int16_t* mt, float* os,
                float* oe, int64_t n_out, int passes, int g,
                cudaStream_t st) {
  cudaError_t err = cudaSuccess;
  const int grid = grid_size<MODE>(n_out, err);
  if (err != cudaSuccess) return static_cast<int>(err);
  esc_scan_kernel<MODE><<<grid, kThreads, 0, st>>>(a, b, mt, os, oe, n_out,
                                                    passes, g);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0u;
}

int launch(int mode, const void* x0, const void* x1, const void* meta,
           void* out_s, void* out_e, int64_t n_rows, int64_t passes,
           int64_t group_rows, void* stream) {
  if (n_rows < 0 || passes < 0 || passes > kMaxPasses ||
      !(group_rows == 1 || group_rows == 2 || group_rows == 4 ||
        group_rows == 8) ||
      n_rows % group_rows != 0 || !aligned16(x0) || !aligned16(meta) ||
      !aligned16(out_s) || (mode != kPremul && !aligned16(x1)) ||
      (mode == kDD && !aligned16(out_e))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_out = n_rows / group_rows;
  if (n_out == 0) return static_cast<int>(cudaSuccess);
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
      return launch_mode<kPremul>(a, b, mt, os, oe, n_out, ps, g, st);
    case kMul:
      return launch_mode<kMul>(a, b, mt, os, oe, n_out, ps, g, st);
    default:
      return launch_mode<kDD>(a, b, mt, os, oe, n_out, ps, g, st);
  }
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
