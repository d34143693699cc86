// Blockwise take_along_axis for Hopper (sm_90a), C ABI for ctypes.
//
// Replaces the Pallas kernel of the JAX repo's dynamic-gather probe,
// tools/probe_dyngather.py:make_gather_kernel (:30; pallas_call :40): the
// local shuffle the unstructured SpGEMM engine was designed around.
//
// What it computes. x is (R, C) float32, idx (R, C) int32, cut into R/B
// blocks of B = blk_rows rows (R % B == 0). For each block,
//   axis 1: out[r, c] = x[r, idx[r, c]]           (0 <= idx < C)
//   axis 0: out[r, c] = x[r0 + idx[r, c], c]      (0 <= idx < B, r0 the
//                                                   block's first row)
// which is numpy's take_along_axis on each (B, C) block. An index outside
// that range writes NaN; the kernel never reads outside the block.
//
// What differs from the TPU kernel, and why. The TPU kernel copies a whole
// (B, C) block into VMEM per grid step and lets Mosaic lower the gather to
// its lane or sublane shuffle, which compiled there only for 128 lanes and
// for B = 8. A CTA has at most 227 KB of shared memory, and a gather never
// crosses a row (axis 1) or a column (axis 0), so the port stages only
// what one gather reads:
//   axis 1: one warp per row. The warp stages its row in shared memory
//     (16-byte loads where C % 4 == 0 and the planes are 16-byte
//     aligned), then each lane reads four indices at once (coalesced),
//     reads the four values from the shared row and stores them
//     coalesced. C <= 1024, so 8 warps stage at most 32 KB.
//   axis 0: one CTA per (block, 32-column slice). B = 512 over 128
//     columns is 256 KB, past a CTA's shared memory; the 32-column slice
//     of a block is B x 32 floats (64 KB at B = 512, dynamic shared memory
//     past 48 KB). Lane l of every warp owns column l of the slice, so a
//     warp stages one 128-byte row segment at a time, and its reads
//     s[idx][l] fall in 32 different banks. B <= 1024 (128 KB).
//
// What bounds it on the card. Device memory: 12 bytes per element (x and
// idx read, out written, each once) against one shared-memory read; at
// the probe's largest case, (131072, 128), that is 201 MB, 0.060 ms at
// 3.35 TB/s. Loads and stores stream (__ldcs/__stcs): nothing is reused.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC dyngather.cu -o libdyngather.so

#include <cstdint>
#include <cuda_runtime.h>

#include "sm90_common.cuh"

namespace {

constexpr int kThreads = 256;          // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kSlice = 32;             // axis 0: columns per CTA
constexpr int kMaxRowLen = 1024;       // axis 1: C
constexpr int kMaxBlkRows = 1024;      // axis 0: B

__device__ __forceinline__ float pick(const float* s, int i, int n,
                                      int stride) {
  return static_cast<unsigned>(i) < static_cast<unsigned>(n)
             ? s[i * stride]
             : __int_as_float(0x7fc00000);  // NaN: index out of contract
}

// axis 1, one warp per row; VEC: C % 4 == 0 and every plane 16-byte
// aligned, so rows move as float4/int4
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    gather_lanes_kernel(const float* __restrict__ x,
                        const int* __restrict__ idx, float* __restrict__ out,
                        int64_t rows, int cols) {
  extern __shared__ float4 smem4[];
  float* row_s = reinterpret_cast<float*>(smem4) + (threadIdx.x >> 5) * cols;
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps +
                      (threadIdx.x >> 5);
  if (row >= rows) return;  // warps never meet at a CTA barrier
  const int64_t base = row * cols;
  if constexpr (VEC) {
    const float4* src = reinterpret_cast<const float4*>(x + base);
    float4* dst = reinterpret_cast<float4*>(row_s);
    for (int j = lane; j < cols / 4; j += 32) dst[j] = __ldcs(src + j);
    __syncwarp();
    const int4* ip = reinterpret_cast<const int4*>(idx + base);
    float4* op = reinterpret_cast<float4*>(out + base);
    for (int j = lane; j < cols / 4; j += 32) {
      const int4 i = __ldcs(ip + j);
      op[j] = make_float4(pick(row_s, i.x, cols, 1),
                          pick(row_s, i.y, cols, 1),
                          pick(row_s, i.z, cols, 1),
                          pick(row_s, i.w, cols, 1));
    }
  } else {
    for (int j = lane; j < cols; j += 32) row_s[j] = __ldcs(x + base + j);
    __syncwarp();
    for (int j = lane; j < cols; j += 32) {
      __stcs(out + base + j, pick(row_s, __ldcs(idx + base + j), cols, 1));
    }
  }
}

// axis 0, one CTA per (block, 32-column slice): s[r][lane] holds
// x[r0 + r, c0 + lane]
__global__ void __launch_bounds__(kThreads)
    gather_sublanes_kernel(const float* __restrict__ x,
                           const int* __restrict__ idx,
                           float* __restrict__ out, int cols, int blk_rows) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * blk_rows;
  const int c = blockIdx.y * kSlice + lane;
  const bool live = c < cols;  // the ragged last slice
  for (int r = warp; r < blk_rows; r += kWarps) {
    s[r * kSlice + lane] = live ? __ldcs(x + (row0 + r) * cols + c) : 0.f;
  }
  __syncthreads();
  if (!live) return;
  for (int r = warp; r < blk_rows; r += kWarps) {
    const int64_t off = (row0 + r) * cols + c;
    __stcs(out + off, pick(s + lane, __ldcs(idx + off), blk_rows, kSlice));
  }
}

bool g_smem_ready[sm90::kMaxDevices] = {};

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted
// (cudaErrorInvalidValue for arguments outside the limits above). Launches
// on `stream`, does not synchronise, allocates nothing.
int take_along_blocks_f32(const void* x, const void* idx, void* out,
                          int64_t rows, int64_t cols, int axis,
                          int64_t blk_rows, void* stream) {
  if (rows < 0 || cols < 0 || blk_rows < 1 || rows % blk_rows != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0 || cols == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const int* ip = static_cast<const int*>(idx);
  float* of = static_cast<float*>(out);
  if (axis == 1) {
    if (cols > kMaxRowLen) return static_cast<int>(cudaErrorInvalidValue);
    const bool vec = cols % 4 == 0 &&
                     ((reinterpret_cast<uintptr_t>(x) |
                       reinterpret_cast<uintptr_t>(idx) |
                       reinterpret_cast<uintptr_t>(out)) & 15) == 0;
    const int64_t blocks = (rows + kWarps - 1) / kWarps;
    const int smem = kWarps * static_cast<int>(cols) * 4;
    if (vec) {
      gather_lanes_kernel<true><<<static_cast<unsigned>(blocks), kThreads,
                                  smem, st>>>(xf, ip, of, rows,
                                              static_cast<int>(cols));
    } else {
      gather_lanes_kernel<false><<<static_cast<unsigned>(blocks), kThreads,
                                   smem, st>>>(xf, ip, of, rows,
                                               static_cast<int>(cols));
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (axis != 0 || blk_rows > kMaxBlkRows ||
      (cols + kSlice - 1) / kSlice > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err =
      sm90::set_smem_once(gather_sublanes_kernel, kMaxBlkRows * kSlice * 4,
                          false, g_smem_ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(rows / blk_rows),
                  static_cast<unsigned>((cols + kSlice - 1) / kSlice));
  const int smem = static_cast<int>(blk_rows) * kSlice * 4;
  gather_sublanes_kernel<<<grid, kThreads, smem, st>>>(
      xf, ip, of, static_cast<int>(cols), static_cast<int>(blk_rows));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
