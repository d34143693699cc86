// Fused Ozaki-slice f64 strip kernel for Hopper (sm_90a), C ABI for ctypes.
//
// Replaces spgemm_tpu/ops/pallas_kernels.py:_ozaki_strip_kernel_factory
// (:971), reached through ozaki_strip_pallas (:1137).
//
// What it computes. Each A tile g of block blk (tile-rows
// [blk*block_rows, min((blk+1)*block_rows, gm))) has a stacked int8 plane
// av8[g] (stack_rows, tk) whose rows s*tm .. (s+1)*tm hold A slice s
// (s < sa; rows at or past sa*tm are zero padding and are never read).
// For every y < max_b with s_c = slots[g*max_b + y] < max_cblock and every
// B slice t < sb with p = s + t <= pmax:
//   M_p[blk*max_cblock + s_c] += A_s(g) . bv8[ak[g]][:, (t*max_b+y)*tn : +tn]
// in exact int32, and
//   cnt[blk*max_cblock + s_c] += a_occ[g] . b_occ[ak[g]][:, y*tn : +tn].
// Each C element then reduces its n_groups = min(sa+sb-1, pmax+1) group
// sums to a triple float (h, m, l): mh = f32(M_p), ml = f32(M_p - i32(mh)),
// both scaled by 2^(-7p), each added by cascaded TwoSum, in the reference's
// order. Outputs are four f32 planes h, m, l, cnt in the block-padded
// layout (n_blocks*max_cblock, tm, tn); every slot no pair reaches is zero.
// Padded pairs point at slot max_cblock, which no CTA owns.
//
// What differs from the TPU kernel, and why. The TPU kernel keeps a whole
// block's group accumulators in VMEM ((max_cblock+1) x n_groups*tm x tn
// int32, megabytes) over an in-order grid. One C slot's accumulators alone
// are n_groups*tm*tn int32: 128 KB at the cant-like plan (8 groups, tm 32),
// 240 KB with all 15 groups, more than a CTA's 227 KB of shared memory.
// So here a CTA owns one C slot and 32 of its 128 columns (grid.y = 4):
// its accumulators (at most 15 groups x tm x 32 int32, 60 KB at tm 32) sit
// in registers, one 16x8 tile per group per warp, so the (tm, tn) set of
// every plan fits. The CTA finds its (g, y) pairs by scanning the block's
// slot words in order (warp-0 ballot compaction, as csrc/strip_numeric.cu
// does), stages the pair's A slice stack and its B slices (transposed to
// k-contiguous columns) in shared memory, and multiplies with int8 tensor
// core mma.sync.m16n8k32 (s8 x s8 -> s32, exact). The occupancy count is
// one more int8 product of the 0/1 planes (exact integers, converted to
// f32 at the end).
//
// Exactness. Every int8 product and int32 group sum is exact; the host
// plan guarantees |M_p| < 2^30 (ops/ozaki.py:_check_int32_bound). The
// TwoSum reduce uses __fadd_rn/__fsub_rn/__fmul_rn and the library is
// built with --fmad=false and without --use_fast_math or flush-to-zero, so
// h, m and l are bit-equal to the plain PyTorch version on any values.
//
// What bounds it on the card. Useful work at the cant-like plan is the
// kept slice-pair products: 11,688 pairs x 1,152 kept rows x 128 x 128 =
// 2.2e11 int8 MACs, against ~1 POP/s of dense int8 mma.sync; the operand
// bytes staged per pair (the A stack, up to 32 KB, and the CTA's B
// columns, up to 32 KB) come from L2 and are re-read by the 4 column CTAs
// of a slot. With one staging buffer and no copy/compute overlap it is
// bound by shared-memory staging latency and the fragment loads; wgmma,
// TMA and a pipelined, persistent grid are later work.
//
// Limits (checked by the caller, spgemm_tpu_torch/ops/ozaki_kernels.py):
//   (tm, tn) in {(16,128), (32,128)}; tk % 16 == 0; 1 <= sa, sb <= 8;
//   stack_rows >= sa*tm; n_blocks*max_cblock < 2^31 (grid size).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC ozaki_strip.cu -o libozaki_strip.so

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTN = 128;            // C tile width (the only instantiated tn)
constexpr int kCN = 32;             // C columns per CTA
constexpr int kKC = 128;            // k depth staged per step
constexpr int kLd = kKC + 16;       // shared row stride, bytes: conflict-free
                                    // 4-byte fragment reads (36 words)
constexpr int kMaxSlices = 8;
constexpr int kMaxGroups = 2 * kMaxSlices - 1;
constexpr int kMatchCap = 256;      // (g, y) matches gathered per pass

__device__ __forceinline__ uint32_t occ_byte(uint32_t bf16_bits) {
  return (bf16_bits & 0x7fffu) != 0u ? 1u : 0u;
}

__device__ __forceinline__ void mma_s8(int32_t (&c)[4], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void two_sum(float a, float b, float& s,
                                        float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One CTA per (padded C slot, 32-column chunk). Warp w owns rows
// (w/4)*16 .. +16 and columns (w%4)*8 .. +8 of the chunk, for every group.
template <int TM>
__global__ void __launch_bounds__(TM * 8, 512 / (TM * 8))
ozaki_strip_kernel(const int8_t* __restrict__ av8,
                   const uint16_t* __restrict__ a_occ,
                   const int8_t* __restrict__ bv8,
                   const uint16_t* __restrict__ b_occ,
                   const int32_t* __restrict__ aptr,
                   const int32_t* __restrict__ ak,
                   const int32_t* __restrict__ slots,
                   float* __restrict__ c_h, float* __restrict__ c_m,
                   float* __restrict__ c_l, float* __restrict__ c_cnt,
                   int64_t gm, int64_t block_rows, int64_t max_b,
                   int64_t max_cblock, int64_t stack_rows, int64_t tk,
                   int sa, int sb, int pmax, int n_groups) {
  constexpr int kThreads = TM * 8;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* s_a = reinterpret_cast<int8_t*>(smem);      // [sa*TM][kLd]
  int8_t* s_b = s_a + sa * TM * kLd;                   // [sb][kCN][kLd]
  int8_t* s_ao = s_b + sb * kCN * kLd;                 // [TM][kLd]
  int8_t* s_bo = s_ao + TM * kLd;                      // [kCN][kLd]
  __shared__ int32_t match[kMatchCap];
  __shared__ int32_t n_match;
  __shared__ int64_t scan_next;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rb = warp >> 2;         // 16-row block
  const int cb = warp & 3;          // 8-column block of the chunk
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int64_t slot_id = blockIdx.x;
  const int c0 = blockIdx.y * kCN;
  const int64_t blk = slot_id / max_cblock;
  const int32_t s_c = static_cast<int32_t>(slot_id - blk * max_cblock);
  const int64_t r0 = blk * block_rows;
  const int64_t r1 = r0 + block_rows < gm ? r0 + block_rows : gm;
  const int64_t e_begin = static_cast<int64_t>(aptr[r0]) * max_b;
  const int64_t e_end = static_cast<int64_t>(aptr[r1]) * max_b;
  const int64_t ldb = static_cast<int64_t>(sb) * max_b * kTN;
  const int64_t ldbo = max_b * kTN;

  int32_t acc[kMaxGroups][4];
  int32_t cnt[4] = {0, 0, 0, 0};
#pragma unroll
  for (int p = 0; p < kMaxGroups; ++p) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[p][i] = 0;
  }

  int64_t e0 = e_begin;
  while (e0 < e_end) {
    // warp 0 gathers the next run of this slot's (g, y) entries in order
    if (tid < 32) {
      int n = 0;
      int64_t e = e0;
      while (e < e_end && n + 32 <= kMatchCap) {
        const int64_t mine = e + tid;
        const bool hit = mine < e_end && slots[mine] == s_c;
        const unsigned ball = __ballot_sync(0xffffffffu, hit);
        if (hit) {
          match[n + __popc(ball & ((1u << tid) - 1u))] =
              static_cast<int32_t>(mine - e_begin);
        }
        n += __popc(ball);
        e += 32;
      }
      if (tid == 0) {
        n_match = n;
        scan_next = e;
      }
    }
    __syncthreads();
    const int nm = n_match;
    e0 = scan_next;

    for (int mi = 0; mi < nm; ++mi) {
      const int64_t entry = e_begin + match[mi];
      const int64_t g = entry / max_b;
      const int64_t y = entry - g * max_b;
      const int64_t kslab = ak[g];
      const int8_t* a_g = av8 + g * stack_rows * tk;
      const uint16_t* ao_g = a_occ + g * TM * tk;
      const int8_t* b_g = bv8 + kslab * tk * ldb + y * kTN + c0;
      const uint16_t* bo_g = b_occ + kslab * tk * ldbo + y * kTN + c0;

      for (int64_t k0 = 0; k0 < tk; k0 += kKC) {
        // A slice stack: 16-byte rows pieces, zero past tk
        for (int i = tid; i < sa * TM * (kKC / 16); i += kThreads) {
          const int r = i >> 3;
          const int v = i & 7;
          const int64_t k = k0 + v * 16;
          uint4 w = make_uint4(0u, 0u, 0u, 0u);
          if (k < tk) w = *reinterpret_cast<const uint4*>(a_g + r * tk + k);
          *reinterpret_cast<uint4*>(s_a + r * kLd + v * 16) = w;
        }
        // B slices, transposed to k-contiguous columns in 4x4 byte blocks
        for (int u = tid; u < sb * (kKC / 4) * (kCN / 4); u += kThreads) {
          const int t = u / ((kKC / 4) * (kCN / 4));
          const int rem = u - t * ((kKC / 4) * (kCN / 4));
          const int kq = rem >> 3;
          const int nq = rem & 7;
          const int64_t k = k0 + kq * 4;
          const int8_t* src = b_g + k * ldb + t * max_b * kTN + nq * 4;
          uint32_t r[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) r[j] = k + j < tk ? ld32(src + j * ldb) : 0u;
          const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
          const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
          const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);
          const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
          int8_t* dst = s_b + (t * kCN + nq * 4) * kLd + kq * 4;
          *reinterpret_cast<uint32_t*>(dst) = __byte_perm(t0, t1, 0x5410);
          *reinterpret_cast<uint32_t*>(dst + kLd) = __byte_perm(t0, t1, 0x7632);
          *reinterpret_cast<uint32_t*>(dst + 2 * kLd) = __byte_perm(t2, t3, 0x5410);
          *reinterpret_cast<uint32_t*>(dst + 3 * kLd) = __byte_perm(t2, t3, 0x7632);
        }
        // A occupancy: bf16 0/1 -> int8 0/1, 8 values per 16-byte load
        for (int i = tid; i < TM * (kKC / 8); i += kThreads) {
          const int r = i >> 4;
          const int v = i & 15;
          const int64_t k = k0 + v * 8;
          uint4 w = make_uint4(0u, 0u, 0u, 0u);
          if (k < tk) w = *reinterpret_cast<const uint4*>(ao_g + r * tk + k);
          const uint32_t lo = occ_byte(w.x) | occ_byte(w.x >> 16) << 8 |
                              occ_byte(w.y) << 16 | occ_byte(w.y >> 16) << 24;
          const uint32_t hi = occ_byte(w.z) | occ_byte(w.z >> 16) << 8 |
                              occ_byte(w.w) << 16 | occ_byte(w.w >> 16) << 24;
          *reinterpret_cast<uint2*>(s_ao + r * kLd + v * 8) = make_uint2(lo, hi);
        }
        // B occupancy, transposed like the B slices
        for (int u = tid; u < (kKC / 4) * (kCN / 4); u += kThreads) {
          const int kq = u >> 3;
          const int nq = u & 7;
          const int64_t k = k0 + kq * 4;
          uint32_t out[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (k + j < tk) {
              const uint2 w = *reinterpret_cast<const uint2*>(
                  bo_g + (k + j) * ldbo + nq * 4);
              out[0] |= occ_byte(w.x) << (8 * j);
              out[1] |= occ_byte(w.x >> 16) << (8 * j);
              out[2] |= occ_byte(w.y) << (8 * j);
              out[3] |= occ_byte(w.y >> 16) << (8 * j);
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            *reinterpret_cast<uint32_t*>(s_bo + (nq * 4 + i) * kLd + kq * 4) =
                out[i];
          }
        }
        __syncthreads();

#pragma unroll
        for (int ks = 0; ks < kKC / 32; ++ks) {
          const int kb = ks * 32 + tig * 4;
          uint32_t bf[kMaxSlices][2];
#pragma unroll
          for (int t = 0; t < kMaxSlices; ++t) {
            if (t < sb) {
              const int8_t* p = s_b + (t * kCN + cb * 8 + gid) * kLd + kb;
              bf[t][0] = ld32(p);
              bf[t][1] = ld32(p + 16);
            }
          }
#pragma unroll
          for (int s = 0; s < kMaxSlices; ++s) {
            if (s < sa) {
              const int8_t* p = s_a + (s * TM + rb * 16 + gid) * kLd + kb;
              const uint32_t a0 = ld32(p);
              const uint32_t a1 = ld32(p + 8 * kLd);
              const uint32_t a2 = ld32(p + 16);
              const uint32_t a3 = ld32(p + 8 * kLd + 16);
#pragma unroll
              for (int t = 0; t < kMaxSlices; ++t) {
                if (t < sb && s + t <= pmax) {
                  mma_s8(acc[s + t], a0, a1, a2, a3, bf[t][0], bf[t][1]);
                }
              }
            }
          }
          const int8_t* pa = s_ao + (rb * 16 + gid) * kLd + kb;
          const int8_t* pb = s_bo + (cb * 8 + gid) * kLd + kb;
          mma_s8(cnt, ld32(pa), ld32(pa + 8 * kLd), ld32(pa + 16),
                 ld32(pa + 8 * kLd + 16), ld32(pb), ld32(pb + 16));
        }
        __syncthreads();
      }
    }
    // every thread has read n_match/scan_next before warp 0 rewrites them
    __syncthreads();
  }

  // triple-float reduce of the group sums, in the reference's order
  const int64_t base = slot_id * TM * kTN;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int64_t row = rb * 16 + gid + half * 8;
    const int64_t off = base + row * kTN + c0 + cb * 8 + tig * 2;
    float h[2], m[2], l[2], c[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = half * 2 + j;
      float hh = 0.f, mm = 0.f, ll = 0.f;
#pragma unroll
      for (int p = 0; p < kMaxGroups; ++p) {
        if (p < n_groups) {
          const int32_t mp = acc[p][i];
          const float mh = __int2float_rn(mp);
          const float ml = __int2float_rn(mp - __float2int_rz(mh));
          const float scale = __int_as_float((127 - 7 * p) << 23);
          float e, e2;
          two_sum(hh, __fmul_rn(mh, scale), hh, e);
          two_sum(mm, e, mm, e2);
          ll = __fadd_rn(ll, e2);
          two_sum(hh, __fmul_rn(ml, scale), hh, e);
          two_sum(mm, e, mm, e2);
          ll = __fadd_rn(ll, e2);
        }
      }
      h[j] = hh;
      m[j] = mm;
      l[j] = ll;
      c[j] = __int2float_rn(cnt[i]);
    }
    *reinterpret_cast<float2*>(c_h + off) = make_float2(h[0], h[1]);
    *reinterpret_cast<float2*>(c_m + off) = make_float2(m[0], m[1]);
    *reinterpret_cast<float2*>(c_l + off) = make_float2(l[0], l[1]);
    *reinterpret_cast<float2*>(c_cnt + off) = make_float2(c[0], c[1]);
  }
}

template <int TM>
int launch(int64_t n_slots, cudaStream_t stream, const int8_t* av8,
           const uint16_t* a_occ, const int8_t* bv8, const uint16_t* b_occ,
           const int32_t* aptr, const int32_t* ak, const int32_t* slots,
           float* c_h, float* c_m, float* c_l, float* c_cnt, int64_t gm,
           int64_t block_rows, int64_t max_b, int64_t max_cblock,
           int64_t stack_rows, int64_t tk, int sa, int sb, int pmax,
           int n_groups) {
  const size_t smem = static_cast<size_t>(sa * TM + sb * kCN + TM + kCN) * kLd;
  cudaError_t err = cudaFuncSetAttribute(
      ozaki_strip_kernel<TM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(n_slots), kTN / kCN);
  ozaki_strip_kernel<TM><<<grid, TM * 8, smem, stream>>>(
      av8, a_occ, bv8, b_occ, aptr, ak, slots, c_h, c_m, c_l, c_cnt, gm,
      block_rows, max_b, max_cblock, stack_rows, tk, sa, sb, pmax, n_groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted. Launches on
// `stream`, does not synchronise, allocates nothing.
int ozaki_strip_f32(const void* av8, const void* a_occ, const void* bv8,
                    const void* b_occ, const void* aptr, const void* ak,
                    const void* slots, void* c_h, void* c_m, void* c_l,
                    void* c_cnt, int64_t gm, int64_t block_rows,
                    int64_t max_b, int64_t max_cblock, int64_t n_blocks,
                    int64_t tm, int64_t tk, int64_t tn, int64_t stack_rows,
                    int64_t sa, int64_t sb, int64_t pmax, void* stream) {
  const int64_t n_slots = n_blocks * max_cblock;
  if (n_slots <= 0 || n_slots > INT32_MAX || tn != kTN || tk < 16 ||
      tk % 16 != 0 || max_b < 1 || block_rows < 1 || gm < 1 || sa < 1 ||
      sa > kMaxSlices || sb < 1 || sb > kMaxSlices || pmax < 0 ||
      stack_rows < sa * tm) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t ng64 = sa + sb - 1 < pmax + 1 ? sa + sb - 1 : pmax + 1;
  const int n_groups = static_cast<int>(ng64);
  const int pm = static_cast<int>(pmax < 2 * kMaxSlices ? pmax : 2 * kMaxSlices);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* a8 = static_cast<const int8_t*>(av8);
  const auto* ao = static_cast<const uint16_t*>(a_occ);
  const auto* b8 = static_cast<const int8_t*>(bv8);
  const auto* bo = static_cast<const uint16_t*>(b_occ);
  const auto* ap = static_cast<const int32_t*>(aptr);
  const auto* kk = static_cast<const int32_t*>(ak);
  const auto* sl = static_cast<const int32_t*>(slots);
  auto* ch = static_cast<float*>(c_h);
  auto* cm = static_cast<float*>(c_m);
  auto* cl = static_cast<float*>(c_l);
  auto* cc = static_cast<float*>(c_cnt);
  switch (tm) {
    case 32:
      return launch<32>(n_slots, st, a8, ao, b8, bo, ap, kk, sl, ch, cm, cl,
                        cc, gm, block_rows, max_b, max_cblock, stack_rows, tk,
                        static_cast<int>(sa), static_cast<int>(sb), pm,
                        n_groups);
    case 16:
      return launch<16>(n_slots, st, a8, ao, b8, bo, ap, kk, sl, ch, cm, cl,
                        cc, gm, block_rows, max_b, max_cblock, stack_rows, tk,
                        static_cast<int>(sa), static_cast<int>(sb), pm,
                        n_groups);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
