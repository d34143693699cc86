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
// 240 KB with all 15 groups. So here a CTA owns h rows and 64 columns of
// one C slot (grid.y = tn/64 column chunks, grid.z the row chunks), its
// group sums in registers as int8 tensor-core accumulators: 8 groups
// (the instantiation for n_groups <= 8, two CTAs per SM at h 32) or 15
// (all groups, one CTA per SM).
//
// Tile shapes. Any tm % 8 == 0 and tn % 128 == 0 (every tn % 64 would
// do). A tile of 16 or 32 rows and 128 columns runs as it always has (the
// CHUNKED = false instantiations, tm and tn compile-time). Any other is
// cut into row chunks of h = 32, 16 or 8 rows: as many 32-row chunks as
// fit, then at most one of 16 and 8 rows (sm90_common.cuh:
// for_each_row_part; 64 -> 32 + 32, 24 -> 16 + 8; one 64-row CTA would
// need 512 threads at 128 registers), one launch per height. At h 8 the CTA keeps the 16-row
// layout of h 16 (128 threads, every A slice padded to an m16 fragment in
// shared memory, rows 8..15 zero and never written) and drops rows 8..15
// at the store. A chunk of rows r .. r+h (r = row_base + blockIdx.z*h)
// reads those rows of each A slice in the stacked av8 (slice s at rows
// s*tm + r) and of a_occ, and writes them in the slot's tile. Each chunk
// CTA gathers the slot's pairs itself, so a tile of q row chunks and n/64
// column chunks scans the slot words q*n/64 times, stages each A chunk
// n/64 times and each B chunk q times.
//
// Design.
//   Pairs: all threads scan the block's slot words, one word each per
//   pass, and compact the slot's (g, y) entries in order (ballot, popc,
//   a prefix over the warps); up to 256 a gather, in as many gathers as
//   the block needs.
//   Staging: each pair's k range is cut into 32-deep chunks, and the
//   chunks of all gathered pairs form one stream of steps through a ring of
//   three stages in dynamic shared memory, filled by cp.async 16-byte
//   copies with one barrier per step, so the next step's copies run under
//   this step's products. A stage holds the pair's A slice stack once for
//   the whole 64-column half (not once per 32 columns), its B slices as
//   they lie in memory (k rows, n contiguous), and both bf16 occupancy
//   planes.
//   B without a transpose: int8 mma wants B k-contiguous per column, and
//   bv8 is n-contiguous. ldmatrix.trans on the bytes taken as b16 pairs,
//   fed k rows {0,1,4,5,8,9,12,13} (+2, +16, +18), hands each thread
//   B[4i..4i+3] for columns 2j and 2j+1; two byte permutes per register
//   pair then give the m16n8k32 B fragments of an even-column and an
//   odd-column n8 tile. Each warp's 16 columns are those two tiles, so a
//   thread ends up holding four adjacent columns of C (one 16-byte store
//   per row and plane). The B slices' fragments are taken two at a time,
//   so only 8 of their registers live beside the accumulators (two CTAs
//   per SM need <= 128 a thread). The B rows are stored with their
//   16-byte chunks XOR-swizzled by (k >> 2) & 3, and the A rows padded to
//   48 bytes, so every ldmatrix is free of bank conflicts.
//   Counts: bf16 mma.m16n8k16 straight on the 0/1 bf16 planes, A through
//   ldmatrix and B through ldmatrix.trans (as csrc/strip_numeric.cu): no
//   conversion pass, exact in f32 accumulators.
//
// Exactness. Every int8 product and int32 group sum is exact; the host
// plan guarantees |M_p| < 2^30 (ops/ozaki.py:_check_int32_bound), so the
// order of the pairs does not matter. The TwoSum reduce uses
// __fadd_rn/__fsub_rn/__fmul_rn and the library is built with
// --fmad=false and without --use_fast_math or flush-to-zero, so h, m and l
// are bit-equal to the plain PyTorch version on any values.
//
// What bounds it on the card. At the cant-like plan (tm 32, S = 8x8,
// pmax 7, 11,688 pairs) the plan's own inputs and outputs are 914 MB
// (0.273 ms at 3.35 TB/s) and its kept slice products 2.2e11 int8 MACs
// (0.223 ms at 1,979 TOP/s). Per pair the two column CTAs stage about
// 240 KB from L2 (the A stack twice, B, the occupancy planes). Measured on
// an H100 (PERF.md section 6), neither side bounds it alone: the copies, the
// mma.sync products with their fragment loads, and the TwoSum reduce add
// up more than they overlap, since the accumulators (64 registers a
// thread) leave room for only 16 warps per SM, each step ends in a block
// barrier, and a C slot has only ~1.5 pairs (6 steps) between gathers and
// epilogues. Dead ends (same card): holding four B slices' fragments
// (fewer A reloads, a few spills), two stages instead of three, skipping
// zero TwoSum terms, a persistent grid that gathers the next slot during
// this one's products, and int8 wgmma with the B fragments in registers
// (A from shared memory) each ran as fast or slower. What is left is a
// producer/consumer design with the B operand K-major in shared memory
// (a transpose of bv8), asynchronous wgmma and TMA.
//
// Limits (checked by the caller, spgemm_tpu_torch/ops/ozaki_kernels.py):
//   tm % 8 == 0, tn % 128 == 0, tm/32 and tn/64 <= 65,535 (grid z and y);
//   tk % 16 == 0; 1 <= sa, sb <= 8; stack_rows >= sa*tm;
//   n_blocks*max_cblock < 2^31 (grid x).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC ozaki_strip.cu -o libozaki_strip.so

#include <cstdint>
#include <cuda_runtime.h>

#include "sm90_common.cuh"

namespace {

constexpr int kTN = 128;            // tn is a multiple of this
constexpr int kCN = 64;             // C columns per CTA (grid.y = tn/64)
constexpr int kMaxChunks = 65535;   // grid.y and grid.z limit
constexpr int kKC = 32;             // k depth of one pipeline step
constexpr int kStages = 3;
constexpr int kMaxSlices = 8;
constexpr int kPart = 2;            // B slices whose fragments live at once
constexpr int kMatchCap = 256;      // (g, y) entries gathered at once
constexpr int kMaxDevices = 64;
// shared-memory row strides in bytes (16-byte multiples for cp.async)
constexpr int kAStride = kKC + 16;       // int8 A rows: 48, conflict-free
constexpr int kBStride = kCN;            // int8 B rows: 64, chunks swizzled
constexpr int kAoStride = 2 * kKC + 16;  // bf16 A occupancy rows: 80
constexpr int kBoStride = 2 * kCN + 16;  // bf16 B occupancy rows: 144

// bytes of one ring stage for sa A slices and sb B slices of mr rows
__host__ __device__ constexpr int stage_bytes(int mr, int sa, int sb) {
  return sa * mr * kAStride + sb * kKC * kBStride + mr * kAoStride +
         kKC * kBoStride;
}

// the physical 16-byte chunk of logical chunk c in B row k
__device__ __forceinline__ int b_chunk(int k, int c) {
  return c ^ ((k >> 2) & 3);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma_s8(int32_t (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void two_sum(float a, float b, float& s,
                                        float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

// One CTA per (padded C slot, 64-column chunk, row chunk of TM rows);
// CHUNKED false: tm = TM and tn = 128 (the arguments are not read).
// Warp w owns rows (w/4)*16 .. +16 and columns (w%4)*16 .. +16 of the
// chunk, for every group: an even-column and an odd-column n8 tile of the
// int8 products (acc_e, acc_o: thread (gid, tig) holds columns
// 4*tig .. 4*tig+3 of rows gid and gid+8), and two plain n8 tiles of
// counts. At TM 8 the CTA is laid out for 16 rows (MR) and rows 8..15
// stay zero.
template <int TM, int NG, bool CHUNKED>
__global__ void __launch_bounds__((TM < 16 ? 16 : TM) * 8, NG <= 8 ? 2 : 1)
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
                   int64_t max_cblock, int64_t stack_rows, int64_t row_base,
                   int64_t tm_arg, int64_t tk, int64_t tn_arg, int sa, int sb,
                   int pmax, int n_groups) {
  constexpr int MR = TM < 16 ? 16 : TM;  // rows of the m16 fragments
  const int64_t tm = CHUNKED ? tm_arg : TM;
  const int64_t tn = CHUNKED ? tn_arg : kTN;
  constexpr int kThreads = MR * 8;
  constexpr int kWarps = kThreads / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int32_t match_g[kMatchCap];  // A tile of each gathered entry
  __shared__ int32_t match_y[kMatchCap];  // its B column block
  __shared__ int32_t match_k[kMatchCap];  // and its k slab, ak[g]
  __shared__ int32_t warp_hits[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rb = warp >> 2;  // 16-row block
  const int cb = warp & 3;   // 16-column block of the half
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int64_t slot_id = blockIdx.x;
  const int c0 = blockIdx.y * kCN;
  const int64_t row_off =
      CHUNKED ? row_base + static_cast<int64_t>(blockIdx.z) * TM : 0;
  const int64_t blk = slot_id / max_cblock;
  const int32_t s_c = static_cast<int32_t>(slot_id - blk * max_cblock);
  const int64_t r0 = blk * block_rows;
  const int64_t r1 = r0 + block_rows < gm ? r0 + block_rows : gm;
  const int64_t e_begin = static_cast<int64_t>(aptr[r0]) * max_b;
  const int64_t e_end = static_cast<int64_t>(aptr[r1]) * max_b;
  const int64_t ldb = static_cast<int64_t>(sb) * max_b * tn;
  const int64_t ldbo = max_b * tn;
  const int nch = static_cast<int>((tk + kKC - 1) / kKC);
  const int a_bytes = sa * MR * kAStride;
  const int b_bytes = sb * kKC * kBStride;
  const int stage = stage_bytes(MR, sa, sb);

  if (TM < 16) {
    // rows TM..15 of every A slice and of the A occupancy are never
    // copied: keep them zero (the gather's barriers land this first)
    uint4* z = reinterpret_cast<uint4*>(smem);
    for (int i = tid; i < kStages * stage / 16; i += kThreads) {
      z[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  int32_t acc_e[NG][4];
  int32_t acc_o[NG][4];
  float cnt[2][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int p = 0; p < NG; ++p) {
      acc_e[p][i] = 0;
      acc_o[p][i] = 0;
    }
    cnt[0][i] = 0.f;
    cnt[1][i] = 0.f;
  }

  // copies k chunk `step % nch` of gathered entry `step / nch` into stage
  // `buf`
  auto load_step = [&](int buf, int step) {
    // an opaque copy of the thread index: the copy offsets below are then
    // recomputed per step instead of held in registers across the loop
    int tid = threadIdx.x;
    asm volatile("" : "+r"(tid));
    const int mi = step / nch;
    const int64_t k0 = static_cast<int64_t>(step - mi * nch) * kKC;
    const int64_t g = match_g[mi];
    const int64_t y = match_y[mi];
    const int64_t ks = match_k[mi];
    unsigned char* st = smem + buf * stage;
    unsigned char* s_a = st;
    unsigned char* s_b = st + a_bytes;
    unsigned char* s_ao = s_b + b_bytes;
    unsigned char* s_bo = s_ao + MR * kAoStride;
    const int8_t* a_g = av8 + (g * stack_rows + row_off) * tk + k0;
    const int8_t* b_g = bv8 + (ks * tk + k0) * ldb + y * tn + c0;
    const uint16_t* ao_g = a_occ + (g * tm + row_off) * tk + k0;
    const uint16_t* bo_g = b_occ + (ks * tk + k0) * ldbo + y * tn + c0;
    const int64_t kleft = tk - k0;
    // A slice stack: TM rows of each of the sa slices (slice s at rows
    // s*tm of av8, at rows s*MR here), two 16-byte chunks a row
    for (int i = tid; i < sa * TM * 2; i += kThreads) {
      const int r = i >> 1;
      const int s = r / TM;
      const int rr = r - s * TM;
      const int c = i & 1;
      const bool in = c * 16 < kleft;
      cp_async16(s_a + (s * MR + rr) * kAStride + c * 16,
                 in ? a_g + (s * tm + rr) * tk + c * 16 : av8, in);
    }
    // B slices: sb x 32 k rows of four 16-byte chunks (64 columns)
    for (int i = tid; i < sb * kKC * 4; i += kThreads) {
      const int t = i >> 7;
      const int kr = (i >> 2) & (kKC - 1);
      const int c = i & 3;
      const bool in = kr < kleft;
      cp_async16(s_b + (t * kKC + kr) * kBStride + b_chunk(kr, c) * 16,
                 in ? b_g + kr * ldb + t * max_b * tn + c * 16 : bv8, in);
    }
    // A occupancy: TM rows of four chunks (8 bf16 each)
    for (int i = tid; i < TM * 4; i += kThreads) {
      const int r = i >> 2;
      const int c = i & 3;
      const bool in = c * 8 < kleft;
      cp_async16(s_ao + r * kAoStride + c * 16,
                 in ? ao_g + r * tk + c * 8 : a_occ, in);
    }
    // B occupancy: 32 k rows of eight chunks (64 columns)
    for (int i = tid; i < kKC * 8; i += kThreads) {
      const int kr = i >> 3;
      const int c = i & 7;
      const bool in = kr < kleft;
      cp_async16(s_bo + kr * kBoStride + c * 16,
                 in ? bo_g + kr * ldbo + c * 8 : b_occ, in);
    }
  };

  // the warp's products over stage `buf`
  auto compute_step = [&](int buf) {
    const unsigned char* st = smem + buf * stage;
    const unsigned char* s_a = st;
    const unsigned char* s_b = st + a_bytes;
    const unsigned char* s_ao = s_b + b_bytes;
    const unsigned char* s_bo = s_ao + MR * kAoStride;
    // B fragments: lane group q = lane/8 feeds the k rows
    // (q&1)*2 + (q>>1)*16 + {0,1,4,5,8,9,12,13}
    const int lr = lane & 7;
    const int lq = lane >> 3;
    const int kb = ((lq & 1) << 1) + ((lq >> 1) << 4) + ((lr >> 1) << 2) +
                   (lr & 1);
    const unsigned char* pb = s_b + kb * kBStride + b_chunk(kb, cb) * 16;
    const unsigned char* pa =
        s_a + (rb * 16 + (lane & 15)) * kAStride + (lane >> 4) * 16;
    // B slices in parts of two, so that only two slices' fragments (8
    // registers) live beside the accumulators; each part loads the A
    // fragments of the slices s with s + t <= pmax for some t in it
#pragma unroll
    for (int th = 0; th < kMaxSlices; th += kPart) {
      if (th < sb && th <= pmax) {
        uint32_t bfe[kPart][2];
        uint32_t bfo[kPart][2];
#pragma unroll
        for (int u = 0; u < kPart; ++u) {
          if (th + u < sb) {
            uint32_t r[4];
            ldmatrix_x4_trans(r, pb + (th + u) * kKC * kBStride);
            bfe[u][0] = __byte_perm(r[0], r[1], 0x6420);
            bfe[u][1] = __byte_perm(r[2], r[3], 0x6420);
            bfo[u][0] = __byte_perm(r[0], r[1], 0x7531);
            bfo[u][1] = __byte_perm(r[2], r[3], 0x7531);
          }
        }
#pragma unroll
        for (int s = 0; s < kMaxSlices; ++s) {
          if (s < sa && s + th <= pmax) {
            uint32_t af[4];
            ldmatrix_x4(af, pa + s * MR * kAStride);
#pragma unroll
            for (int u = 0; u < kPart; ++u) {
              constexpr int kLast = NG - 1;
              const int t = th + u;
              if (s + t <= kLast && t < sb && s + t <= pmax) {
                const int p = s + t <= kLast ? s + t : kLast;
                mma_s8(acc_e[p], af, bfe[u]);
                mma_s8(acc_o[p], af, bfo[u]);
              }
            }
          }
        }
      }
    }
    // counts: two k16 steps of bf16 products on the 0/1 planes
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 16) {
      uint32_t af[4];
      uint32_t bf[4];
      ldmatrix_x4(af, s_ao + (rb * 16 + (lane & 15)) * kAoStride +
                          (kk + (lane >> 4) * 8) * 2);
      ldmatrix_x4_trans(bf, s_bo + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                       kBoStride +
                                (cb * 16 + (lane >> 4) * 8) * 2);
      mma_bf16(cnt[0], af, bf[0], bf[1]);
      mma_bf16(cnt[1], af, bf[2], bf[3]);
    }
  };

  for (int64_t e0 = e_begin; e0 < e_end;) {
    // gather the slot's entries, one word per thread and pass, in order
    int nm = 0;
    while (e0 < e_end && nm + kThreads <= kMatchCap) {
      const int64_t e = e0 + tid;
      const bool hit = e < e_end && slots[e] == s_c;
      const unsigned ball = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) warp_hits[warp] = __popc(ball);
      __syncthreads();
      int base = nm;
      int total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int h = warp_hits[w];
        base += w < warp ? h : 0;
        total += h;
      }
      if (hit) {
        const int idx = base + __popc(ball & ((1u << lane) - 1u));
        const int64_t g = e / max_b;
        match_g[idx] = static_cast<int32_t>(g);
        match_y[idx] = static_cast<int32_t>(e - g * max_b);
        match_k[idx] = ak[g];
      }
      __syncthreads();  // matches visible; warp_hits free for the next pass
      nm += total;
      e0 += kThreads;
    }
    if (nm == 0) continue;

    // the stream of (entry, k chunk) steps through the cp.async ring
    const int steps = nm * nch;
#pragma unroll
    for (int p = 0; p < kStages - 1; ++p) {
      if (p < steps) load_step(p, p);
      cp_async_commit();
    }
    for (int step = 0; step < steps; ++step) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // this step's copies are visible; the buffer the
                        // next copies overwrite is no longer read
      const int next = step + kStages - 1;
      if (next < steps) load_step(next % kStages, next);
      cp_async_commit();
      compute_step(step % kStages);
    }
    cp_async_wait<0>();
    __syncthreads();  // stages and matches are free for the next gather
  }

  // triple-float reduce of the group sums, in the reference's order; at
  // TM 8 the rows 8..15 (half 1) are padding and are dropped
  const int64_t base = slot_id * tm * tn + row_off * tn + c0 + cb * 16;
#pragma unroll
  for (int half = 0; half < (TM < 16 ? 1 : 2); ++half) {
    const int64_t row_at = base + (rb * 16 + gid + half * 8) * tn;
    float h[4], m[4], l[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      // column 4*tig + q: even tile for q = 0, 2, odd for q = 1, 3
      const int i = half * 2 + (q >> 1);
      float hh = 0.f, mm = 0.f, ll = 0.f;
#pragma unroll
      for (int p = 0; p < NG; ++p) {
        if (p < n_groups) {
          const int32_t mp = (q & 1) ? acc_o[p][i] : acc_e[p][i];
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
      h[q] = hh;
      m[q] = mm;
      l[q] = ll;
    }
    const int64_t off = row_at + 4 * tig;
    *reinterpret_cast<float4*>(c_h + off) = make_float4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<float4*>(c_m + off) = make_float4(m[0], m[1], m[2], m[3]);
    *reinterpret_cast<float4*>(c_l + off) = make_float4(l[0], l[1], l[2], l[3]);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      *reinterpret_cast<float2*>(c_cnt + row_at + nt * 8 + 2 * tig) =
          make_float2(cnt[nt][half * 2], cnt[nt][half * 2 + 1]);
    }
  }
}

template <int TM, int NG, bool CHUNKED>
int launch(dim3 grid, cudaStream_t stream, const int8_t* av8,
           const uint16_t* a_occ, const int8_t* bv8, const uint16_t* b_occ,
           const int32_t* aptr, const int32_t* ak, const int32_t* slots,
           float* c_h, float* c_m, float* c_l, float* c_cnt, int64_t gm,
           int64_t block_rows, int64_t max_b, int64_t max_cblock,
           int64_t stack_rows, int64_t row_base, int64_t tm, int64_t tk,
           int64_t tn, int sa, int sb, int pmax, int n_groups) {
  constexpr int MR = TM < 16 ? 16 : TM;
  // the shared-memory attributes are set once per device, for the largest
  // stage (sa = sb = 8), so every plan launches under them
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices || !ready[dev]) {
    err = cudaFuncSetAttribute(ozaki_strip_kernel<TM, NG, CHUNKED>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kStages * stage_bytes(MR, kMaxSlices,
                                                     kMaxSlices));
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(ozaki_strip_kernel<TM, NG, CHUNKED>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) ready[dev] = true;
  }
  const size_t smem = static_cast<size_t>(kStages) * stage_bytes(MR, sa, sb);
  ozaki_strip_kernel<TM, NG, CHUNKED><<<grid, MR * 8, smem, stream>>>(
      av8, a_occ, bv8, b_occ, aptr, ak, slots, c_h, c_m, c_l, c_cnt, gm,
      block_rows, max_b, max_cblock, stack_rows, row_base, tm, tk, tn, sa, sb,
      pmax, n_groups);
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
  if (n_slots <= 0 || n_slots > INT32_MAX || tm < 8 || tm % 8 != 0 ||
      tm / 32 > kMaxChunks || tn < kTN || tn % kTN != 0 ||
      tn / kCN > kMaxChunks || tk < 16 || tk % 16 != 0 || max_b < 1 ||
      block_rows < 1 || gm < 1 || sa < 1 || sa > kMaxSlices || sb < 1 ||
      sb > kMaxSlices || pmax < 0 || stack_rows < sa * tm) {
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
  const int isa = static_cast<int>(sa);
  const int isb = static_cast<int>(sb);
  const bool wide = n_groups > 8;
  const auto col_chunks = static_cast<unsigned>(tn / kCN);
#define OZAKI_LAUNCH(TM, NG, CHUNKED, GRID, ROW0)                             \
  launch<TM, NG, CHUNKED>(GRID, st, a8, ao, b8, bo, ap, kk, sl, ch, cm, cl,   \
                          cc, gm, block_rows, max_b, max_cblock, stack_rows, \
                          ROW0, tm, tk, tn, isa, isb, pm, n_groups)
  if ((tm == 16 || tm == 32) && tn == kTN) {
    const dim3 grid(static_cast<unsigned>(n_slots), col_chunks);
    if (tm == 32) {
      return wide ? OZAKI_LAUNCH(32, 15, false, grid, 0)
                  : OZAKI_LAUNCH(32, 8, false, grid, 0);
    }
    return wide ? OZAKI_LAUNCH(16, 15, false, grid, 0)
                : OZAKI_LAUNCH(16, 8, false, grid, 0);
  }
  // as many 32-row chunks as fit, then one each of 16 and 8 rows
  return sm90::for_each_row_part<32, 16, 8>(
      tm, [&](auto h, int64_t row_base, unsigned n) {
        constexpr int H = decltype(h)::value;
        const dim3 grid(static_cast<unsigned>(n_slots), col_chunks, n);
        return wide ? OZAKI_LAUNCH(H, 15, true, grid, row_base)
                    : OZAKI_LAUNCH(H, 8, true, grid, row_base);
      });
#undef OZAKI_LAUNCH
}

}  // extern "C"
