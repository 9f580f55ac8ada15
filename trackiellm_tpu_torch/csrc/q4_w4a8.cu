// W4A8 group-quantized matmul for Hopper (sm_90a), on s8 tensor cores.
//
// Replaces trackiellm_tpu/ops/quant.py:q4_matmul_pallas_i8 (its body is
// _q4_kernel_i8) and the activation quantization that runs before it
// (quantize_activations_q8). Computes out (M, N) f32 = x (M, K) @ W (K, N):
//   - quantize_act_kernel quantizes x per (row, group of G) to int8 xq with
//     f32 scales sx = absmax / 127 (M, K/G) and bias-fold terms
//     sxsum = sx * sum(xq), bit for bit as ops/quant.py:quantize_activations_q8
//     (IEEE division, rintf's half-to-even, the 1e-12 floor, the +-127 clamp)
//     for finite x; a NaN or Inf in a group gives the plain version's sx
//     and a non-finite sxsum, so the output row is non-finite too;
//   - W is Q4 packed across the K halves: packed[r, n] holds W[r, n] in the
//     low nibble biased by +8 and W[K/2 + r, n] in the high nibble in two's
//     complement, with f32 group scales (K/G, N).
// Per group g of the low half and its twin in the high half:
//   acc += (dot_lo * sx_lo - 8 * sxsum_lo) * s_lo;  acc += dot_hi * sx_hi * s_hi
// with exact int32 dots (dot_lo over the biased nibbles, dot_hi over the
// signed ones), folded group by group in order.
//
// What bounds it on the H100: at decode (M = 1) every weight byte serves two
// multiply-adds, so weight bytes bound it (58.7 MB of nibbles for w_gu). At
// prefill (M = 512) the int8 products bound it (120 G operations for w_gu,
// 61 us at the 1,979 TOP/s int8 peak).
//
// Design: the dots run on the s8 tensor cores: wgmma.m64n64k32 for
// M > 16, mma.sync.m16n8k32 for decode (M <= 16). At M 1, 8 and 16 on the
// five Mistral-7B projections the 64-row wgmma tile took 1.22-1.78x the
// device time of the 16-row mma.sync tile (tools/kernel_times.py, NVIDIA
// H100 80GB HBM3, 700 W), likely because it fits two blocks an SM, not
// four (half the weight bytes in flight), and copies 64 rows of x (zeros
// past M) beside each weight chunk. The two paths agree bit for bit. Both s8
// operands must be K-contiguous, and the packed weight is N-contiguous, so
// each block streams 32 packed rows x 128 columns at a time through a
// 5-stage cp.async ring (16-byte copies; xq's two 32-byte row slices of the
// chunk ride in the same stage, and so do a group's scale rows and its
// rows' sx and sxsum in the group's last chunk), then splits the nibbles
// and transposes 4x4 byte blocks with __byte_perm into K-major lo and hi
// planes in shared memory. The planes are double-buffered: while the
// tensor cores multiply chunk c the threads unpack chunk c + 1, with one
// barrier a chunk. Layouts: for wgmma the x slices and the planes are
// wgmma's core matrices (8 rows x 16 bytes, read through a descriptor);
// for mma.sync they are 32-byte rows XOR-swizzled in 16-byte units, read
// by ldmatrix without bank conflicts. Block tiles: 64 x 128 with two
// warpgroups of 64 x 64 (wgmma), two blocks an SM; 16 x 128 with 4 warps of
// 16 x 32 for decode (mma.sync; rows past M are zero-filled), four blocks
// an SM. A group's int32 dots stay in the accumulators and fold into f32
// after its last chunk. When the tiles alone cannot fill the card, K is
// split across blocks by whole groups; each split writes its own (M, N)
// slice and sum_splits_kernel adds them in split order, so the result does
// not depend on scheduling.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

// --- activation quantization ----------------------------------------------

__device__ __forceinline__ float act_f32(float x) { return x; }
__device__ __forceinline__ float act_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float act_f32(__half x) { return __half2float(x); }

// One warp per (row, group); lane l takes elements l, l + 32, ...
// The group's absmax is a max over the bits of |x|: for non-negative floats
// the unsigned order is the float order, and a NaN's bits rank above +Inf's,
// so a NaN in the group makes sx NaN (as the plain version's amax does),
// where fmaxf would drop it. sx is stored from s, never from the floored
// divisor, so the fold carries the NaN into the output row.
template <typename T>
__global__ void __launch_bounds__(256) quantize_act_kernel(
    const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx,
    float* __restrict__ sxsum, int M, int K, int G) {
  const int ng = K / G;
  const int wid = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (wid >= M * ng) return;
  const int m = wid / ng, g = wid % ng;
  const size_t base = (size_t)m * K + (size_t)g * G;
  unsigned amax_bits = 0;
  for (int i = lane; i < G; i += 32)
    amax_bits = max(amax_bits, __float_as_uint(fabsf(act_f32(x[base + i]))));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax_bits = max(amax_bits, __shfl_xor_sync(0xffffffffu, amax_bits, o));
  const float s = __uint_as_float(amax_bits) / 127.0f;
  const float safe = fmaxf(s, 1e-12f);
  int sum = 0;
  for (int i = lane; i < G; i += 32) {
    float q = rintf(act_f32(x[base + i]) / safe);
    q = fminf(fmaxf(q, -127.f), 127.f);
    xq[base + i] = static_cast<int8_t>(q);
    sum += static_cast<int>(q);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane == 0) {
    sx[(size_t)m * ng + g] = s;
    sxsum[(size_t)m * ng + g] = s * static_cast<float>(sum);  // exact: |sum| < 2^24
  }
}

// --- the matmul -------------------------------------------------------------

constexpr int kBN = 128;     // columns per block
constexpr int kKC = 32;      // packed rows per chunk: one m16n8k32 step per half
constexpr int kStages = 5;   // cp.async ring depth

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// m64n64k32 s8 warpgroup product on operands in shared memory, described by
// da and db; scale_d 0 overwrites d, 1 adds to it. d holds the accumulator
// fragment: d[0][j][e] is row 16 w + g + 8 (e >> 1), column 8 j + 2 t +
// (e & 1) for warp w of the warpgroup, g = lane / 4, t = lane % 4.
__device__ __forceinline__ void wgmma_s8(int (&d)[1][8][4], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0][0][0]), "+r"(d[0][0][1]), "+r"(d[0][0][2]), "+r"(d[0][0][3]),
        "+r"(d[0][1][0]), "+r"(d[0][1][1]), "+r"(d[0][1][2]), "+r"(d[0][1][3]),
        "+r"(d[0][2][0]), "+r"(d[0][2][1]), "+r"(d[0][2][2]), "+r"(d[0][2][3]),
        "+r"(d[0][3][0]), "+r"(d[0][3][1]), "+r"(d[0][3][2]), "+r"(d[0][3][3]),
        "+r"(d[0][4][0]), "+r"(d[0][4][1]), "+r"(d[0][4][2]), "+r"(d[0][4][3]),
        "+r"(d[0][5][0]), "+r"(d[0][5][1]), "+r"(d[0][5][2]), "+r"(d[0][5][3]),
        "+r"(d[0][6][0]), "+r"(d[0][6][1]), "+r"(d[0][6][2]), "+r"(d[0][6][3]),
        "+r"(d[0][7][0]), "+r"(d[0][7][1]), "+r"(d[0][7][2]), "+r"(d[0][7][3])
      : "l"(da), "l"(db), "r"(scale_d));
}
// A wgmma shared-memory descriptor for a K-major tile in core matrices
// without swizzle: K-adjacent cores 128 bytes apart (the leading offset),
// 8-row groups 256 bytes apart (the stride offset).
__device__ __forceinline__ uint64_t wgmma_desc(const void* p) {
  return ((smem_addr(p) >> 4) & 0x3FFFull) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Shared-memory writes by threads (and cp.async) become visible to the
// tensor cores' asynchronous reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keeps the compiler from moving accesses to an in-flight accumulator.
template <int R, int C>
__device__ __forceinline__ void reg_fence(int (&d)[R][C][4]) {
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int b = 0; b < C; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(d[a][b][e])::"memory");
}

// Byte offset of 16-byte segment `seg` (0 or 1) of row `r` in a tile of
// 32-byte rows, swizzled so that eight consecutive rows' segments fall in
// eight distinct bank groups (the ldmatrix layout).
__device__ __forceinline__ int row32_off(int r, int seg) {
  return r * 32 + 16 * (seg ^ ((r >> 2) & 1));
}
// Byte offset of (row r, byte kb) of a K-major tile of 32-byte rows in
// wgmma's core matrices (8 rows x 16 bytes; see wgmma_desc).
__device__ __forceinline__ int core_off(int r, int kb) {
  return (r >> 3) * 256 + (kb >> 4) * 128 + (r & 7) * 16 + (kb & 15);
}
// Byte offset of 16-byte chunk `c` (0..7) of row `r` of the raw packed tile
// (kKC rows of kBN bytes), swizzled by the row's 4-row block.
__device__ __forceinline__ int raw_off(int r, int c) {
  return r * kBN + 16 * (c ^ ((r >> 2) & 7));
}

// The two signed nibble planes of four packed bytes: lo = b & 0xF (biased,
// 0..15), hi = the high nibble sign-extended (-8..7).
__device__ __forceinline__ uint32_t nib_lo(uint32_t w) { return w & 0x0F0F0F0Fu; }
__device__ __forceinline__ uint32_t nib_hi(uint32_t w) {
  const uint32_t h = (w >> 4) & 0x0F0F0F0Fu;
  return h | (((h & 0x08080808u) >> 3) * 0xF0u);
}

// A block of WARPS_M x 4 warps owns BM x kBN outputs. One ring stage holds a
// chunk: the raw packed tile, x's two 32-byte row slices (low and high
// half), and, in the last chunk of a group, the group's fold operands (its
// two scale rows and the rows' sx, sx and sxsum).
template <int WARPS_M, int MT>
struct Tile {
  static constexpr int kWarps = WARPS_M * 4;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int BM = WARPS_M * MT * 16;
  static constexpr int kRaw = kKC * kBN;             // raw packed bytes
  static constexpr int kX = BM * kKC;                // bytes of one x half
  static constexpr int kFold = (2 * kBN + 3 * BM) * 4;
  static constexpr int kStage = kRaw + 2 * kX + kFold;
  static constexpr int kW = kBN * kKC;               // one unpacked plane
  static constexpr int kSmem = kStages * kStage + 2 * 2 * kW;
  static_assert(kStage % 16 == 0, "stages must stay 16-byte aligned");
};

// WG = false: mma.sync, a warp owns MT m16 slabs x 32 columns (warp w at
// rows (w / 4) MT 16, columns (w % 4) 32). WG = true (WARPS_M = 2, MT = 2:
// 64 x 128): wgmma, warpgroup v owns all 64 rows x columns 64 v, a warp 16
// rows of them. Either way d[a][b][e] is row rb + 16 a + g + 8 (e >> 1),
// column cb + 8 b + 2 t + (e & 1).
template <int WARPS_M, int MT, int MIN_BLOCKS, bool WG>
__global__ void __launch_bounds__(Tile<WARPS_M, MT>::kThreads, MIN_BLOCKS)
    q4_w4a8_kernel(const int8_t* __restrict__ xq,
                   const float* __restrict__ sx,
                   const float* __restrict__ sxsum,
                   const uint8_t* __restrict__ packed,
                   const float* __restrict__ scales,
                   float* __restrict__ out, int M, int K, int N, int G,
                   int groups_per_split, int vec16) {
  using T = Tile<WARPS_M, MT>;
  static_assert(!WG || (WARPS_M == 2 && MT == 2), "wgmma tiles are 64 x 128");
  constexpr int R = WG ? 1 : MT;   // m16 slabs a thread's fragment spans
  constexpr int C = WG ? 8 : 4;    // n8 tiles a thread's fragment spans
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* sW = smem + kStages * T::kStage;  // [2][lo|hi][kW]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int rb = WG ? 16 * (warp & 3) : (warp / 4) * MT * 16;
  const int cb = WG ? 64 * (warp >> 2) : (warp % 4) * 32;
  const int m0 = blockIdx.x * T::BM;
  const int n0 = blockIdx.y * kBN;
  const int half = K / 2;
  const int ngh = half / G;
  const int ng = K / G;
  const int g_begin = blockIdx.z * groups_per_split;
  const int g_end = min(ngh, g_begin + groups_per_split);
  const int cpg = G / kKC;  // chunks per group
  const int n_chunks = (g_end - g_begin) * cpg;

  // Issue the copies of chunk c into its ring slot.
  auto load_chunk = [&](int c) {
    uint8_t* st = smem + (c % kStages) * T::kStage;
    const int g = g_begin + c / cpg, cc = c % cpg;
    const int krow = g * G + cc * kKC;
    for (int i = tid; i < kKC * (kBN / 16); i += T::kThreads) {
      const int r = i / (kBN / 16), ch = i % (kBN / 16);
      const int n = n0 + ch * 16;
      const uint8_t* src = packed + (size_t)(krow + r) * N + n;
      uint8_t* dst = st + raw_off(r, ch);
      if (vec16) {
        cp_async16(dst, n < N ? src : packed, n < N ? 16 : 0);
      } else {
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const bool ok = n + 4 * w < N;
          cp_async4(dst + 4 * w, ok ? src + 4 * w : packed, ok ? 4 : 0);
        }
      }
    }
    uint8_t* xs = st + T::kRaw;
    for (int i = tid; i < 2 * T::BM * 2; i += T::kThreads) {
      const int h = i / (2 * T::BM);        // 0 = low half, 1 = high half
      const int r = (i / 2) % T::BM, seg = i % 2;
      const int m = m0 + r;
      const int8_t* src =
          xq + (size_t)m * K + h * half + krow + seg * 16;
      cp_async16(xs + h * T::kX + (WG ? core_off(r, 16 * seg)
                                      : row32_off(r, seg)),
                 m < M ? src : xq, m < M ? 16 : 0);
    }
    if (cc == cpg - 1) {
      // The fold operands: scale rows g and ngh + g (16-byte copies; N and
      // n are multiples of 4), then sx lo, sx hi and sxsum lo per row.
      float* f = reinterpret_cast<float*>(st + T::kRaw + 2 * T::kX);
      for (int i = tid; i < kBN / 2 + 3 * T::BM; i += T::kThreads) {
        if (i < kBN / 2) {
          const int h = i / (kBN / 4), n = n0 + 4 * (i % (kBN / 4));
          cp_async16(f + h * kBN + 4 * (i % (kBN / 4)),
                     n < N ? scales + (size_t)(h * ngh + g) * N + n : scales,
                     n < N ? 16 : 0);
        } else {
          const int j = i - kBN / 2;
          const int which = j / T::BM, r = j % T::BM, m = m0 + r;
          const float* src = (which == 2 ? sxsum : sx) + (size_t)m * ng +
                             (which == 1 ? ngh : 0) + g;
          cp_async4(f + 2 * kBN + which * T::BM + r, m < M ? src : sx,
                    m < M ? 4 : 0);
        }
      }
    }
  };

  // Unpack chunk c into plane pair c & 1: each thread turns 4x4 byte blocks
  // (4 packed rows x 4 columns) into four K-major words per plane. Lane ->
  // (k block i, column block j); the writes go out in a per-j rotated order
  // so that one store instruction of a warp touches 32 distinct banks (in
  // the ldmatrix layout).
  auto unpack = [&](int c) {
    const uint8_t* raw = smem + (c % kStages) * T::kStage;
    uint8_t* wlo = sW + (c & 1) * 2 * T::kW;
    uint8_t* whi = wlo + T::kW;
    for (int blk = warp; blk < kBN / 16; blk += T::kWarps) {
      const int i = lane & 7;                 // packed rows 4i .. 4i+3
      const int j = blk * 4 + (lane >> 3);    // columns 4j .. 4j+3
      uint32_t r[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        r[q] = *reinterpret_cast<const uint32_t*>(
            raw + raw_off(4 * i + q, j >> 2) + 4 * (j & 3));
      const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
      const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
      const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
      const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
      uint32_t col[4] = {__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                         __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
      // col[e] holds k = 4i .. 4i+3 of column 4j + e; rotate by j & 3.
      if (j & 1) {
        const uint32_t x0 = col[0];
        col[0] = col[1]; col[1] = col[2]; col[2] = col[3]; col[3] = x0;
      }
      if (j & 2) {
        uint32_t x0 = col[0], x1 = col[1];
        col[0] = col[2]; col[1] = col[3]; col[2] = x0; col[3] = x1;
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int n = 4 * j + ((s + j) & 3);
        const int off = WG ? core_off(n, 4 * i)
                           : row32_off(n, i >> 2) + 4 * (i & 3);
        *reinterpret_cast<uint32_t*>(wlo + off) = nib_lo(col[s]);
        *reinterpret_cast<uint32_t*>(whi + off) = nib_hi(col[s]);
      }
    }
    if (WG) fence_proxy_async();
  };

  float acc[R][C][4];
  int dlo[R][C][4], dhi[R][C][4];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int b = 0; b < C; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[a][b][e] = 0.f;
        dlo[a][b][e] = dhi[a][b][e] = 0;
      }

  // Prologue: chunks 0 .. kStages - 2 in flight, then chunk 0 unpacked.
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_chunks) load_chunk(s);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();
  if (WG) fence_proxy_async();
  __syncthreads();
  if (n_chunks > 0) unpack(0);

  // Iteration c multiplies chunk c (its planes were unpacked in the last
  // iteration) while it unpacks chunk c + 1 into the other plane pair:
  // one barrier a chunk.
  for (int c = 0; c < n_chunks; ++c) {
    // Chunk c + 1 has landed for every thread; every warp is done with
    // chunk c - 1 (its ring slot, which the copies below reuse, and its
    // plane pair, which the unpack below rewrites) and wrote chunk c's
    // planes.
    cp_async_wait<kStages - 3>();
    if (WG) fence_proxy_async();
    __syncthreads();
    if (c + kStages - 1 < n_chunks) load_chunk(c + kStages - 1);
    cp_async_commit();

    const uint8_t* st = smem + (c % kStages) * T::kStage;
    const uint8_t* xs = st + T::kRaw;
    const uint8_t* wlo = sW + (c & 1) * 2 * T::kW;
    const uint8_t* whi = wlo + T::kW;
    if constexpr (WG) {
      // Both halves' products start on the tensor cores, the unpack of the
      // next chunk runs beside them; a group's first chunk overwrites the
      // dots (scale_d 0).
      const int accumulate = c % cpg != 0;
      reg_fence(dlo);
      reg_fence(dhi);
      wgmma_fence();
      wgmma_s8(dlo, wgmma_desc(xs), wgmma_desc(wlo + 32 * cb), accumulate);
      wgmma_s8(dhi, wgmma_desc(xs + T::kX), wgmma_desc(whi + 32 * cb),
               accumulate);
      wgmma_commit();
      if (c + 1 < n_chunks) unpack(c + 1);
      wgmma_wait0();
      reg_fence(dlo);
      reg_fence(dhi);
    } else {
      if (c + 1 < n_chunks) unpack(c + 1);
      // A (16 rows x 32 k) of each half from the x tiles, B (32 k x 8
      // columns) pairs from the planes.
      uint32_t alo[MT][4], ahi[MT][4];
#pragma unroll
      for (int a = 0; a < MT; ++a) {
        const int r = rb + a * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
        const int off = row32_off(r, lane >> 4);
        ldmatrix_x4(alo[a], xs + off);
        ldmatrix_x4(ahi[a], xs + T::kX + off);
      }
#pragma unroll
      for (int bp = 0; bp < C / 2; ++bp) {
        const int n = cb + bp * 16 + 8 * (lane >> 4) + (lane & 7);
        const int off = row32_off(n, (lane >> 3) & 1);
        uint32_t blo[4], bhi[4];
        ldmatrix_x4(blo, wlo + off);
        ldmatrix_x4(bhi, whi + off);
#pragma unroll
        for (int a = 0; a < MT; ++a) {
          mma_s8(dlo[a][2 * bp], alo[a], blo[0], blo[1]);
          mma_s8(dlo[a][2 * bp + 1], alo[a], blo[2], blo[3]);
          mma_s8(dhi[a][2 * bp], ahi[a], bhi[0], bhi[1]);
          mma_s8(dhi[a][2 * bp + 1], ahi[a], bhi[2], bhi[3]);
        }
      }
    }

    if (c % cpg == cpg - 1) {
      // Fold the group's int32 dots into the f32 accumulator, low half
      // first, as q4_matmul_w4a8_ref and the TPU kernel do; the operands
      // came with the chunk.
      const float* f =
          reinterpret_cast<const float*>(st + T::kRaw + 2 * T::kX);
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int er = 0; er < 2; ++er) {
          const int r = rb + a * 16 + g8 + 8 * er;
          const float x_lo = f[2 * kBN + r], x_hi = f[2 * kBN + T::BM + r];
          const float x_sum = f[2 * kBN + 2 * T::BM + r];
#pragma unroll
          for (int b = 0; b < C; ++b) {
            const int n = cb + b * 8 + 2 * t4;
            const float2 s_lo = *reinterpret_cast<const float2*>(f + n);
            const float2 s_hi = *reinterpret_cast<const float2*>(f + kBN + n);
            const float sl[2] = {s_lo.x, s_lo.y}, sh[2] = {s_hi.x, s_hi.y};
#pragma unroll
            for (int ec = 0; ec < 2; ++ec) {
              const int e = 2 * er + ec;
              acc[a][b][e] += (static_cast<float>(dlo[a][b][e]) * x_lo -
                               8.f * x_sum) * sl[ec];
              acc[a][b][e] += (static_cast<float>(dhi[a][b][e]) * x_hi) *
                              sh[ec];
              if (!WG) dlo[a][b][e] = dhi[a][b][e] = 0;
            }
          }
        }
    }
  }
  cp_async_wait<0>();

  float* dst = out + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int er = 0; er < 2; ++er) {
      const int m = m0 + rb + a * 16 + g8 + 8 * er;
      if (m >= M) continue;
#pragma unroll
      for (int b = 0; b < C; ++b) {
        const int n = n0 + cb + b * 8 + 2 * t4;  // even; N % 4 == 0
        if (n < N)
          *reinterpret_cast<float2*>(dst + (size_t)m * N + n) =
              make_float2(acc[a][b][2 * er], acc[a][b][2 * er + 1]);
      }
    }
}

template <int WARPS_M, int MT, int MIN_BLOCKS, bool WG>
int launch(const int8_t* xq, const float* sx, const float* sxsum,
           const uint8_t* packed, const float* scales, float* dst, int M,
           int K, int N, int G, int splits, int groups_per_split, int vec16,
           cudaStream_t stream) {
  using T = Tile<WARPS_M, MT>;
  static unsigned long long raised = 0;  // devices whose cap is set
  const int err = raise_smem_cap(q4_w4a8_kernel<WARPS_M, MT, MIN_BLOCKS, WG>,
                                 T::kSmem, raised);
  if (err != 0) return err;
  dim3 grid((M + T::BM - 1) / T::BM, (N + kBN - 1) / kBN, splits);
  q4_w4a8_kernel<WARPS_M, MT, MIN_BLOCKS, WG>
      <<<grid, T::kThreads, T::kSmem, stream>>>(
          xq, sx, sxsum, packed, scales, dst, M, K, N, G, groups_per_split,
          vec16);
  return 0;
}

}  // namespace

// x (M, K) of dtype 0 = f32, 1 = bf16, 2 = f16 -> xq (M, K) int8, sx and
// sxsum (M, K/G) f32. Returns a cudaError_t, or -1 for arguments the kernel
// does not take.
extern "C" int trackie_quantize_act(const void* x, void* xq, void* sx,
                                    void* sxsum, int M, int K, int G,
                                    int dtype, void* stream) {
  if (M < 1 || G < 32 || G % 32 || K % G) return -1;
  auto s = static_cast<cudaStream_t>(stream);
  const int warps = M * (K / G);
  const int blocks = (warps + 7) / 8;
  auto* q = static_cast<int8_t*>(xq);
  auto* a = static_cast<float*>(sx);
  auto* b = static_cast<float*>(sxsum);
  switch (dtype) {
    case 0:
      quantize_act_kernel<float><<<blocks, 256, 0, s>>>(
          static_cast<const float*>(x), q, a, b, M, K, G);
      break;
    case 1:
      quantize_act_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), q, a, b, M, K, G);
      break;
    case 2:
      quantize_act_kernel<__half><<<blocks, 256, 0, s>>>(
          static_cast<const __half*>(x), q, a, b, M, K, G);
      break;
    default:
      return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

// Tile rows BM must be 16 or 64 (ops/quant.py:_w4a8_plan picks it); tiles
// are 128 columns wide. ``partial`` holds (splits, M, N) f32 when splits > 1
// and may be null otherwise. ``packed`` and ``scales`` must be 16-byte
// aligned. Returns a cudaError_t, or -1 for arguments the kernel does not
// take.
extern "C" int trackie_q4_w4a8(const void* xq, const void* sx,
                               const void* sxsum, const void* packed,
                               const void* scales, void* out, void* partial,
                               int M, int K, int N, int G, int BM, int splits,
                               int groups_per_split, void* stream) {
  if (M < 1 || N < 4 || N % 4 || G % kKC || K % (2 * G) || splits < 1 ||
      groups_per_split < 1 || (splits > 1 && partial == nullptr) ||
      reinterpret_cast<uintptr_t>(packed) % 16 ||
      reinterpret_cast<uintptr_t>(scales) % 16)
    return -1;
  auto s = static_cast<cudaStream_t>(stream);
  auto* x = static_cast<const int8_t*>(xq);
  auto* a = static_cast<const float*>(sx);
  auto* b = static_cast<const float*>(sxsum);
  auto* w = static_cast<const uint8_t*>(packed);
  auto* sc = static_cast<const float*>(scales);
  float* dst = static_cast<float*>(splits > 1 ? partial : out);
  const int vec16 = N % 16 == 0;
  int status;
  switch (BM) {
    case 16:
      status = launch<1, 1, 4, false>(x, a, b, w, sc, dst, M, K, N, G,
                                      splits, groups_per_split, vec16, s);
      break;
    case 64:
      status = launch<2, 2, 2, true>(x, a, b, w, sc, dst, M, K, N, G,
                                     splits, groups_per_split, vec16, s);
      break;
    default:
      return -1;
  }
  if (status != 0) return status;
  if (splits > 1)
    launch_sum_splits(static_cast<const float*>(partial),
                      static_cast<float*>(out), splits, (size_t)M * N, s);
  return static_cast<int>(cudaGetLastError());
}
