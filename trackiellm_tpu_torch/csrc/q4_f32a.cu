// Q4 group-quantized matmul with unquantized activations for Hopper
// (sm_90a).
//
// Replaces trackiellm_tpu/ops/quant.py:q4_matmul_pallas (its body is
// _q4_kernel), the route the JAX package takes under TRACKIE_Q4_F32A=1.
// Computes out (M, N) f32 = x (M, K) @ W (K, N), where
//   - x is bf16 or f32 and is never quantized; unlike the W4A8 kernel
//     (q4_w4a8.cu) there is no activation pre-pass;
//   - W is Q4 packed across the K halves, the layout q4_w4a8.cu reads:
//     packed[r, n] holds W[r, n] + 8 in the low nibble and W[K/2 + r, n] in
//     two's complement in the high nibble, with f32 group scales (K/G, N):
//     rows [0, K/2G) scale the low half, rows [K/2G, K/G) the high half.
// Per group g of the low half and its twin in the high half:
//   acc += (x_lo . q_lo) * s_lo[g] + (x_hi . q_hi) * s_hi[g]
// with f32 dots over the signed values. The TPU kernel keeps the low nibble
// biased and folds the bias as (x_lo . (q + 8) - 8 * sum(x_lo)) * s_lo, and
// reads the high nibble as 16q with 1/16 folded into its scale. Both folds
// are exact in the math; these kernels unbias in the unpack instead, which
// spares the f32 cancellation of the bias fold.
//
// What bounds it on the H100: at decode (M = 1) each packed byte feeds two
// multiply-adds, so bytes bound it: 60.5 MB of packed w_gu (K 4096, N 28672)
// and its scales, 0.0181 ms at 3.35 TB/s. At prefill (M = 512) the products
// bound it: 120 G operations for w_gu, 0.1216 ms at the 989 TFLOP/s bf16
// peak.
//
// Two kernels, chosen by x's dtype:
//
// bf16 (q4_f32a_mma_kernel, the model's path): a Q4 weight q is in [-8, 7],
// exact in bf16, so every product of a bf16 x and a weight is exact in f32
// and mma.sync.m16n8k16 (bf16 in, f32 accumulate) computes the group dots.
// Against the bytes at decode: each block streams chunks of packed rows x
// 128 columns through a cp.async ring (16-byte copies; 4-byte ones where
// N % 16 != 0 or packed is not 16-byte aligned; zeros past N). The 16-row
// decode tile takes 64-row chunks in 4 stages and fits four blocks an SM,
// so up to 96 KB of packed weights are in flight on each SM, and K is split
// by whole group pairs toward 8 blocks an SM (ops/quant.py:_f32a_plan).
// Each stage carries, beside the packed chunk, both x slices its rows feed
// (x[:, r] for the low nibble, x[:, K/2 + r] for the high one; bf16, rows
// past M zero-filled) and, in the chunk that ends a group, both scale rows
// (g and K/2G + g).
// Against shared-memory traffic and issue slots: the packed chunk is never
// widened into shared memory. ldmatrix.trans reads it as 16-bit elements
// (pairs of packed bytes), so that a register holds two K rows of an even
// and an odd column, and the register is widened in place into the B
// fragments of four products (low and high half, even and odd column).
// The n8 tiles of a warp hold alternate columns, so each thread owns four
// adjacent output columns: one float4 of each scale row, one float4 store.
// The widening costs no conversion instruction: 128 + u is exact in bf16
// for a nibble u and its bits are 0x4300 | u, so a byte permute puts two
// nibbles (the high one with its sign bit flipped, which makes both q + 8)
// under 0x43 and one bf16x2 FMA subtracts 136. A reaches the tensor cores
// through ldmatrix from the x slices (rows padded by 16 bytes); the packed
// chunk's 16-byte segments rotate with the row, so its copies and its
// ldmatrix.trans reads are free of bank conflicts. Two dot sets, one a
// half, run over a group's chunks; after its last chunk the low dots times
// the low scale row, then the high dots times the high one, fold into the
// accumulator. Against the operations at prefill: a 64 x 128 tile of 8
// warps of 32 x 32, 64-row chunks in 4 stages, two blocks an SM; its three
// 32-float sets spill about 26 registers a thread, and one block an SM
// without the spill was 17% slower. Each K split writes its own (M, N)
// slice and sum_splits_kernel adds them in split order, so the result does
// not depend on scheduling. Measured with tools/kernel_times.py on NVIDIA
// H100 80GB HBM3 at 700 W (PERF.md), w_gu device-only at M = 1 and 512:
// nibbles widened into two bf16 planes in shared memory, as q8_matmul.cu
// widens its int8, 0.0585 and 0.7764 ms; widened in registers, 32-row
// chunks and three blocks an SM at decode, 0.0504 and 0.6072; 64-row
// chunks and four blocks an SM at decode, 0.0369 and 0.6068.
//
// f32 (q4_f32a_fma_kernel, the port's first f32a kernel, kept for the 1e-5
// tolerance that rounding x to bf16 would break; no model path sends f32 x
// to the card): f32 FMAs on the CUDA cores, a (BM, 64) tile a block, each
// 32-row slice of a group pair staged in shared memory as f32 (the x rows
// of both halves and the signed nibbles of both halves); K split by whole
// groups.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

// --- bf16 x on the tensor cores ---------------------------------------------

constexpr int kBN = 128;        // columns per block

// A block of WARPS_M x 4 warps owns BM x kBN outputs; a warp owns MT m16
// slabs x 32 columns. A chunk is KC packed rows (KC / 16 m16n8k16 steps in
// each half). One ring stage holds a chunk: the raw packed tile, the two x
// slices (rows of KC bf16 padded by 16 bytes; low half, then high half)
// and the two scale rows (written only where the chunk folds).
template <int WARPS_M, int MT, int KC, int STAGES>
struct F32aTile {
  static constexpr int kWarps = WARPS_M * 4;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int BM = WARPS_M * MT * 16;
  static constexpr int kXLD = KC + 8;
  static constexpr int kRaw = KC * kBN;                // packed bytes
  static constexpr int kX = BM * kXLD * 2;             // one x slice, bytes
  static constexpr int kStage = kRaw + 2 * kX + 2 * kBN * 4;
  static constexpr int kSmem = STAGES * kStage;
  static_assert(KC % 32 == 0 && STAGES >= 3, "chunk or ring too small");
  static_assert(kStage % 16 == 0, "stages must stay 16-byte aligned");
};

// Byte offset of 16-byte segment `seg` (0..7) of row r of the raw chunk:
// segments rotate with r % 8, so that the 8 rows an ldmatrix reads (one
// segment each) and the 8 segments of one row a copy phase writes fall in
// 8 distinct bank groups.
__device__ __forceinline__ int raw_off(int r, int seg) {
  return r * kBN + 16 * (seg ^ (r & 7));
}

// Split z walks groups [z * groups_per_split, (z + 1) * groups_per_split)
// of each half, in chunks of KC packed rows; a chunk folds the dots when
// it ends a group. n8 tile j of a warp holds the even
// (j even) or odd columns of its 16-column half j / 2, so d[i][j][e] is row
// rb + 16 i + g + 8 (e >> 1), column cb + 16 (j / 2) + 4 t + 2 (e & 1) +
// (j & 1) of the block tile, for warp w at rb = (w / 4) MT 16, cb = (w % 4)
// 32, g = lane / 4, t = lane % 4: each thread owns 4 adjacent columns.
template <int WARPS_M, int MT, int KC, int STAGES, int MIN_BLOCKS>
__global__ void __launch_bounds__(
    F32aTile<WARPS_M, MT, KC, STAGES>::kThreads, MIN_BLOCKS)
    q4_f32a_mma_kernel(const __nv_bfloat16* __restrict__ x,
                       const uint8_t* __restrict__ packed,
                       const float* __restrict__ scales,
                       float* __restrict__ out, int M, int K, int N, int G,
                       int groups_per_split, int vec16) {
  using T = F32aTile<WARPS_M, MT, KC, STAGES>;
  constexpr int kXLD = T::kXLD;
  constexpr int NT = 4;  // n8 tiles a warp owns
  extern __shared__ __align__(128) uint8_t smem[];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int rb = (warp / 4) * MT * 16, cb = (warp % 4) * 32;
  const int m0 = blockIdx.x * T::BM;
  const int n0 = blockIdx.y * kBN;
  const int half = K / 2;
  const int ngh = half / G;  // groups a half
  const int cpg = G / KC;    // chunks a group
  const int r_begin = blockIdx.z * groups_per_split * G;
  const int n_chunks =
      min(ngh - (int)blockIdx.z * groups_per_split, groups_per_split) * cpg;

  // Chunk c folds the dots when it ends a group.
  auto folds = [&](int c) { return (c + 1) % cpg == 0; };

  // Issue the copies of chunk c into its ring slot.
  auto load_chunk = [&](int c) {
    uint8_t* st = smem + (c % STAGES) * T::kStage;
    const int krow = r_begin + c * KC;  // packed row == low-half K index
    for (int i = tid; i < KC * (kBN / 16); i += T::kThreads) {
      const int r = i / (kBN / 16), seg = i % (kBN / 16);
      const int n = n0 + 16 * seg;
      const uint8_t* src = packed + (size_t)(krow + r) * N + n;
      uint8_t* dst = st + raw_off(r, seg);
      if (vec16) {
        cp_async16(dst, n < N ? src : packed, n < N ? 16 : 0);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool ok = n + 4 * q < N;
          cp_async4(dst + 4 * q, ok ? src + 4 * q : packed, ok ? 4 : 0);
        }
      }
    }
    // Both x slices: low half (h = 0) at K index krow, high half at
    // K/2 + krow.
    auto* xs = reinterpret_cast<__nv_bfloat16*>(st + T::kRaw);
    for (int i = tid; i < 2 * T::BM * (KC / 8); i += T::kThreads) {
      const int h = i / (T::BM * (KC / 8));
      const int rest = i % (T::BM * (KC / 8));
      const int r = rest / (KC / 8), seg = rest % (KC / 8);
      const int m = m0 + r;
      cp_async16(xs + (h * T::BM + r) * kXLD + 8 * seg,
                 m < M ? x + (size_t)m * K + h * half + krow + 8 * seg : x,
                 m < M ? 16 : 0);
    }
    if (folds(c)) {
      // Both scale rows of the chunk's group: N and n are multiples of 4,
      // so a 16-byte copy is either wholly inside a row or wholly past it.
      auto* f = reinterpret_cast<float*>(st + T::kRaw + 2 * T::kX);
      const int g = krow / G;
      for (int i = tid; i < 2 * (kBN / 4); i += T::kThreads) {
        const int h = i / (kBN / 4), c4 = 4 * (i % (kBN / 4));
        const int n = n0 + c4;
        cp_async16(f + h * kBN + c4,
                   n < N ? scales + (size_t)(h * ngh + g) * N + n : scales,
                   n < N ? 16 : 0);
      }
    }
  };

  float acc[MT][NT][4], part_lo[MT][NT][4], part_hi[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[i][j][e] = part_lo[i][j][e] = part_hi[i][j][e] = 0.f;

  // Prologue: chunks 0 .. STAGES - 2 in flight (an empty group where the
  // split has fewer chunks keeps the wait counts).
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_chunks) load_chunk(s);
    cp_async_commit();
  }

  // The lane's row and segment of the four 8 x 16-byte matrices an
  // ldmatrix.x4.trans reads at each k step: k rows 0-7 and 8-15 of the
  // warp's two 16-column halves.
  const int b_row = ((lane >> 3) & 1) * 8 + (lane & 7);
  const int b_seg = cb / 16 + (lane >> 4);

  for (int c = 0; c < n_chunks; ++c) {
    // Chunk c has landed for every thread, and every warp is done with
    // chunk c - 1, whose ring slot the copies below reuse.
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (c + STAGES - 1 < n_chunks) load_chunk(c + STAGES - 1);
    cp_async_commit();

    const uint8_t* st = smem + (c % STAGES) * T::kStage;
    const auto* xs = reinterpret_cast<const __nv_bfloat16*>(st + T::kRaw);
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      uint32_t b[4];  // k 0-7 and 8-15 of the first 16 columns, then the next
      ldmatrix_x4_trans(b, st + raw_off(ks * 16 + b_row, b_seg));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t a[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i)
          ldmatrix_x4(a[i], xs + (h * T::BM + rb + 16 * i + (lane & 15)) *
                                     kXLD + ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          uint32_t lo0[2], hi0[2], lo1[2], hi1[2];
          widen_frag(b[2 * cc], lo0, hi0);       // k 0-7
          widen_frag(b[2 * cc + 1], lo1, hi1);   // k 8-15
#pragma unroll
          for (int p = 0; p < 2; ++p) {          // even, odd columns
#pragma unroll
            for (int i = 0; i < MT; ++i) {
              if (h == 0)
                mma_bf16(part_lo[i][2 * cc + p], a[i], lo0[p], lo1[p]);
              else
                mma_bf16(part_hi[i][2 * cc + p], a[i], hi0[p], hi1[p]);
            }
          }
        }
      }
    }

    if (folds(c)) {
      // The low dots times the low scale row, then the high dots times the
      // high one, into the accumulator.
      const float* f = reinterpret_cast<const float*>(st + T::kRaw + 2 * T::kX);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int col = cb + 16 * jj + 4 * t4;
        const float4 sl = *reinterpret_cast<const float4*>(f + col);
        const float4 sh = *reinterpret_cast<const float4*>(f + kBN + col);
        const float s_lo[4] = {sl.x, sl.y, sl.z, sl.w};
        const float s_hi[4] = {sh.x, sh.y, sh.z, sh.w};
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int p = 0; p < 2; ++p)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int j = 2 * jj + p, s = 2 * (e & 1) + p;
              acc[i][j][e] += part_lo[i][j][e] * s_lo[s];
              acc[i][j][e] += part_hi[i][j][e] * s_hi[s];
              part_lo[i][j][e] = part_hi[i][j][e] = 0.f;
            }
      }
    }
  }
  cp_async_wait<0>();

  float* dst = out + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int er = 0; er < 2; ++er) {
      const int m = m0 + rb + 16 * i + g8 + 8 * er;
      if (m >= M) continue;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int n = n0 + cb + 16 * jj + 4 * t4;  // N % 4 == 0
        if (n < N)
          *reinterpret_cast<float4*>(dst + (size_t)m * N + n) = make_float4(
              acc[i][2 * jj][2 * er], acc[i][2 * jj + 1][2 * er],
              acc[i][2 * jj][2 * er + 1], acc[i][2 * jj + 1][2 * er + 1]);
      }
    }
}

template <int WARPS_M, int MT, int KC, int STAGES, int MIN_BLOCKS>
int launch_mma(const void* x, const uint8_t* packed, const float* scales,
               float* dst, int M, int K, int N, int G, int splits,
               int groups_per_split, int vec16, cudaStream_t stream) {
  using T = F32aTile<WARPS_M, MT, KC, STAGES>;
  auto* kernel = q4_f32a_mma_kernel<WARPS_M, MT, KC, STAGES, MIN_BLOCKS>;
  static unsigned long long raised = 0;  // devices whose cap is set
  const int err = raise_smem_cap(kernel, T::kSmem, raised);
  if (err != 0) return err;
  dim3 grid((M + T::BM - 1) / T::BM, (N + kBN - 1) / kBN, splits);
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), packed, scales, dst, M, K, N, G,
      groups_per_split, vec16);
  return 0;
}

// --- f32 x on the CUDA cores -------------------------------------------------

constexpr int kFmaThreads = 256;
constexpr int kFmaBN = 64;      // output columns per block
constexpr int kFmaKC = 32;      // packed rows staged per step (each half)

template <int BM, int TM, int TN>
__global__ void __launch_bounds__(kFmaThreads) q4_f32a_fma_kernel(
    const float* __restrict__ x, const uint8_t* __restrict__ packed,
    const float* __restrict__ scales, float* __restrict__ out, int M, int K,
    int N, int G, int groups_per_split) {
  constexpr int THR_N = kFmaBN / TN;
  constexpr int THR_M = BM / TM;
  static_assert(THR_N * THR_M == kFmaThreads, "tile does not match block");
  __shared__ __align__(16) float sXlo[BM][kFmaKC + 1];  // +1: rows in other banks
  __shared__ __align__(16) float sXhi[BM][kFmaKC + 1];
  __shared__ __align__(16) float sWlo[kFmaKC][kFmaBN];
  __shared__ __align__(16) float sWhi[kFmaKC][kFmaBN];

  const int tid = threadIdx.x;
  const int tn = tid % THR_N;
  const int tm = tid / THR_N;
  const int n0 = blockIdx.x * kFmaBN;
  const int m0 = blockIdx.y * BM;
  const int half = K / 2;
  const int ngh = half / G;        // groups per half
  const int g_begin = blockIdx.z * groups_per_split;
  const int g_end = min(ngh, g_begin + groups_per_split);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int g = g_begin; g < g_end; ++g) {
    float plo[TM][TN], phi[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) plo[i][j] = phi[i][j] = 0.f;

    for (int kc = 0; kc < G; kc += kFmaKC) {
      const int krow = g * G + kc;  // packed row == k index in the low half
      for (int i = tid; i < BM * kFmaKC; i += kFmaThreads) {
        const int r = i / kFmaKC, c = i % kFmaKC;
        const int m = m0 + r;
        float lo = 0.f, hi = 0.f;
        if (m < M) {
          const float* row = x + (size_t)m * K + krow + c;
          lo = row[0];
          hi = row[half];
        }
        sXlo[r][c] = lo;
        sXhi[r][c] = hi;
      }
      for (int i = tid; i < kFmaKC * (kFmaBN / 4); i += kFmaThreads) {
        const int r = i / (kFmaBN / 4), c = i % (kFmaBN / 4);
        const int n = n0 + c * 4;
        uint32_t word = 0x88888888u;  // zero in both nibble encodings
        if (n < N)
          word = *reinterpret_cast<const uint32_t*>(
              packed + (size_t)(krow + r) * N + n);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t b = (word >> (8 * e)) & 0xFFu;
          sWlo[r][c * 4 + e] =
              static_cast<float>(static_cast<int>(b & 0x0Fu) - 8);
          // High nibble, two's complement: shift it to the top of an int8,
          // then arithmetic-shift back down to sign-extend.
          sWhi[r][c * 4 + e] = static_cast<float>(
              static_cast<int8_t>(b & 0xF0u) >> 4);
        }
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kFmaKC; ++k) {
        float alo[TM], ahi[TM], blo[TN], bhi[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          alo[i] = sXlo[tm * TM + i][k];
          ahi[i] = sXhi[tm * TM + i][k];
        }
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          blo[j] = sWlo[k][tn + j * THR_N];
          bhi[j] = sWhi[k][tn + j * THR_N];
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            plo[i][j] += alo[i] * blo[j];
            phi[i][j] += ahi[i] * bhi[j];
          }
      }
      __syncthreads();
    }
    // Both halves' raw dots times their scale rows, into the accumulator.
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tn + j * THR_N;
      const float s_lo = n < N ? scales[(size_t)g * N + n] : 0.f;
      const float s_hi = n < N ? scales[(size_t)(ngh + g) * N + n] : 0.f;
#pragma unroll
      for (int i = 0; i < TM; ++i)
        acc[i][j] += plo[i][j] * s_lo + phi[i][j] * s_hi;
    }
  }

  float* dst = out + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + tm * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tn + j * THR_N;
      if (n < N) dst[(size_t)m * N + n] = acc[i][j];
    }
  }
}

template <int BM, int TM, int TN>
int launch_fma(const void* x, const uint8_t* packed, const float* scales,
               float* dst, int M, int K, int N, int G, int splits,
               int groups_per_split, cudaStream_t stream) {
  dim3 grid((N + kFmaBN - 1) / kFmaBN, (M + BM - 1) / BM, splits);
  q4_f32a_fma_kernel<BM, TM, TN><<<grid, kFmaThreads, 0, stream>>>(
      static_cast<const float*>(x), packed, scales, dst, M, K, N, G,
      groups_per_split);
  return 0;
}

}  // namespace

// dtype of x: 0 = f32 (q4_f32a_fma_kernel; tile rows BM 4, 16 or 64 from
// ops/quant.py:_split_k_plan; splits of whole groups), 1 = bf16
// (q4_f32a_mma_kernel; BM 16 or 64 from ops/quant.py:_f32a_plan). Split z
// walks groups [z * groups_per_split, (z + 1) * groups_per_split) of each
// half, and the splits cover them. ``partial``
// holds (splits, M, N) f32 when splits > 1 and may be null otherwise. For
// bf16 x, x and ``scales`` must be 16-byte aligned and ``packed`` 4-byte
// aligned. Returns a cudaError_t, or -1 for arguments the kernels do not
// take.
extern "C" int trackie_q4_f32a(const void* x, const void* packed,
                               const void* scales, void* out, void* partial,
                               int M, int K, int N, int G, int dtype, int BM,
                               int splits, int groups_per_split,
                               void* stream) {
  const int ngh = G > 0 ? K / (2 * G) : 0;  // groups a half
  if (M < 1 || N < 4 || N % 4 || G < 32 || G % 32 || K % (2 * G) ||
      splits < 1 || groups_per_split < 1 ||
      (long long)(splits - 1) * groups_per_split >= ngh ||
      (long long)splits * groups_per_split < ngh ||
      (splits > 1 && partial == nullptr))
    return -1;
  auto s = static_cast<cudaStream_t>(stream);
  auto* w = static_cast<const uint8_t*>(packed);
  auto* sc = static_cast<const float*>(scales);
  float* dst = static_cast<float*>(splits > 1 ? partial : out);
  const auto addr = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p);
  };
  int status;
  if (dtype == 0 && (BM == 4 || BM == 16 || BM == 64)) {
    if (BM == 4)
      status = launch_fma<4, 1, 1>(x, w, sc, dst, M, K, N, G, splits,
                                   groups_per_split, s);
    else if (BM == 16)
      status = launch_fma<16, 1, 4>(x, w, sc, dst, M, K, N, G, splits,
                                    groups_per_split, s);
    else
      status = launch_fma<64, 4, 4>(x, w, sc, dst, M, K, N, G, splits,
                                    groups_per_split, s);
  } else if (dtype == 1 && (BM == 16 || BM == 64)) {
    if (addr(x) % 16 || addr(scales) % 16 || addr(packed) % 4) return -1;
    const int vec16 = N % 16 == 0 && addr(packed) % 16 == 0;
    // The tiles (tools/kernel_times.py and PERF.md have the measurements):
    // 64-row chunks where G allows them, else 32-row ones; decode 16 x 128
    // in 4 stages (6 of 32 rows), four blocks an SM; above M = 16, 64 x 128
    // in 4 stages (6 of 32 rows), two blocks an SM.
    const bool kc64 = G % 64 == 0;
    if (BM == 16 && kc64)
      status = launch_mma<1, 1, 64, 4, 4>(x, w, sc, dst, M, K, N, G, splits,
                                          groups_per_split, vec16, s);
    else if (BM == 16)
      status = launch_mma<1, 1, 32, 6, 4>(x, w, sc, dst, M, K, N, G, splits,
                                          groups_per_split, vec16, s);
    else if (kc64)
      status = launch_mma<2, 2, 64, 4, 2>(x, w, sc, dst, M, K, N, G, splits,
                                          groups_per_split, vec16, s);
    else
      status = launch_mma<2, 2, 32, 6, 2>(x, w, sc, dst, M, K, N, G, splits,
                                          groups_per_split, vec16, s);
  } else {
    return -1;
  }
  if (status != 0) return status;
  if (splits > 1)
    launch_sum_splits(dst, static_cast<float*>(out), splits, (size_t)M * N, s);
  return static_cast<int>(cudaGetLastError());
}
