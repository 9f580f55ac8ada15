// Q8 group-quantized matmul for Hopper (sm_90a).
//
// Replaces trackiellm_tpu/ops/quant.py:q8_matmul_pallas (its body is
// _q8_kernel). Computes out (M, N) f32 = x (M, K) @ W (K, N), where
//   - x is bf16 or f32 and is never quantized;
//   - W is int8 (K, N), N-contiguous, with f32 group scales (K/G, N).
// Per K group g, as _q8_kernel computes it:
//   acc += (x[:, g*G:(g+1)*G] . W[g*G:(g+1)*G, :]) * scales[g, :]
// the group's raw dot, times the group's scale row, summed in f32 group
// after group. The TPU kernel picks the scale row with a one-hot matmul;
// here the scales are indexed directly.
//
// What bounds it on the H100: at decode (M = 1) each weight byte feeds one
// multiply-add, so weight bytes bound it: 119.3 MB of int8 values and f32
// scales for w_gu (K 4096, N 28672), 0.0356 ms at 3.35 TB/s. At prefill
// (M = 512) the products bound it: 120 G operations for w_gu, 0.1216 ms at
// the 989 TFLOP/s bf16 peak.
//
// Two kernels, chosen by x's dtype:
//
// bf16 (q8_mma_kernel, the model's path): |q| <= 127 needs 7 bits, so every
// weight is exact in bf16 and every product of a bf16 x and a weight is
// exact in f32; mma.sync.m16n8k16 (bf16 in, f32 accumulate) computes the
// group dots. A group's dot stays in one accumulator set over its K steps
// and folds, times the scale row, into a second set after its last chunk.
// Against the bytes at decode: each block streams chunks of K rows x 128
// columns of W through a cp.async ring (16-byte copies; 4-byte ones where
// N % 16 != 0 or W is not 16-byte aligned; byte loads where N % 4 != 0,
// common.cuh:copy_row16; zeros past N); the 16-row decode
// tile takes 32-row chunks in 5 stages and fits four blocks an SM, so 64 KB
// of weights are in flight on each SM, and K is split into many short
// blocks (ops/quant.py:_q8_plan), so that the last wave leaves few SMs
// idle. The chunk's x slice (bf16, rows past M zero-filled) and, in a
// group's last chunk, the group's scale row ride in the same stage.
// Against the operations at prefill: the int8 chunk is widened to bf16
// once a block (64 rows share it), into a double-buffered N-contiguous
// plane, while the tensor cores multiply the previous chunk: one barrier a
// chunk, and the 64-row tile takes 64-row chunks in 4 stages (two blocks an
// SM), half the barriers of 32-row ones (w_gu and lm_head at M = 512: 23-25%
// less device time than with 32-row chunks in 5 stages; tools/kernel_times.py
// on NVIDIA H100 80GB HBM3 at 700 W, PERF.md). The widening is exact and
// costs no conversion instruction: q + 128 is a byte u, 2^23 + u is a float
// built from its bits, less 2^23 + 128 it is q, and q's bf16 is that
// float's high half. B reaches the tensor cores through ldmatrix.trans from
// the plane, A through ldmatrix from the x slice; rows padded by 16 bytes,
// and a swizzle of the raw chunk, keep the shared-memory accesses free of
// bank conflicts. Warps: 4 of 16 x 32 in the decode tile, 8 of 32 x 32 in
// the 64 x 128 one. Each K split writes its own (M, N) slice and
// sum_splits_kernel adds them in split order, so the result does not
// depend on scheduling.
//
// f32 (q8_fma_kernel, the port's first Q8 kernel, kept for the 1e-5
// tolerance that rounding x to bf16 would break): f32 FMAs on the CUDA
// cores, a (BM, 64) tile a block; each 32-row slice of a group is staged in
// shared memory as f32 (x, and the weights widened four columns a load).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

// --- bf16 x on the tensor cores ---------------------------------------------

constexpr int kBN = 128;        // columns per block
constexpr int kWLD = kBN + 8;   // bf16 plane row (+16 bytes)

// A block of WARPS_M x 4 warps owns BM x kBN outputs; a warp owns MT m16
// slabs x 32 columns. A chunk is KC K rows (KC / 16 m16n8k16 steps); one
// ring stage holds a chunk: the raw int8 tile, the x slice (rows of KC bf16
// padded by 16 bytes), and the group's scale row (written in its last chunk
// only).
template <int WARPS_M, int MT, int KC, int STAGES>
struct Q8Tile {
  static constexpr int kWarps = WARPS_M * 4;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int BM = WARPS_M * MT * 16;
  static constexpr int kXLD = KC + 8;
  static constexpr int kRaw = KC * kBN;                // int8 bytes
  static constexpr int kX = BM * kXLD * 2;             // x slice bytes
  static constexpr int kStage = kRaw + kX + kBN * 4;   // + the scale row
  static constexpr int kPlane = KC * kWLD;             // bf16 of one plane
  static constexpr int kSmem = STAGES * kStage + 2 * kPlane * 2;
  static_assert(KC % 32 == 0 && STAGES >= 3, "chunk or ring too small");
  static_assert(kStage % 16 == 0, "stages must stay 16-byte aligned");
};

// Byte offset of 16-byte segment `seg` (0..7) of row r of the raw chunk:
// odd rows swap their two halves, so that the 8 threads of a widening
// phase (two rows, four segments each) read 8 distinct bank groups.
__device__ __forceinline__ int raw_off(int r, int seg) {
  return r * kBN + 16 * (seg ^ ((r & 1) << 2));
}

// Four int8 weights (one word) as two bf16x2 words, exactly (see the
// header): 0x4B0000uu is the float 2^23 + u.
__device__ __forceinline__ uint2 widen4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;   // q + 128 in each byte
  const float bias = 8388736.f;          // 2^23 + 128
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) - bias;
  return make_uint2(
      __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632),
      __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632));
}

// d[i][j][e] is row rb + 16 i + g + 8 (e >> 1), column cb + 8 j + 2 t +
// (e & 1) of the block tile, for warp w at rb = (w / 4) MT 16, cb = (w % 4)
// 32, g = lane / 4, t = lane % 4.
template <int WARPS_M, int MT, int KC, int STAGES, int MIN_BLOCKS>
__global__ void __launch_bounds__(Q8Tile<WARPS_M, MT, KC, STAGES>::kThreads,
                                  MIN_BLOCKS)
    q8_mma_kernel(const __nv_bfloat16* __restrict__ x,
                  const int8_t* __restrict__ w,
                  const float* __restrict__ scales, float* __restrict__ out,
                  int M, int K, int N, int G, int groups_per_split,
                  int vec) {
  using T = Q8Tile<WARPS_M, MT, KC, STAGES>;
  constexpr int kXLD = T::kXLD;
  constexpr int NT = 4;  // n8 tiles a warp owns
  extern __shared__ __align__(128) uint8_t smem[];
  __nv_bfloat16* planes =
      reinterpret_cast<__nv_bfloat16*>(smem + STAGES * T::kStage);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int rb = (warp / 4) * MT * 16, cb = (warp % 4) * 32;
  const int m0 = blockIdx.x * T::BM;
  const int n0 = blockIdx.y * kBN;
  const int ng = K / G;
  const int g_begin = blockIdx.z * groups_per_split;
  const int g_end = min(ng, g_begin + groups_per_split);
  const int cpg = G / KC;  // chunks per group
  const int n_chunks = max(0, g_end - g_begin) * cpg;

  // Issue the copies of chunk c into its ring slot.
  auto load_chunk = [&](int c) {
    uint8_t* st = smem + (c % STAGES) * T::kStage;
    const int g = g_begin + c / cpg, cc = c % cpg;
    const int k0 = g * G + cc * KC;
    for (int i = tid; i < KC * (kBN / 16); i += T::kThreads) {
      const int r = i / (kBN / 16), seg = i % (kBN / 16);
      const int n = n0 + 16 * seg;
      copy_row16(st + raw_off(r, seg), w + (size_t)(k0 + r) * N + n, w, n,
                 N, vec);
    }
    auto* xs = reinterpret_cast<__nv_bfloat16*>(st + T::kRaw);
    for (int i = tid; i < T::BM * (KC / 8); i += T::kThreads) {
      const int r = i / (KC / 8), seg = i % (KC / 8);
      const int m = m0 + r;
      cp_async16(xs + r * kXLD + 8 * seg,
                 m < M ? x + (size_t)m * K + k0 + 8 * seg : x, m < M ? 16 : 0);
    }
    if (cc == cpg - 1) {
      // The scale row.
      auto* f = reinterpret_cast<float*>(st + T::kRaw + T::kX);
      for (int i = tid; i < kBN / 4; i += T::kThreads) {
        const int n = n0 + 4 * i;
        copy_scales4(f + 4 * i, scales + (size_t)g * N + n, scales, n, N);
      }
    }
  };

  // Widen chunk c into plane c & 1. Index idx -> (row r, segment seg) so
  // that each phase of 8 threads reads two rows x four segments of the raw
  // chunk and writes 16-byte units (r + 2 seg) mod 8 of the plane: both
  // conflict-free.
  auto widen = [&](int c) {
    const uint8_t* raw = smem + (c % STAGES) * T::kStage;
    __nv_bfloat16* plane = planes + (c & 1) * T::kPlane;
#pragma unroll
    for (int idx = tid; idx < KC * (kBN / 16); idx += T::kThreads) {
      const int p8 = idx >> 3, j = idx & 7;
      const int r = 2 * (p8 >> 1) + (j & 1);
      const int seg = (j >> 1) + 4 * (p8 & 1);
      const uint4 q = *reinterpret_cast<const uint4*>(raw + raw_off(r, seg));
      const uint2 a = widen4(q.x), b = widen4(q.y), cc = widen4(q.z),
                  d = widen4(q.w);
      auto* dst = reinterpret_cast<uint4*>(plane + r * kWLD + 16 * seg);
      dst[0] = make_uint4(a.x, a.y, b.x, b.y);
      dst[1] = make_uint4(cc.x, cc.y, d.x, d.y);
    }
  };

  float acc[MT][NT][4], part[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = part[i][j][e] = 0.f;

  // Prologue: chunks 0 .. STAGES - 2 in flight (an empty group where the
  // split has fewer chunks keeps the wait counts), then chunk 0 widened.
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_chunks) load_chunk(s);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  if (n_chunks > 0) widen(0);

  for (int c = 0; c < n_chunks; ++c) {
    // Chunk c + 1 has landed for every thread; every warp is done with
    // chunk c - 1 (its ring slot, which the copies below reuse, and its
    // plane, which the widening below rewrites) and wrote chunk c's plane.
    cp_async_wait<STAGES - 3>();
    __syncthreads();
    if (c + STAGES - 1 < n_chunks) load_chunk(c + STAGES - 1);
    cp_async_commit();
    if (c + 1 < n_chunks) widen(c + 1);

    const uint8_t* st = smem + (c % STAGES) * T::kStage;
    const auto* xs = reinterpret_cast<const __nv_bfloat16*>(st + T::kRaw);
    const __nv_bfloat16* plane = planes + (c & 1) * T::kPlane;
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(a[i], xs + (rb + 16 * i + (lane & 15)) * kXLD + ks * 16 +
                              (lane >> 4) * 8);
#pragma unroll
      for (int bp = 0; bp < NT / 2; ++bp) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, plane + (ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * kWLD +
                   cb + bp * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(part[i][2 * bp], a[i], b[0], b[1]);
          mma_bf16(part[i][2 * bp + 1], a[i], b[2], b[3]);
        }
      }
    }

    if (c % cpg == cpg - 1) {
      // The group's dots times its scale row, into the accumulator.
      const float* f = reinterpret_cast<const float*>(st + T::kRaw + T::kX);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 s = *reinterpret_cast<const float2*>(f + cb + 8 * j +
                                                          2 * t4);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          acc[i][j][0] += part[i][j][0] * s.x;
          acc[i][j][1] += part[i][j][1] * s.y;
          acc[i][j][2] += part[i][j][2] * s.x;
          acc[i][j][3] += part[i][j][3] * s.y;
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
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
      for (int j = 0; j < NT; ++j) {
        store2(dst + (size_t)m * N, n0 + cb + 8 * j + 2 * t4, N,
               acc[i][j][2 * er], acc[i][j][2 * er + 1]);
      }
    }
}

template <int WARPS_M, int MT, int KC, int STAGES, int MIN_BLOCKS>
int launch_mma(const void* x, const int8_t* w, const float* scales,
               float* dst, int M, int K, int N, int G, int splits,
               int groups_per_split, int vec, cudaStream_t stream) {
  using T = Q8Tile<WARPS_M, MT, KC, STAGES>;
  auto* kernel = q8_mma_kernel<WARPS_M, MT, KC, STAGES, MIN_BLOCKS>;
  static unsigned long long raised = 0;  // devices whose cap is set
  const int err = raise_smem_cap(kernel, T::kSmem, raised);
  if (err != 0) return err;
  dim3 grid((M + T::BM - 1) / T::BM, (N + kBN - 1) / kBN, splits);
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), w, scales, dst, M, K, N, G,
      groups_per_split, vec);
  return 0;
}

// --- f32 x on the CUDA cores -------------------------------------------------

constexpr int kFmaThreads = 256;
constexpr int kFmaBN = 64;      // output columns per block
constexpr int kFmaKC = 32;      // k rows staged per step

template <int BM, int TM, int TN>
__global__ void __launch_bounds__(kFmaThreads) q8_fma_kernel(
    const float* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scales, float* __restrict__ out, int M, int K,
    int N, int G, int groups_per_split) {
  constexpr int THR_N = kFmaBN / TN;
  constexpr int THR_M = BM / TM;
  static_assert(THR_N * THR_M == kFmaThreads, "tile does not match block");
  __shared__ __align__(16) float sX[BM][kFmaKC + 1];  // +1: rows in other banks
  __shared__ __align__(16) float sW[kFmaKC][kFmaBN];

  const int tid = threadIdx.x;
  const int tn = tid % THR_N;
  const int tm = tid / THR_N;
  const int n0 = blockIdx.x * kFmaBN;
  const int m0 = blockIdx.y * BM;
  const int ng = K / G;
  const int g_begin = blockIdx.z * groups_per_split;
  const int g_end = min(ng, g_begin + groups_per_split);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int g = g_begin; g < g_end; ++g) {
    float part[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) part[i][j] = 0.f;

    for (int kc = 0; kc < G; kc += kFmaKC) {
      const int k0 = g * G + kc;
      for (int i = tid; i < BM * kFmaKC; i += kFmaThreads) {
        const int r = i / kFmaKC, c = i % kFmaKC;
        const int m = m0 + r;
        sX[r][c] = m < M ? x[(size_t)m * K + k0 + c] : 0.f;
      }
      for (int i = tid; i < kFmaKC * (kFmaBN / 4); i += kFmaThreads) {
        const int r = i / (kFmaBN / 4), c = i % (kFmaBN / 4);
        const int n = n0 + c * 4;
        const uint32_t q = load_word(w + (size_t)(k0 + r) * N + n, n, N, 0u);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sW[r][c * 4 + e] = static_cast<float>(
              static_cast<int8_t>((q >> (8 * e)) & 0xFFu));
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kFmaKC; ++k) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = sX[tm * TM + i][k];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = sW[k][tn + j * THR_N];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) part[i][j] += a[i] * b[j];
      }
      __syncthreads();
    }
    // The group's raw dot times its scale row, into the f32 accumulator.
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tn + j * THR_N;
      const float s = n < N ? scales[(size_t)g * N + n] : 0.f;
#pragma unroll
      for (int i = 0; i < TM; ++i) acc[i][j] += part[i][j] * s;
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
int launch_fma(const void* x, const int8_t* w, const float* scales,
               float* dst, int M, int K, int N, int G, int splits,
               int groups_per_split, cudaStream_t stream) {
  dim3 grid((N + kFmaBN - 1) / kFmaBN, (M + BM - 1) / BM, splits);
  q8_fma_kernel<BM, TM, TN><<<grid, kFmaThreads, 0, stream>>>(
      static_cast<const float*>(x), w, scales, dst, M, K, N, G,
      groups_per_split);
  return 0;
}

}  // namespace

// dtype of x: 0 = f32 (q8_fma_kernel; tile rows BM 4, 16 or 64, from
// ops/quant.py:_split_k_plan), 1 = bf16 (q8_mma_kernel; BM 16 or 64, from
// ops/quant.py:_q8_plan). ``partial`` holds (splits, M, N) f32 when
// splits > 1 and may be null otherwise. For bf16 x, x and ``scales`` must
// be 16-byte aligned and ``values`` 4-byte aligned. Returns a cudaError_t,
// or -1 for arguments the kernels do not take.
extern "C" int trackie_q8_matmul(const void* x, const void* values,
                                 const void* scales, void* out, void* partial,
                                 int M, int K, int N, int G, int dtype, int BM,
                                 int splits, int groups_per_split,
                                 void* stream) {
  if (M < 1 || N < 1 || G < 32 || G % 32 || K % G || splits < 1 ||
      groups_per_split < 1 || (splits > 1 && partial == nullptr))
    return -1;
  auto s = static_cast<cudaStream_t>(stream);
  auto* w = static_cast<const int8_t*>(values);
  auto* sc = static_cast<const float*>(scales);
  float* dst = static_cast<float*>(splits > 1 ? partial : out);
  const auto addr = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p);
  };
  int status;
  if (dtype == 0 && BM == 4) {
    status = launch_fma<4, 1, 1>(x, w, sc, dst, M, K, N, G, splits,
                                 groups_per_split, s);
  } else if (dtype == 0 && BM == 16) {
    status = launch_fma<16, 1, 4>(x, w, sc, dst, M, K, N, G, splits,
                                  groups_per_split, s);
  } else if (dtype == 0 && BM == 64) {
    status = launch_fma<64, 4, 4>(x, w, sc, dst, M, K, N, G, splits,
                                  groups_per_split, s);
  } else if (dtype == 1 && (BM == 16 || BM == 64)) {
    if (addr(x) % 16 || addr(scales) % 16 || addr(values) % 4) return -1;
    const int vec = row_vec(N, values);
    // The tiles (tools/kernel_times.py and PERF.md have the measurements):
    // decode 16 x 128 in 32-row chunks, 5 stages, four blocks an SM; above
    // M = 16, 64 x 128 in 64-row chunks (half the barriers of 32), 4
    // stages, two blocks an SM, or 32-row chunks where G % 64 != 0.
    if (BM == 16)
      status = launch_mma<1, 1, 32, 5, 4>(x, w, sc, dst, M, K, N, G, splits,
                                          groups_per_split, vec, s);
    else if (G % 64 == 0)
      status = launch_mma<2, 2, 64, 4, 2>(x, w, sc, dst, M, K, N, G, splits,
                                          groups_per_split, vec, s);
    else
      status = launch_mma<2, 2, 32, 5, 2>(x, w, sc, dst, M, K, N, G, splits,
                                          groups_per_split, vec, s);
  } else {
    return -1;
  }
  if (status != 0) return status;
  if (splits > 1)
    launch_sum_splits(dst, static_cast<float*>(out), splits, (size_t)M * N, s);
  return static_cast<int>(cudaGetLastError());
}

