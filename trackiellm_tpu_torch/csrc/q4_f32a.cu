// Q4 group-quantized matmul with f32 activations for Hopper (sm_90a).
//
// Replaces trackiellm_tpu/ops/quant.py:q4_matmul_pallas (its body is
// _q4_kernel), the route the JAX package takes under TRACKIE_Q4_F32A=1.
// Computes out (M, N) f32 = x (M, K) @ W (K, N), where
//   - x is bf16 or f32 and is widened to f32 as it is read; unlike the
//     W4A8 kernel (q4_w4a8.cu) there is no activation pre-pass and no
//     activation quantization;
//   - W is Q4 packed across the K halves, the layout q4_w4a8.cu reads:
//     packed[r, n] holds W[r, n] + 8 in the low nibble and W[K/2 + r, n] in
//     two's complement in the high nibble, with f32 group scales (K/G, N).
// Per group g of the low half and its twin in the high half:
//   acc += (x_lo . q_lo) * s_lo + (x_hi . q_hi) * s_hi
// with f32 dots over the signed values. The TPU kernel keeps the low nibble
// biased and folds the bias as (x_lo . (q + 8) - 8 * sum(x_lo)) * s_lo, and
// reads the high nibble as 16q with 1/16 folded into its scale. Both folds
// are exact in the math; this kernel unbiases in the unpack instead (one
// subtract and one sign extension per nibble), which spares the f32
// cancellation of the bias fold.
//
// What bounds it on the H100: at decode (M = 1) each packed byte feeds two
// multiply-adds, so the kernel is bound by weight bytes (about 3.6 GB of
// packed Q4 and scales per token over Mistral-7B). At prefill (M up to 512)
// the f32 FMAs on the CUDA cores bound it.
//
// Design: the tiling of q4_w4a8.cu with f32 in place of int8 dp4a. One block
// computes a (BM, 64) output tile and walks the K groups of the low half it
// owns (each with its twin in the high half); each packed byte is read from
// device memory once per block of BM rows. Each 32-row slice is staged in
// shared memory as f32: the x rows of both halves, and the unpacked signed
// nibbles of both halves, so the inner loop is FMAs from shared memory. K is
// split by whole groups when the (M, N) tiles alone do not fill the card, and
// a second kernel sums the splits in a fixed order (deterministic results).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 64;       // output columns per block
constexpr int kKC = 32;       // packed rows staged per step (each half)

template <typename T, int BM, int TM, int TN>
__global__ void __launch_bounds__(kThreads) q4_f32a_kernel(
    const T* __restrict__ x, const uint8_t* __restrict__ packed,
    const float* __restrict__ scales, float* __restrict__ out, int M, int K,
    int N, int G, int groups_per_split) {
  constexpr int THR_N = kBN / TN;
  constexpr int THR_M = BM / TM;
  static_assert(THR_N * THR_M == kThreads, "tile does not match block");
  __shared__ __align__(16) float sXlo[BM][kKC + 1];  // +1: rows in other banks
  __shared__ __align__(16) float sXhi[BM][kKC + 1];
  __shared__ __align__(16) float sWlo[kKC][kBN];
  __shared__ __align__(16) float sWhi[kKC][kBN];

  const int tid = threadIdx.x;
  const int tn = tid % THR_N;
  const int tm = tid / THR_N;
  const int n0 = blockIdx.x * kBN;
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

    for (int kc = 0; kc < G; kc += kKC) {
      const int krow = g * G + kc;  // packed row == k index in the low half
      for (int i = tid; i < BM * kKC; i += kThreads) {
        const int r = i / kKC, c = i % kKC;
        const int m = m0 + r;
        float lo = 0.f, hi = 0.f;
        if (m < M) {
          const T* row = x + (size_t)m * K + krow + c;
          lo = to_f32(row[0]);
          hi = to_f32(row[half]);
        }
        sXlo[r][c] = lo;
        sXhi[r][c] = hi;
      }
      for (int i = tid; i < kKC * (kBN / 4); i += kThreads) {
        const int r = i / (kBN / 4), c = i % (kBN / 4);
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
      for (int k = 0; k < kKC; ++k) {
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

template <typename T, int BM, int TM, int TN>
void launch(const void* x, const uint8_t* packed, const float* scales,
            float* dst, int M, int K, int N, int G, int splits,
            int groups_per_split, cudaStream_t stream) {
  dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM, splits);
  q4_f32a_kernel<T, BM, TM, TN><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), packed, scales, dst, M, K, N, G,
      groups_per_split);
}

template <typename T>
bool launch_rows(int BM, const void* x, const uint8_t* packed,
                 const float* scales, float* dst, int M, int K, int N, int G,
                 int splits, int groups_per_split, cudaStream_t s) {
  switch (BM) {
    case 4:
      launch<T, 4, 1, 1>(x, packed, scales, dst, M, K, N, G, splits,
                         groups_per_split, s);
      return true;
    case 16:
      launch<T, 16, 1, 4>(x, packed, scales, dst, M, K, N, G, splits,
                          groups_per_split, s);
      return true;
    case 64:
      launch<T, 64, 4, 4>(x, packed, scales, dst, M, K, N, G, splits,
                          groups_per_split, s);
      return true;
    default:
      return false;
  }
}

}  // namespace

// dtype of x: 0 = f32, 1 = bf16. Tile rows BM must be one of 4, 16, 64
// (ops/quant.py:_split_k_plan picks it); tiles are 64 columns wide.
// ``partial`` holds (splits, M, N) f32 when splits > 1 and may be null
// otherwise. Returns a cudaError_t, or -1 for arguments the kernel does not
// take.
extern "C" int trackie_q4_f32a(const void* x, const void* packed,
                               const void* scales, void* out, void* partial,
                               int M, int K, int N, int G, int dtype, int BM,
                               int splits, int groups_per_split, void* stream) {
  if (M < 1 || N < 4 || N % 4 || G < kKC || G % kKC || K % (2 * G) ||
      splits < 1 || groups_per_split < 1 || (splits > 1 && partial == nullptr))
    return -1;
  auto s = static_cast<cudaStream_t>(stream);
  auto* w = static_cast<const uint8_t*>(packed);
  auto* sc = static_cast<const float*>(scales);
  float* dst = static_cast<float*>(splits > 1 ? partial : out);
  bool ok;
  if (dtype == 0)
    ok = launch_rows<float>(BM, x, w, sc, dst, M, K, N, G, splits,
                            groups_per_split, s);
  else if (dtype == 1)
    ok = launch_rows<__nv_bfloat16>(BM, x, w, sc, dst, M, K, N, G, splits,
                                    groups_per_split, s);
  else
    ok = false;
  if (!ok) return -1;
  if (splits > 1)
    launch_sum_splits(dst, static_cast<float*>(out), splits, (size_t)M * N, s);
  return static_cast<int>(cudaGetLastError());
}
