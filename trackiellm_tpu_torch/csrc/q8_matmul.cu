// Q8 group-quantized matmul with f32 activations for Hopper (sm_90a).
//
// Replaces trackiellm_tpu/ops/quant.py:q8_matmul_pallas (its body is
// _q8_kernel). Computes out (M, N) f32 = x (M, K) @ W (K, N), where
//   - x is bf16 or f32 and is widened to f32 as it is read, exactly as
//     _q8_kernel casts it; the activations are never quantized;
//   - W is int8 (K, N) with f32 group scales (K/G, N).
// Per K group g, as _q8_kernel computes it:
//   acc += (x[:, g*G:(g+1)*G] . W[g*G:(g+1)*G, :]) * scales[g, :]
// the raw f32 dot over the group's G rows, times the group's scale row, summed
// in f32. The TPU kernel picks the scale row with a one-hot matmul; here the
// scales are indexed directly.
//
// What bounds it on the H100: at decode (M = 1) each weight byte feeds one
// multiply-add, so the kernel is bound by weight bytes: about 7.2 GB of int8
// values and f32 scales per token over Mistral-7B's 32 layers and lm_head,
// twice the Q4 bytes. At prefill (M up to 512) the f32 FMAs on the CUDA cores
// bound it.
//
// Design: one block computes a (BM, 64) output tile and walks the K groups it
// owns; each weight byte is read from device memory once per block of BM
// rows. Each 32-row slice of a group is staged in shared memory as f32: the
// x rows, and the weight rows widened from int8 (four columns per 32-bit
// load), so the inner loop is FMAs from shared memory into a per-group f32
// partial that is scaled into the accumulator at the group's end. When the
// (M, N) tiles alone give too few blocks to fill the card (decode), K is
// split across blocks by whole groups; each split writes its own (M, N)
// slice and a second kernel sums the slices in a fixed order, so the result
// does not depend on scheduling.
//
// Later work: |q| <= 127 and the model hands x over as bf16, so every product
// is exact in bf16 and a tensor-core MMA (bf16 in, f32 accumulate) computes
// the same group dots; that, with TMA-fed pipelining, is a later PR's.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 64;       // output columns per block
constexpr int kKC = 32;       // k rows staged per step

template <typename T, int BM, int TM, int TN>
__global__ void __launch_bounds__(kThreads) q8_matmul_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scales, float* __restrict__ out, int M, int K,
    int N, int G, int groups_per_split) {
  constexpr int THR_N = kBN / TN;
  constexpr int THR_M = BM / TM;
  static_assert(THR_N * THR_M == kThreads, "tile does not match block");
  __shared__ __align__(16) float sX[BM][kKC + 1];  // +1: rows in other banks
  __shared__ __align__(16) float sW[kKC][kBN];

  const int tid = threadIdx.x;
  const int tn = tid % THR_N;
  const int tm = tid / THR_N;
  const int n0 = blockIdx.x * kBN;
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

    for (int kc = 0; kc < G; kc += kKC) {
      const int k0 = g * G + kc;
      for (int i = tid; i < BM * kKC; i += kThreads) {
        const int r = i / kKC, c = i % kKC;
        const int m = m0 + r;
        sX[r][c] = m < M ? to_f32(x[(size_t)m * K + k0 + c]) : 0.f;
      }
      for (int i = tid; i < kKC * (kBN / 4); i += kThreads) {
        const int r = i / (kBN / 4), c = i % (kBN / 4);
        const int n = n0 + c * 4;
        char4 q = make_char4(0, 0, 0, 0);
        if (n < N)
          q = *reinterpret_cast<const char4*>(w + (size_t)(k0 + r) * N + n);
        sW[r][c * 4 + 0] = static_cast<float>(q.x);
        sW[r][c * 4 + 1] = static_cast<float>(q.y);
        sW[r][c * 4 + 2] = static_cast<float>(q.z);
        sW[r][c * 4 + 3] = static_cast<float>(q.w);
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kKC; ++k) {
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

template <typename T, int BM, int TM, int TN>
void launch(const void* x, const int8_t* w, const float* scales, float* dst,
            int M, int K, int N, int G, int splits, int groups_per_split,
            cudaStream_t stream) {
  dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM, splits);
  q8_matmul_kernel<T, BM, TM, TN><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), w, scales, dst, M, K, N, G, groups_per_split);
}

template <typename T>
bool launch_rows(int BM, const void* x, const int8_t* w, const float* scales,
                 float* dst, int M, int K, int N, int G, int splits,
                 int groups_per_split, cudaStream_t s) {
  switch (BM) {
    case 4:
      launch<T, 4, 1, 1>(x, w, scales, dst, M, K, N, G, splits,
                         groups_per_split, s);
      return true;
    case 16:
      launch<T, 16, 1, 4>(x, w, scales, dst, M, K, N, G, splits,
                          groups_per_split, s);
      return true;
    case 64:
      launch<T, 64, 4, 4>(x, w, scales, dst, M, K, N, G, splits,
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
extern "C" int trackie_q8_matmul(const void* x, const void* values,
                                 const void* scales, void* out, void* partial,
                                 int M, int K, int N, int G, int dtype, int BM,
                                 int splits, int groups_per_split,
                                 void* stream) {
  if (M < 1 || N < 4 || N % 4 || G < kKC || G % kKC || K % G || splits < 1 ||
      groups_per_split < 1 || (splits > 1 && partial == nullptr))
    return -1;
  auto s = static_cast<cudaStream_t>(stream);
  auto* w = static_cast<const int8_t*>(values);
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
