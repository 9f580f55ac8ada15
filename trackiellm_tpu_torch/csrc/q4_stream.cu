// Q4 group-quantized matmul with the whole of K streamed per column tile, for
// Hopper (sm_90a).
//
// Replaces trackiellm_tpu/ops/quant.py:q4_matmul_pallas_v2 (its body is
// _q4_stream_kernel). Computes out (M, N) f32 = x (M, K) @ W (K, N), where x
// is f32 or bf16 and W is Q4 packed across the K halves (the layout
// q4_f32a.cu reads), with f32 group scales (K/G, N). The nibbles are
// unbiased as they are unpacked, as the TPU kernel does:
//   lo = (p & 0xF) - 8,   hi = ((p >> 4 & 0xF) ^ 8) - 8
// and per group g: acc += (x_lo . lo) * s_lo[g] + (x_hi . hi) * s_hi[g].
//
// What defines it, as on the TPU: no split-K. One block owns a column tile
// of tile_n columns and streams every packed row of that tile, tile_k rows
// at a time, through a two-slot ring in shared memory: while the block
// unpacks and multiplies chunk i, the copy of chunk i + 1 is in flight
// (cp.async, the counterpart of pltpu.make_async_copy with a semaphore per
// slot). Nothing is carried between blocks, so no second kernel runs.
//
// What bounds it on the H100: at decode (M = 1 or 8) each packed byte feeds
// 2M multiply-adds, so the weight bytes bound it (the Mistral-7B w_gu
// projection is 58.7 MB of packed Q4, 17.5 us at 3.35 TB/s). Without split-K
// the grid is N / tile_n blocks, which for N = 4096 at tile_n = 32 is 128
// blocks on 132 SMs: each block must keep its own copies in flight, which is
// what the ring does, and at such N the time follows the block count (one
// chunk in flight per block). x (M rows of K) is read from device memory
// through L1: the threads of a warp that share a row read the same address.
//
// Threads: 256. Thread t owns one 4-column word (t % (tile_n/4)) and a row
// slice (t / (tile_n/4)); the slices interleave, so a warp reads 128
// contiguous bytes of the staged chunk. Each thread scales its per-group
// partial dots and accumulates them in group order; at the end the slices'
// accumulators are summed in slice order through shared memory. The order of
// every sum is fixed, so the result does not depend on scheduling.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // an H100 block's opt-in shared memory

// MT: rows of x one block computes (1 for M = 1, else 8; grid.y covers M).
template <typename T, int MT>
__global__ void __launch_bounds__(kThreads) q4_stream_kernel(
    const T* __restrict__ x, const uint8_t* __restrict__ packed,
    const float* __restrict__ scales, float* __restrict__ out, int M, int K,
    int N, int G, int tile_k, int tile_n) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int half = K / 2;
  const int ngh = half / G;            // groups per half
  const int n_chunks = half / tile_k;
  const int gpc = tile_k / G;          // groups per chunk
  const int words = tile_n / 4;        // 4-column words per row
  const int slices = kThreads / words; // row slices
  const int tid = threadIdx.x;
  const int word = tid % words;
  const int slice = tid / words;
  const int col0 = blockIdx.x * tile_n;
  const int n = col0 + word * 4;
  const int m0 = blockIdx.y * MT;
  const int chunk_bytes = tile_k * tile_n;
  const int vecs_per_row = tile_n / 16;

  const T* xr[MT];
  bool ok[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    ok[m] = m0 + m < M;
    xr[m] = x + (size_t)(ok[m] ? m0 + m : 0) * K;
  }

  // Chunk c (packed rows [c * tile_k, (c + 1) * tile_k) of this tile) into
  // slot s, 16 bytes per copy.
  auto load_chunk = [&](int c, int s) {
    const uint8_t* src = packed + (size_t)c * tile_k * N + col0;
    uint8_t* dst = smem + s * chunk_bytes;
    for (int i = tid; i < tile_k * vecs_per_row; i += kThreads) {
      const int r = i / vecs_per_row, v = (i % vecs_per_row) * 16;
      cp_async16(dst + r * tile_n + v, src + (size_t)r * N + v);
    }
  };

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[m][e] = 0.f;

  load_chunk(0, 0);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) load_chunk(c + 1, (c + 1) & 1);
    cp_async_commit();  // an empty group on the last chunk keeps the count
    cp_async_wait<1>(); // this thread's copies of chunk c have landed
    __syncthreads();    // and every other thread's
    const uint8_t* buf = smem + (c & 1) * chunk_bytes;
    for (int gl = 0; gl < gpc; ++gl) {
      float plo[MT][4], phi[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) plo[m][e] = phi[m][e] = 0.f;
      for (int r = gl * G + slice; r < (gl + 1) * G; r += slices) {
        const uint32_t w =
            *reinterpret_cast<const uint32_t*>(buf + r * tile_n + word * 4);
        float lo[4], hi[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t b = (w >> (8 * e)) & 0xFFu;
          lo[e] = static_cast<float>(static_cast<int>(b & 0x0Fu) - 8);
          hi[e] = static_cast<float>(
              static_cast<int>(((b >> 4) & 0x0Fu) ^ 8u) - 8);
        }
        const int k = c * tile_k + r;  // k index in the low half
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float xl = ok[m] ? to_f32(xr[m][k]) : 0.f;
          const float xh = ok[m] ? to_f32(xr[m][half + k]) : 0.f;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            plo[m][e] += xl * lo[e];
            phi[m][e] += xh * hi[e];
          }
        }
      }
      const int g = c * gpc + gl;
      const float4 slo =
          *reinterpret_cast<const float4*>(scales + (size_t)g * N + n);
      const float4 shi =
          *reinterpret_cast<const float4*>(scales + (size_t)(ngh + g) * N + n);
      const float sl[4] = {slo.x, slo.y, slo.z, slo.w};
      const float sh[4] = {shi.x, shi.y, shi.z, shi.w};
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[m][e] += plo[m][e] * sl[e] + phi[m][e] * sh[e];
    }
    __syncthreads();  // the next iteration refills slot c & 1
  }
  cp_async_wait<0>();

  // Sum the row slices in slice order: red[slice][m][column].
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[(slice * MT + m) * tile_n + word * 4 + e] = acc[m][e];
  __syncthreads();
  for (int i = tid; i < MT * tile_n; i += kThreads) {
    const int m = i / tile_n, col = i % tile_n;
    if (m0 + m >= M) continue;
    float s = 0.f;
    for (int j = 0; j < slices; ++j) s += red[(j * MT + m) * tile_n + col];
    out[(size_t)(m0 + m) * N + col0 + col] = s;
  }
}

template <typename T, int MT>
int launch(const void* x, const uint8_t* packed, const float* scales,
           float* out, int M, int K, int N, int G, int tile_k, int tile_n,
           cudaStream_t stream) {
  const int staging = 2 * tile_k * tile_n;
  const int reduce = (kThreads * 4 / tile_n) * MT * tile_n * 4;
  const int smem = staging > reduce ? staging : reduce;
  auto kernel = q4_stream_kernel<T, MT>;
  // Raise the dynamic shared memory cap once per instantiation and device,
  // to the largest a block may take, so no later call (nor a graph capture)
  // sets it.
  static unsigned long long raised = 0;
  const int err = raise_smem_cap(kernel, kMaxSmem, raised);
  if (err != 0) return err;
  dim3 grid(N / tile_n, (M + MT - 1) / MT);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), packed,
                                           scales, out, M, K, N, G, tile_k,
                                           tile_n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rows(const void* x, const uint8_t* packed, const float* scales,
                float* out, int M, int K, int N, int G, int tile_k,
                int tile_n, cudaStream_t s) {
  if (M == 1)
    return launch<T, 1>(x, packed, scales, out, M, K, N, G, tile_k, tile_n, s);
  return launch<T, 8>(x, packed, scales, out, M, K, N, G, tile_k, tile_n, s);
}

}  // namespace

// dtype of x: 0 = f32, 1 = bf16. tile_n is a power of two in [16, 1024]
// dividing N; tile_k divides K/2 and is a multiple of G; the two staging
// slots (2 * tile_k * tile_n bytes) fit an H100 block's shared memory.
// packed, scales and out must be 16-byte aligned. Returns a cudaError_t, or
// -1 for arguments the kernel does not take.
extern "C" int trackie_q4_stream(const void* x, const void* packed,
                                 const void* scales, void* out, int M, int K,
                                 int N, int G, int dtype, int tile_k,
                                 int tile_n, void* stream) {
  const int half = K / 2;
  if (M < 1 || K < 2 || K % 2 || G < 1 || tile_k < G || tile_k % G ||
      half % tile_k || tile_n < 16 || tile_n > 1024 ||
      (tile_n & (tile_n - 1)) || N % tile_n ||
      2LL * tile_k * tile_n > kMaxSmem)
    return -1;
  auto s = static_cast<cudaStream_t>(stream);
  auto* w = static_cast<const uint8_t*>(packed);
  auto* sc = static_cast<const float*>(scales);
  auto* o = static_cast<float*>(out);
  if (dtype == 0)
    return launch_rows<float>(x, w, sc, o, M, K, N, G, tile_k, tile_n, s);
  if (dtype == 1)
    return launch_rows<__nv_bfloat16>(x, w, sc, o, M, K, N, G, tile_k, tile_n,
                                      s);
  return -1;
}
