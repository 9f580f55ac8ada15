// One-launch Q4 decode MLP block for Hopper (sm_90a).
//
// Replaces trackiellm_tpu/ops/fused.py:fused_mlp_q4_pallas (its body is
// _fused_mlp_kernel), the route the JAX package takes under
// TRACKIE_FUSED_MLP=1 for M <= 8. Computes, for x (M, D) in bf16 or f32:
//   h2  = x * rsqrt(mean(x^2) + eps) * norm          (f32)
//   gu  = h2 @ W_gu                                   (M, 2H) f32
//   act = silu(gu[:, :H]) * gu[:, H:]                 (f32, never rounded)
//   out = (x + act @ W_down) cast to x's dtype once
// with W_gu Q4 (D, 2H) and W_down Q4 (H, D) in the layout of q4_w4a8.cu
// (packed across the K halves, low nibble biased by +8, high nibble in two's
// complement, f32 group scales). As in fused_mlp_xla, each weight is
// dequantized to q * scale in f32 and the products are f32 dots.
//
// What bounds it on the H100: at decode every weight byte feeds at most M
// multiply-adds, so the block is bound by its weight bytes: 88 MB of packed
// W_gu and W_down for one Mistral-7B layer (D 4096, H 14336), plus 2.3 MB of
// scales. Its aim is one launch where the unfused path takes the two W4A8
// matmuls, their activation pre-passes and the glue between them.
//
// Design: the TPU kernel walks 28 hidden-pair tiles of width G in order and
// carries the (M, D) sum in VMEM. Here the hidden pairs are cut into tiles
// of 32 rows of W_down, so Mistral gets 224 blocks, enough to fill the 132
// SMs. Block b owns hidden units [32b, 32b + 32) and [H/2 + 32b, ...): the
// low and high nibbles of W_down's packed rows [32b, 32b + 32). It
//   1. recomputes the row norms of its (M, D) input (cheap) and streams the
//      normalised x through shared memory in 32-row slices of both halves of
//      D, while each of its 128 threads computes one of the block's 128 gate
//      and up columns over the whole of D;
//   2. applies silu(gate) * up in f32 to its 64 hidden units;
//   3. multiplies them by its 32 packed rows of W_down, reading each byte of
//      W_down once in the whole launch, and writes an (M, D) f32 partial.
// After a grid-wide barrier (cooperative launch: every block is resident)
// each block sums a slice of the partials over all blocks in a fixed order,
// adds the residual, and casts once, so the result does not depend on
// scheduling.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTH = 32;            // packed W_down rows (hidden pairs) a block
constexpr int kThreads = 4 * kTH;  // one thread per gate/up column
constexpr int kKC = 32;            // packed W_gu rows staged per step
constexpr int kMaxM = 8;

__device__ __forceinline__ float nib_lo(uint32_t b) {
  return static_cast<float>(static_cast<int>(b & 0x0Fu) - 8);
}
__device__ __forceinline__ float nib_hi(uint32_t b) {
  return static_cast<float>(static_cast<int8_t>(b & 0xF0u) >> 4);
}

template <typename TX, typename TN>
__global__ void __launch_bounds__(kThreads) fused_mlp_q4_kernel(
    const TX* __restrict__ x, const TN* __restrict__ norm,
    const uint8_t* __restrict__ gu, const float* __restrict__ gu_scales,
    const uint8_t* __restrict__ down, const float* __restrict__ down_scales,
    float* __restrict__ partial, TX* __restrict__ out, int M, int D, int H,
    int G, float eps) {
  __shared__ float sInv[kMaxM];
  __shared__ float sSum[kThreads / 32][kMaxM];
  __shared__ float sHlo[kMaxM][kKC];
  __shared__ float sHhi[kMaxM][kKC];
  __shared__ float sGU[kThreads][kMaxM + 1];
  __shared__ float sAct[kMaxM][2 * kTH];

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int r0 = blockIdx.x * kTH;   // first packed W_down row of the block
  const int half_d = D / 2;
  const int half_h = H / 2;
  const int two_h = 2 * H;

  // 1a. Row norms: mean of x^2 over D, per row.
  float ss[kMaxM];
#pragma unroll
  for (int m = 0; m < kMaxM; ++m) ss[m] = 0.f;
  for (int d = tid; d < D; d += kThreads) {
#pragma unroll
    for (int m = 0; m < kMaxM; ++m)
      if (m < M) {
        const float v = to_f32(x[(size_t)m * D + d]);
        ss[m] += v * v;
      }
  }
#pragma unroll
  for (int m = 0; m < kMaxM; ++m) {
    float v = ss[m];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) sSum[warp][m] = v;
  }
  __syncthreads();
  if (tid < M) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += sSum[w][tid];
    sInv[tid] = 1.f / sqrtf(total / static_cast<float>(D) + eps);
  }
  __syncthreads();

  // 1b. Gate/up: warp q/32 takes gate-lo, gate-hi, up-lo, up-hi in turn, so
  // thread q owns column col of W_gu (D/2 packed rows, 2H columns).
  const int grp = tid / kTH, j = tid % kTH;
  const int col = (grp & 1) * half_h + (grp >> 1) * H + r0 + j;
  float acc[kMaxM];
#pragma unroll
  for (int m = 0; m < kMaxM; ++m) acc[m] = 0.f;
  const int ngh = half_d / G;        // W_gu scale rows per half
  for (int p0 = 0; p0 < half_d; p0 += kKC) {
    for (int i = tid; i < M * kKC; i += kThreads) {
      const int m = i / kKC, c = i % kKC;
      const int d = p0 + c;
      sHlo[m][c] = to_f32(x[(size_t)m * D + d]) * sInv[m] * to_f32(norm[d]);
      sHhi[m][c] = to_f32(x[(size_t)m * D + half_d + d]) * sInv[m] *
                   to_f32(norm[half_d + d]);
    }
    __syncthreads();
    const int g = p0 / G;            // a slice never straddles two groups
    const float s_lo = gu_scales[(size_t)g * two_h + col];
    const float s_hi = gu_scales[(size_t)(ngh + g) * two_h + col];
    const uint8_t* wp = gu + (size_t)p0 * two_h + col;
#pragma unroll 8
    for (int c = 0; c < kKC; ++c) {
      const uint32_t b = wp[(size_t)c * two_h];
      const float w_lo = nib_lo(b) * s_lo;
      const float w_hi = nib_hi(b) * s_hi;
#pragma unroll
      for (int m = 0; m < kMaxM; ++m)
        if (m < M) acc[m] += sHlo[m][c] * w_lo + sHhi[m][c] * w_hi;
    }
    __syncthreads();
  }
#pragma unroll
  for (int m = 0; m < kMaxM; ++m) sGU[tid][m] = acc[m];
  __syncthreads();

  // 2. silu(gate) * up for the block's 2 * kTH hidden units, in f32:
  // unit u < kTH is hidden r0 + u, unit kTH + u is hidden H/2 + r0 + u.
  for (int i = tid; i < M * 2 * kTH; i += kThreads) {
    const int m = i / (2 * kTH), u = i % (2 * kTH);
    const float gate = sGU[u][m];             // gate-lo, then gate-hi
    const float up = sGU[2 * kTH + u][m];     // up-lo, then up-hi
    sAct[m][u] = gate * (1.f / (1.f + expf(-gate))) * up;
  }
  __syncthreads();

  // 3. The block's rows of W_down: four columns per thread per step; the
  // pair tile lies in one scale group (kTH divides G).
  const size_t srow_lo = (size_t)(r0 / G) * D;
  const size_t srow_hi = (size_t)((half_h + r0) / G) * D;
  float* part = partial + (size_t)blockIdx.x * M * D;
  for (int n = 4 * tid; n < D; n += 4 * kThreads) {
    float s_lo[4], s_hi[4], o[kMaxM][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s_lo[e] = down_scales[srow_lo + n + e];
      s_hi[e] = down_scales[srow_hi + n + e];
    }
#pragma unroll
    for (int m = 0; m < kMaxM; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[m][e] = 0.f;
#pragma unroll 4
    for (int r = 0; r < kTH; ++r) {
      const uint32_t word = *reinterpret_cast<const uint32_t*>(
          down + (size_t)(r0 + r) * D + n);
      float w_lo[4], w_hi[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t b = (word >> (8 * e)) & 0xFFu;
        w_lo[e] = nib_lo(b) * s_lo[e];
        w_hi[e] = nib_hi(b) * s_hi[e];
      }
#pragma unroll
      for (int m = 0; m < kMaxM; ++m)
        if (m < M) {
          const float a_lo = sAct[m][r], a_hi = sAct[m][kTH + r];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[m][e] += a_lo * w_lo[e] + a_hi * w_hi[e];
        }
    }
#pragma unroll
    for (int m = 0; m < kMaxM; ++m)
      if (m < M)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[(size_t)m * D + n + e] = o[m][e];
  }

  // 4. Every partial is written: sum them in block order, add the residual,
  // cast once.
  __threadfence();
  cg::this_grid().sync();
  const int total = M * D;
  const int per_block = (total + gridDim.x - 1) / gridDim.x;
  const int begin = blockIdx.x * per_block;
  const int end = min(total, begin + per_block);
  for (int i = begin + tid; i < end; i += kThreads) {
    float s = 0.f;
    for (int b = 0; b < (int)gridDim.x; ++b)
      s += partial[(size_t)b * total + i];
    store(out + i, to_f32(x[i]) + s);
  }
}

template <typename TX, typename TN>
int launch(const void* x, const void* norm, const uint8_t* gu,
           const float* gu_scales, const uint8_t* down,
           const float* down_scales, float* partial, void* out, int M, int D,
           int H, int G, float eps, cudaStream_t stream) {
  auto kernel = fused_mlp_q4_kernel<TX, TN>;
  const int blocks = (H / 2) / kTH;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  // The grid-wide barrier needs every block resident at once.
  if (per_sm * sms < blocks) return -1;
  const TX* xp = static_cast<const TX*>(x);
  const TN* np = static_cast<const TN*>(norm);
  TX* op = static_cast<TX*>(out);
  void* args[] = {&xp, &np, &gu, &gu_scales, &down, &down_scales, &partial,
                  &op, &M, &D, &H, &G, &eps};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      (void*)kernel, dim3(blocks), dim3(kThreads), args, 0, stream));
}

}  // namespace

// x (M, D) and out (M, D) share x_dtype, norm (D,) has norm_dtype (0 = f32,
// 1 = bf16); gu (D/2, 2H) u8 + gu_scales (D/G, 2H) f32; down (H/2, D) u8 +
// down_scales (H/G, D) f32; partial holds ((H/2)/32, M, D) f32. Returns a
// cudaError_t, or -1 for arguments the kernel does not take (including a
// grid that cannot be resident all at once).
extern "C" int trackie_fused_mlp_q4(const void* x, const void* norm,
                                    const void* gu, const void* gu_scales,
                                    const void* down, const void* down_scales,
                                    void* partial, void* out, int M, int D,
                                    int H, int G, int x_dtype, int norm_dtype,
                                    float eps, void* stream) {
  if (M < 1 || M > kMaxM || D < 8 || D % 8 || H % 2 || (H / 2) % kTH ||
      G < kKC || G % kKC || G % kTH || (D / 2) % G || (H / 2) % G)
    return -1;
  auto s = static_cast<cudaStream_t>(stream);
  auto* g = static_cast<const uint8_t*>(gu);
  auto* gs = static_cast<const float*>(gu_scales);
  auto* dn = static_cast<const uint8_t*>(down);
  auto* ds = static_cast<const float*>(down_scales);
  auto* p = static_cast<float*>(partial);
  if (x_dtype == 0 && norm_dtype == 0)
    return launch<float, float>(x, norm, g, gs, dn, ds, p, out, M, D, H, G,
                                eps, s);
  if (x_dtype == 0 && norm_dtype == 1)
    return launch<float, __nv_bfloat16>(x, norm, g, gs, dn, ds, p, out, M, D,
                                        H, G, eps, s);
  if (x_dtype == 1 && norm_dtype == 0)
    return launch<__nv_bfloat16, float>(x, norm, g, gs, dn, ds, p, out, M, D,
                                        H, G, eps, s);
  if (x_dtype == 1 && norm_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, norm, g, gs, dn, ds, p, out,
                                                M, D, H, G, eps, s);
  return -1;
}
