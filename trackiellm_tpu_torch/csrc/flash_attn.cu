// Causal GQA flash attention (prefill) for Hopper (sm_90a).
//
// Replaces trackiellm_tpu/ops/attention.py:flash_attention (its bodies are
// _flash_kernel and _flash_kernel_sinks). q (H, S, D), k and v (Hk, S, D),
// bf16 or f32; out (H, S, D) in q's type. Query head h reads kv head
// h / (H / Hk). Scores are (q . k) * scale, optionally tanh soft-capped,
// masked causally (key <= query) and to a sliding window (key > query -
// window) with -1e30; the online softmax runs in f32. With sinks, one extra
// per-head logit joins the softmax at the end and is dropped after.
//
// What bounds it on the H100: at the prefill buckets (S = 256, 512) the
// work is small (4 * H * S^2 * D / 2 flops with the causal skip), and this
// first kernel runs on the f32 CUDA cores, so shared-memory reads feeding
// the FMAs bound it. Nothing of size S x S ever reaches device memory.
//
// Design: one block per (head, 64-query tile); two threads share a query
// row, each holding half of q and of the output accumulator in registers,
// and combine their half dot products with one shuffle. K and V advance in
// 32-key tiles staged in shared memory as f32; tiles wholly above the
// diagonal, or wholly outside the window, are skipped, as on the TPU. Each
// tile's scores stay in registers: one max, one rescale of the
// accumulator per tile. wgmma/TMA (an FA3-style kernel) is later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;           // query rows per block
constexpr int kBK = 32;           // keys per tile
constexpr int kThreads = 2 * kBQ;
constexpr float kNegInf = -1e30f;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ sinks, T* __restrict__ out, int H, int Hk,
    int S, float scale, int causal, int window, float softcap) {
  constexpr int DH = D / 2;                 // dims per thread
  constexpr int kHalf = kBK * DH + 4;       // +4 floats: the two halves of a
                                            // row fall in different banks
  __shared__ __align__(16) float sK[2 * kHalf];
  __shared__ __align__(16) float sV[2 * kHalf];

  const int h = blockIdx.y;
  const int qt = blockIdx.x;
  const int kvh = h / (H / Hk);
  const int tid = threadIdx.x;
  const int row = tid >> 1;
  const int part = tid & 1;
  const int qi = qt * kBQ + row;

  float qr[DH], acc[DH];
  const T* qp = q + ((size_t)h * S + qi) * D + part * DH;
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qr[d] = to_f32(qp[d]);
    acc[d] = 0.f;
  }
  float m_run = kNegInf, l_run = 0.f;

  // Tile range this block needs (same skip rule as the TPU kernel).
  const int q_lo = qt * kBQ, q_hi = qt * kBQ + kBQ - 1;
  const int n_tiles = S / kBK;
  int kt_end = n_tiles;
  int kt_begin = 0;
  if (causal) {
    kt_end = min(n_tiles, q_hi / kBK + 1);
    if (window > 0) {
      // first tile whose last key is > q_lo - window
      const int first_key = q_lo - window + 1;
      kt_begin = first_key > 0 ? first_key / kBK : 0;
    }
  }

  const T* kbase = k + (size_t)kvh * S * D;
  const T* vbase = v + (size_t)kvh * S * D;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    __syncthreads();  // previous tile fully consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int j = i / D, d = i % D;
      const int p = d / DH, dd = d % DH;
      const size_t src = ((size_t)kt * kBK + j) * D + d;
      sK[p * kHalf + j * DH + dd] = to_f32(kbase[src]);
      sV[p * kHalf + j * DH + dd] = to_f32(vbase[src]);
    }
    __syncthreads();

    const float* kh = sK + part * kHalf;
    const float* vh = sV + part * kHalf;
    float sc[kBK];
    float m_tile = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(kh + j * DH);
      float s = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < DH / 4; ++d4) {
        const float4 kv = kr[d4];
        s += qr[4 * d4] * kv.x + qr[4 * d4 + 1] * kv.y +
             qr[4 * d4 + 2] * kv.z + qr[4 * d4 + 3] * kv.w;
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s *= scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      if (causal) {
        const int key = kt * kBK + j;
        bool ok = key <= qi;
        if (window > 0) ok = ok && key > qi - window;
        if (!ok) s = kNegInf;
      }
      sc[j] = s;
      m_tile = fmaxf(m_tile, s);
    }
    const float m_new = fmaxf(m_run, m_tile);
    const float alpha = expf(m_run - m_new);
    float l_tile = 0.f;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      sc[j] = expf(sc[j] - m_new);
      l_tile += sc[j];
    }
    l_run = l_run * alpha + l_tile;
    m_run = m_new;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float4* vr = reinterpret_cast<const float4*>(vh + j * DH);
      const float p = sc[j];
#pragma unroll
      for (int d4 = 0; d4 < DH / 4; ++d4) {
        const float4 vv = vr[d4];
        acc[4 * d4] += p * vv.x;
        acc[4 * d4 + 1] += p * vv.y;
        acc[4 * d4 + 2] += p * vv.z;
        acc[4 * d4 + 3] += p * vv.w;
      }
    }
  }

  float denom = l_run;
  if (sinks != nullptr) {
    const float sink = sinks[h];
    const float m_tot = fmaxf(m_run, sink);
    const float alpha = expf(m_run - m_tot);
    denom = denom * alpha + expf(sink - m_tot);
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= alpha;
  }
  const float inv = 1.f / fmaxf(denom, 1e-30f);
  T* op = out + ((size_t)h * S + qi) * D + part * DH;
#pragma unroll
  for (int d = 0; d < DH; ++d) store(op + d, acc[d] * inv);
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, const float* sinks,
            void* out, int H, int Hk, int S, float scale, int causal,
            int window, float softcap, cudaStream_t stream) {
  dim3 grid(S / kBQ, H);
  flash_fwd_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), sinks, static_cast<T*>(out), H, Hk, S, scale,
      causal, window, softcap);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. sinks: (H,) f32 or null. scale: the final score
// scale (the wrapper resolves 0 to 1/sqrt(D)). Returns a cudaError_t, or -1
// for arguments the kernel does not take.
extern "C" int trackie_flash_attn(const void* q, const void* k, const void* v,
                                  const void* sinks, void* out, int H, int Hk,
                                  int S, int D, int dtype, float scale,
                                  int causal, int window, float softcap,
                                  void* stream) {
  if (H < 1 || Hk < 1 || H % Hk || S < kBQ || S % kBQ) return -1;
  auto s = static_cast<cudaStream_t>(stream);
  auto* sk = static_cast<const float*>(sinks);
  if (dtype == 0 && D == 64)
    launch<float, 64>(q, k, v, sk, out, H, Hk, S, scale, causal, window,
                      softcap, s);
  else if (dtype == 0 && D == 128)
    launch<float, 128>(q, k, v, sk, out, H, Hk, S, scale, causal, window,
                       softcap, s);
  else if (dtype == 1 && D == 64)
    launch<__nv_bfloat16, 64>(q, k, v, sk, out, H, Hk, S, scale, causal,
                              window, softcap, s);
  else if (dtype == 1 && D == 128)
    launch<__nv_bfloat16, 128>(q, k, v, sk, out, H, Hk, S, scale, causal,
                               window, softcap, s);
  else
    return -1;
  return static_cast<int>(cudaGetLastError());
}
