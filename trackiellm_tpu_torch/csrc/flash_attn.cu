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
// bytes of q, k, v and out (10.5 MB at H = 32, Hk = 8, D = 128, S = 512:
// 3.1 us at 3.35 TB/s) outweigh the causal products (2.2 GFLOP: 2.2 us at
// the 989 TFLOP/s bf16 peak). Nothing of size S x S reaches device memory.
//
// Two kernels, chosen by dtype:
//
// bf16 (flash_mma_kernel, the model's path): FA2-shaped on the tensor cores,
// mma.sync.m16n8k16 bf16 with f32 accumulators. One block of 4 warps per
// (head, 64-query tile); each warp owns 16 query rows, whose q fragments are
// loaded once through ldmatrix. K and V advance in 64-key tiles through a
// two-stage cp.async ring in shared memory, rows padded by 16 bytes so that
// ldmatrix is free of bank conflicts. S = Q K^T takes K as the "col" operand
// as it lies (D-contiguous); scale, softcap and the masks act on the f32
// accumulator fragment, and each row's max and sum reduce across the 4
// lanes that hold it with two shuffles. P is rounded to bf16 in registers
// and reused as the A fragment of P V (it never touches shared memory); V
// reaches the B operand through ldmatrix.trans. The row sum l adds the f32
// P. Tiles wholly above the diagonal or wholly before the window are
// skipped (ops/attention.py:_tile_range with 64-key tiles). A block serves
// one query head: the rep = H / Hk heads of one kv head read the same K/V
// tiles from L2, not from one shared-memory copy.
//
// f32 (flash_fwd_kernel, first kernel of the port, kept for its 1e-5
// tolerance): one block per (head, 64-query tile); two threads share a
// query row, each holding half of q and of the output accumulator in
// registers, and combine their half dot products with one shuffle. K and V
// advance in 32-key tiles staged in shared memory as f32, with the same
// tile skips. Each tile's scores stay in registers: one max, one rescale of
// the accumulator per tile.

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

// --- bf16 on the tensor cores -----------------------------------------------

constexpr int kMmaBQ = 64;        // query rows per block, 16 per warp
constexpr int kMmaBK = 64;        // keys per tile
constexpr int kMmaThreads = 128;

// Two f32 as one bf16x2 word, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int D>
constexpr int mma_smem_bytes() {
  return 5 * kMmaBQ * (D + 8) * 2;  // q, then two stages of k and of v
}

// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4): A holds rows
// g and g + 8, columns 2t, 2t + 1 (+8); B holds k = 2t, 2t + 1 (+8) of
// column g; the f32 accumulator holds rows g and g + 8, columns 2t, 2t + 1.
template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ sinks,
    __nv_bfloat16* __restrict__ out, int H, int Hk, int S, float scale,
    int causal, int window, float softcap) {
  constexpr int LD = D + 8;            // smem row, elements (+16 bytes)
  constexpr int TILE = kMmaBQ * LD;    // elements of one 64-row tile
  constexpr int CPR = D / 8;           // 16-byte chunks per row
  constexpr int NS = kMmaBK / 8;       // n8 tiles of the scores
  constexpr int NO = D / 8;            // n8 tiles of the output
  extern __shared__ __align__(16) unsigned char flash_smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(flash_smem);
  __nv_bfloat16* sK = sQ + TILE;       // [2][64][LD]
  __nv_bfloat16* sV = sK + 2 * TILE;   // [2][64][LD]

  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kMmaBQ;
  const int kvh = h / (H / Hk);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // Tile range this block needs (ops/attention.py:_tile_range).
  const int n_tiles = S / kMmaBK;
  int kt_begin = 0, kt_end = n_tiles;
  if (causal) {
    kt_end = min(n_tiles, (q0 + kMmaBQ - 1) / kMmaBK + 1);
    if (window > 0) {
      const int first_key = q0 - window + 1;
      kt_begin = first_key > 0 ? first_key / kMmaBK : 0;
    }
  }

  const __nv_bfloat16* qb = q + ((size_t)h * S + q0) * D;
  const __nv_bfloat16* kb = k + (size_t)kvh * S * D;
  const __nv_bfloat16* vb = v + (size_t)kvh * S * D;
  for (int i = tid; i < kMmaBQ * CPR; i += kMmaThreads) {
    const int r = i / CPR, c = i % CPR;
    cp_async16(sQ + r * LD + c * 8, qb + (size_t)r * D + c * 8);
  }
  auto load_kv = [&](int kt, int stage) {
    const size_t base = (size_t)kt * kMmaBK * D;
    for (int i = tid; i < kMmaBK * CPR; i += kMmaThreads) {
      const int r = i / CPR, c = i % CPR;
      cp_async16(sK + stage * TILE + r * LD + c * 8, kb + base + r * D + c * 8);
      cp_async16(sV + stage * TILE + r * LD + c * 8, vb + base + r * D + c * 8);
    }
  };
  load_kv(kt_begin, 0);
  cp_async_commit();

  uint32_t qf[D / 16][4];
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0, row0 + 8

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) load_kv(kt + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: tile kt (and q) landed
    __syncthreads();
    if (kt == kt_begin) {
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        ldmatrix_x4(qf[ks], sQ + (warp * 16 + (lane & 15)) * LD + ks * 16 +
                                (lane >> 4) * 8);
    }
    const __nv_bfloat16* sk = sK + stage * TILE;
    const __nv_bfloat16* sv = sV + stage * TILE;

    // S = Q K^T (16 x 64 per warp), f32.
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, sk + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD +
                           ks * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[ks], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[ks], b[2], b[3]);
      }
    }

    // Scale, softcap, masks; the rows' max over the tile.
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        if (causal) {
          const int key = kt * kMmaBK + j * 8 + 2 * t + (e & 1);
          const int qi = row0 + 8 * (e >> 1);
          bool ok = key <= qi;
          if (window > 0) ok = ok && key > qi - window;
          if (!ok) x = kNegInf;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = expf(m_run[r] - m_new);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m_run[e >> 1]);
        rs[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l_run[r] = l_run[r] * alpha[r] + rs[r];
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P V: P in bf16 as the A fragment, V through ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, sv + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                   dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], a, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is free for the copies of tile kt + 2
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float denom = l_run[r];
    if (sinks != nullptr) {
      const float sink = sinks[h];
      const float m_tot = fmaxf(m_run[r], sink);
      const float a = expf(m_run[r] - m_tot);
      denom = denom * a + expf(sink - m_tot);
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        o[j][2 * r] *= a;
        o[j][2 * r + 1] *= a;
      }
    }
    inv[r] = 1.f / fmaxf(denom, 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    __nv_bfloat16* op = out + ((size_t)h * S + row0 + 8 * r) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + j * 8) = __floats2bfloat162_rn(
          o[j][2 * r] * inv[r], o[j][2 * r + 1] * inv[r]);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v,
               const float* sinks, void* out, int H, int Hk, int S,
               float scale, int causal, int window, float softcap,
               cudaStream_t stream) {
  if (S % kMmaBK) return -1;
  constexpr int bytes = mma_smem_bytes<D>();
  static unsigned long long raised = 0;  // devices whose cap is set
  const int err = raise_smem_cap(flash_mma_kernel<D>, bytes, raised);
  if (err != 0) return err;
  dim3 grid(S / kMmaBQ, H);
  flash_mma_kernel<D><<<grid, kMmaThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), sinks,
      static_cast<__nv_bfloat16*>(out), H, Hk, S, scale, causal, window,
      softcap);
  return 0;
}

}  // namespace

// dtype: 0 = f32 (flash_fwd_kernel), 1 = bf16 (flash_mma_kernel). sinks:
// (H,) f32 or null. scale: the final score scale (the wrapper resolves 0 to
// 1/sqrt(D)). Returns a cudaError_t, or -1 for arguments the kernel does not
// take.
extern "C" int trackie_flash_attn(const void* q, const void* k, const void* v,
                                  const void* sinks, void* out, int H, int Hk,
                                  int S, int D, int dtype, float scale,
                                  int causal, int window, float softcap,
                                  void* stream) {
  if (H < 1 || Hk < 1 || H % Hk || S < kBQ || S % kBQ) return -1;
  auto s = static_cast<cudaStream_t>(stream);
  auto* sk = static_cast<const float*>(sinks);
  int status = 0;
  if (dtype == 0 && D == 64)
    launch<float, 64>(q, k, v, sk, out, H, Hk, S, scale, causal, window,
                      softcap, s);
  else if (dtype == 0 && D == 128)
    launch<float, 128>(q, k, v, sk, out, H, Hk, S, scale, causal, window,
                       softcap, s);
  else if (dtype == 1 && D == 64)
    status = launch_mma<64>(q, k, v, sk, out, H, Hk, S, scale, causal,
                            window, softcap, s);
  else if (dtype == 1 && D == 128)
    status = launch_mma<128>(q, k, v, sk, out, H, Hk, S, scale, causal,
                             window, softcap, s);
  else
    return -1;
  if (status != 0) return status;
  return static_cast<int>(cudaGetLastError());
}
