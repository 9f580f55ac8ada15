// W4A8 group-quantized matmul for Hopper (sm_90a).
//
// Replaces trackiellm_tpu/ops/quant.py:q4_matmul_pallas_i8 (its body is
// _q4_kernel_i8). Computes out (M, N) f32 = x (M, K) @ W (K, N), where
//   - x arrives already quantized per (row, group) to int8 (xq), with f32
//     scales sx (M, K/G) and bias-fold terms sxsum = sx * sum(xq) per group
//     (ops/quant.py:quantize_activations_q8, run as torch ops);
//   - W is Q4 packed across the K halves: packed[r, n] holds W[r, n] in the
//     low nibble biased by +8 and W[K/2 + r, n] in the high nibble in two's
//     complement, with f32 group scales (K/G, N).
// Per group g of the low half and its twin in the high half:
//   acc += (dot_lo * sx_lo - 8 * sxsum_lo) * s_lo + dot_hi * sx_hi * s_hi
// with int32 dots (dot_lo over the biased nibbles, dot_hi over the signed
// ones). The TPU kernel keeps the high nibble as q*16 and folds 1/16 into
// its scale; here the nibble is sign-extended to q directly, which is the
// same product up to an exact power-of-two scaling.
//
// What bounds it on the H100: at decode (M = 1) every weight byte is used
// for two multiply-adds, so the kernel is bound by weight bytes (about
// 3.6 GB of packed Q4 per token across Mistral-7B's 32 layers). At prefill
// (M up to 512) the int8 dot products dominate.
//
// Design: one block computes a (BM, BN) output tile and walks the K groups
// it owns; each weight byte is read from device memory once per block of BM
// rows. Each 32-row slice of a group is staged in shared memory: x rows as
// they lie, and the weight nibbles unpacked and transposed so that four
// consecutive k of one column form one 32-bit word for __dp4a. When the
// (M, N) grid alone has too few blocks to fill the card (decode), K is
// split across blocks by whole groups; each split writes its own partial
// (M, N) slice and a second kernel sums the slices in a fixed order, so the
// result is deterministic. wgmma/TMA pipelining is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kKC = 32;       // k rows staged per step (both halves)
constexpr int kPad = 4;       // smem row padding (bytes): conflict-free reads

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads) q4_w4a8_kernel(
    const int8_t* __restrict__ xq, const float* __restrict__ sx,
    const float* __restrict__ sxsum, const uint8_t* __restrict__ packed,
    const float* __restrict__ scales, float* __restrict__ out, int M, int K,
    int N, int G, int groups_per_split) {
  constexpr int THR_N = BN / TN;
  constexpr int THR_M = BM / TM;
  static_assert(THR_N * THR_M == kThreads, "tile does not match block");
  __shared__ __align__(16) int8_t sXlo[BM][kKC + kPad];
  __shared__ __align__(16) int8_t sXhi[BM][kKC + kPad];
  __shared__ __align__(16) int8_t sWlo[BN][kKC + kPad];
  __shared__ __align__(16) int8_t sWhi[BN][kKC + kPad];

  const int tid = threadIdx.x;
  const int tn = tid % THR_N;
  const int tm = tid / THR_N;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int half = K / 2;
  const int ngh = half / G;        // groups per half
  const int ng = K / G;            // groups in all (row length of sx)
  const int g_begin = blockIdx.z * groups_per_split;
  const int g_end = min(ngh, g_begin + groups_per_split);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int g = g_begin; g < g_end; ++g) {
    int dlo[TM][TN], dhi[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) dlo[i][j] = dhi[i][j] = 0;

    for (int kc = 0; kc < G; kc += kKC) {
      const int krow = g * G + kc;  // packed row == k index in the low half
      // x: BM rows x kKC bytes of each half, one 32-bit word per load.
      for (int i = tid; i < BM * (kKC / 4); i += kThreads) {
        const int r = i / (kKC / 4), c = i % (kKC / 4);
        const int m = m0 + r;
        int lo = 0, hi = 0;
        if (m < M) {
          const int8_t* row = xq + (size_t)m * K + krow + c * 4;
          lo = *reinterpret_cast<const int*>(row);
          hi = *reinterpret_cast<const int*>(row + half);
        }
        *reinterpret_cast<int*>(&sXlo[r][c * 4]) = lo;
        *reinterpret_cast<int*>(&sXhi[r][c * 4]) = hi;
      }
      // W: kKC packed rows x BN columns, four columns per load, unpacked
      // and transposed to [column][k].
      for (int i = tid; i < kKC * (BN / 4); i += kThreads) {
        const int r = i / (BN / 4), c = i % (BN / 4);
        const int n = n0 + c * 4;
        uint32_t word = 0x88888888u;  // biased zero / signed zero nibbles
        if (n < N)
          word = *reinterpret_cast<const uint32_t*>(
              packed + (size_t)(krow + r) * N + n);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t b = (word >> (8 * e)) & 0xFFu;
          sWlo[c * 4 + e][r] = static_cast<int8_t>(b & 0x0Fu);
          // high nibble, two's complement: shift it to the top, then
          // arithmetic-shift back down to sign-extend.
          sWhi[c * 4 + e][r] =
              static_cast<int8_t>(static_cast<int8_t>(b & 0xF0u) >> 4);
        }
      }
      __syncthreads();
#pragma unroll
      for (int k4 = 0; k4 < kKC / 4; ++k4) {
        int alo[TM], ahi[TM], blo[TN], bhi[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          alo[i] = *reinterpret_cast<const int*>(&sXlo[tm * TM + i][k4 * 4]);
          ahi[i] = *reinterpret_cast<const int*>(&sXhi[tm * TM + i][k4 * 4]);
        }
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          blo[j] = *reinterpret_cast<const int*>(&sWlo[tn + j * THR_N][k4 * 4]);
          bhi[j] = *reinterpret_cast<const int*>(&sWhi[tn + j * THR_N][k4 * 4]);
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            dlo[i][j] = __dp4a(alo[i], blo[j], dlo[i][j]);
            dhi[i][j] = __dp4a(ahi[i], bhi[j], dhi[i][j]);
          }
      }
      __syncthreads();
    }
    // Fold the group's int32 dots into the f32 accumulator.
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + tm * TM + i;
      if (m >= M) continue;
      const float sx_lo = sx[(size_t)m * ng + g];
      const float sx_hi = sx[(size_t)m * ng + ngh + g];
      const float sum_lo = sxsum[(size_t)m * ng + g];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + tn + j * THR_N;
        if (n >= N) continue;
        const float s_lo = scales[(size_t)g * N + n];
        const float s_hi = scales[(size_t)(ngh + g) * N + n];
        acc[i][j] += (static_cast<float>(dlo[i][j]) * sx_lo - 8.f * sum_lo) * s_lo;
        acc[i][j] += (static_cast<float>(dhi[i][j]) * sx_hi) * s_hi;
      }
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

// out[i] = sum over s of partial[s][i], in order of s.
__global__ void sum_splits_kernel(const float* __restrict__ partial,
                                  float* __restrict__ out, int splits,
                                  size_t count) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < count;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += partial[(size_t)k * count + i];
    out[i] = s;
  }
}

template <int BM, int BN, int TM, int TN>
void launch(const int8_t* xq, const float* sx, const float* sxsum,
            const uint8_t* packed, const float* scales, float* dst, int M,
            int K, int N, int G, int splits, int groups_per_split,
            cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  q4_w4a8_kernel<BM, BN, TM, TN><<<grid, kThreads, 0, stream>>>(
      xq, sx, sxsum, packed, scales, dst, M, K, N, G, groups_per_split);
}

}  // namespace

// Tile rows BM must be one of 4, 16, 64 (ops/quant.py:_w4a8_plan picks it);
// all tiles are BN = 64 columns wide. ``partial`` holds (splits, M, N) f32
// when splits > 1 and may be null otherwise. Returns a cudaError_t, or -1
// for arguments the kernel does not take.
extern "C" int trackie_q4_w4a8(const void* xq, const void* sx,
                               const void* sxsum, const void* packed,
                               const void* scales, void* out, void* partial,
                               int M, int K, int N, int G, int BM, int splits,
                               int groups_per_split, void* stream) {
  if (M < 1 || N < 4 || N % 4 || G % kKC || K % (2 * G) || splits < 1 ||
      groups_per_split < 1 || (splits > 1 && partial == nullptr))
    return -1;
  auto s = static_cast<cudaStream_t>(stream);
  auto* x = static_cast<const int8_t*>(xq);
  auto* a = static_cast<const float*>(sx);
  auto* b = static_cast<const float*>(sxsum);
  auto* w = static_cast<const uint8_t*>(packed);
  auto* sc = static_cast<const float*>(scales);
  float* dst = static_cast<float*>(splits > 1 ? partial : out);
  switch (BM) {
    case 4:
      launch<4, 64, 1, 1>(x, a, b, w, sc, dst, M, K, N, G, splits,
                          groups_per_split, s);
      break;
    case 16:
      launch<16, 64, 1, 4>(x, a, b, w, sc, dst, M, K, N, G, splits,
                           groups_per_split, s);
      break;
    case 64:
      launch<64, 64, 4, 4>(x, a, b, w, sc, dst, M, K, N, G, splits,
                           groups_per_split, s);
      break;
    default:
      return -1;
  }
  if (splits > 1) {
    const size_t count = (size_t)M * N;
    const int blocks = (int)((count + 255) / 256 < 4096 ? (count + 255) / 256
                                                        : 4096);
    sum_splits_kernel<<<blocks, 256, 0, s>>>(static_cast<const float*>(partial),
                                             static_cast<float*>(out), splits,
                                             count);
  }
  return static_cast<int>(cudaGetLastError());
}
