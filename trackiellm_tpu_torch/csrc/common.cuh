// Pieces shared by the kernels in this directory.
//
// Each .cu file includes this header and gets its own copy: everything here
// lives in an anonymous namespace, so the shared library links without
// duplicate symbols.

#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// --- cp.async, ldmatrix and the bf16 mma.sync ------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16-byte copy into shared memory; src_bytes 0 fills the destination with
// zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// d += a b on the tensor cores, bf16 in, f32 accumulate. Fragment layouts
// of m16n8k16 (g = lane / 4, t = lane % 4): A holds rows g and g + 8,
// columns 2t, 2t + 1 (+8); B holds k = 2t, 2t + 1 (+8) of column g; the f32
// accumulator holds rows g and g + 8, columns 2t, 2t + 1.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// --- Q4 nibbles --------------------------------------------------------------

// The Q4 layout of q4_w4a8.cu holds two weights a byte: the low nibble q + 8,
// the high nibble q in two's complement. q4_unpack4 widens the four bytes of
// a word to their eight weights as exact floats with no conversion
// instruction: u = q + 8 is a nibble (the high one with its sign bit
// flipped), the float with bits 0x4B0000uu is 2^23 + u (one byte permute),
// and less 2^23 + 8 it is q. lo[e] and hi[e] come from byte e.
__device__ __forceinline__ void q4_unpack4(uint32_t w, float (&lo)[4],
                                           float (&hi)[4]) {
  const uint32_t ul = w & 0x0F0F0F0Fu;
  const uint32_t uh = ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
  const float bias = 8388616.f;  // 2^23 + 8
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    lo[e] = __uint_as_float(__byte_perm(ul, 0x4B000000u, 0x7540 + e)) - bias;
    hi[e] = __uint_as_float(__byte_perm(uh, 0x4B000000u, 0x7540 + e)) - bias;
  }
}

// --- small helpers -----------------------------------------------------------

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// out[i] = sum over s of partial[s][i], in order of s. A product split over
// K writes one (M, N) slice per split; summing the slices here, in a fixed
// order, keeps the result independent of block scheduling.
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

inline void launch_sum_splits(const float* partial, float* out, int splits,
                              size_t count, cudaStream_t stream) {
  const size_t blocks = (count + 255) / 256;
  sum_splits_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
      partial, out, splits, count);
}

// Raises `kernel`'s dynamic shared-memory cap to `bytes` on the current
// device. The cap is a per-device attribute, so `raised` (one per kernel,
// kept by the caller) records the devices already done, and a later call on
// one of them costs only cudaGetDevice. Returns a cudaError_t.
template <typename Kernel>
inline int raise_smem_cap(Kernel kernel, int bytes,
                          unsigned long long& raised) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (raised & bit) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) raised |= bit;
  return static_cast<int>(err);
}

}  // namespace
