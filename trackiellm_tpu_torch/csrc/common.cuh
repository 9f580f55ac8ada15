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

// --- mbarriers, TMA and bulk copies ------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// Makes the initialized barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// One arrival that also raises the phase's expected transaction bytes.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}
// TMA: the box at (c0, c1) (innermost coordinate first) of a 2-D tensor map
// into shared memory; its bytes complete on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* tmap,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
// into shared memory; they complete on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
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

// Bytes sel & 0xF and (sel >> 8) & 0xF of u, each a nibble q + 8, as the
// bf16x2 word of the two q, exactly and with no conversion instruction:
// 128 + u is exact in bf16 and its bits are 0x4300 | u, so a byte permute
// puts both nibbles under 0x43 and one bf16x2 FMA subtracts 136.
__device__ __forceinline__ uint32_t nibbles_to_bf16x2(uint32_t u,
                                                      uint32_t sel) {
  const uint32_t biased = __byte_perm(u, 0x43u, sel);   // 128 + u each
  uint32_t q;  // biased * 1 - 136
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(q)
      : "r"(biased), "r"(0x3F803F80u), "r"(0xC308C308u));
  return q;
}

// One ldmatrix.trans register of the raw chunk holds bytes (k, c), (k, c+1),
// (k+1, c), (k+1, c+1) for k = 2t, c = 2g: the low (lo) or high (hi)
// nibbles of the even or odd column, as a B fragment half of m16n8k16.
__device__ __forceinline__ void widen_frag(uint32_t w, uint32_t (&lo)[2],
                                           uint32_t (&hi)[2]) {
  const uint32_t ul = w & 0x0F0F0F0Fu;                          // q + 8
  const uint32_t uh = ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;   // q + 8
  lo[0] = nibbles_to_bf16x2(ul, 0x4240);   // even column
  lo[1] = nibbles_to_bf16x2(ul, 0x4341);   // odd column
  hi[0] = nibbles_to_bf16x2(uh, 0x4240);
  hi[1] = nibbles_to_bf16x2(uh, 0x4341);
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
