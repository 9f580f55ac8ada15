// Pieces shared by the kernels in this directory.
//
// Each .cu file includes this header and gets its own copy: everything here
// lives in an anonymous namespace, so the shared library links without
// duplicate symbols.

#pragma once

#include <cstddef>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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
