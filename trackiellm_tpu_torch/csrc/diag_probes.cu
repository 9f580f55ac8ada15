// The three diagnostic probes of the JAX package's tools, for Hopper (sm_90a).
//
// Replaces:
//   - tools/diag_envelope.py:stream_pallas (its body is _stream_kernel):
//     (1, 1) f32 = x[0, 0] * the sum of a uint8 array, 512 MiB in the tool;
//     it measures the device-memory stream envelope;
//   - tools/diag_scan_overhead.py:grid64 and tools/diag_overhead.py:chain_tiny
//     (the near-empty kernel of each): o = x + 1 on an (8, 128) f32 tile,
//     run by a grid of 64 steps on the one tile, and by one call of a chain
//     of dependent calls. They measure what a grid step and a call cost.
//
// stream: device-memory bandwidth bounds it (each byte is read once and
// added once). Design: a grid-stride loop of 16-byte loads, four in flight
// per thread, so about 64 KiB per SM are in flight. Each thread sums its
// bytes exactly as integers (dp4a against 0x01010101 adds four bytes at
// once); a block reduces its threads' 64-bit sums with warp shuffles, and a
// second, one-thread kernel sums the block partials in block order, converts
// the total to f32 once and multiplies by x[0, 0]. The integer sum is exact,
// so the one rounding is that conversion; the plain version, an f32 sum,
// carries the rounding of its own order.
//
// grid64: the TPU runs its 64 grid steps in order on one core, on one
// (8, 128) block that stays in VMEM (both index maps are (0, 0)) and is
// written back once. Its counterpart here is a loop inside one block:
// grid_steps_kernel loads the tile once into registers (4 floats a thread of
// 256), runs `steps` steps of o = x + 1 on it and stores o once. Every step
// writes the same value, so a compiler would keep only the last; each step's
// 1.0 therefore carries the last step's o through an and with a zero the
// kernel takes as an argument (one LOP3 beside each FADD), which keeps every
// step in the SASS and the result exact. Issue slots bound the steps: 64
// steps of 1,024 adds and ands are 4,096 warp instructions over the SM's
// four schedulers.
//
// add_one (chain_tiny): launch latency bounds it (each call moves 8 KiB).
// The TPU tool runs its 64 dependent calls as a scan inside one jit
// program, so no host dispatch comes between them. Its counterpart here is
// one host call, trackie_add_one_chain, that issues the n launches itself,
// each its own one-block launch of o = x + 1, ping-ponging between the
// caller's output and one scratch tile so that the n-th writes the output.
// Launches 2..n carry programmatic dependent launch (sm_90): each kernel
// lets the next one launch at its start (griddepcontrol.launch_dependents)
// and waits for the last one to finish and its writes to show
// (griddepcontrol.wait) before it reads or writes, so a launch's setup
// overlaps its predecessor's run. The first launch is a plain one: it
// waits on whatever the stream ran before, and the chain's programmatic
// edges join only its own kernels (which CUDA graphs capture, 12.3 on).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned add_bytes(uint4 v, unsigned acc) {
  acc = __dp4a(v.x, 0x01010101u, acc);
  acc = __dp4a(v.y, 0x01010101u, acc);
  acc = __dp4a(v.z, 0x01010101u, acc);
  return __dp4a(v.w, 0x01010101u, acc);
}

// partial[block] = the sum of this block's bytes: the 16-byte vectors of
// w in grid-stride order, then the n_tail bytes past the last whole vector.
__global__ void __launch_bounds__(kThreads) stream_sum_kernel(
    const uint4* __restrict__ w, size_t n16,
    const uint8_t* __restrict__ tail, int n_tail,
    unsigned long long* __restrict__ partial) {
  const size_t stride = (size_t)gridDim.x * kThreads;
  const size_t gid = blockIdx.x * (size_t)kThreads + threadIdx.x;
  unsigned long long sum = 0;
  size_t i = gid;
  for (; i + 3 * stride < n16; i += 4 * stride) {
    const uint4 a = w[i], b = w[i + stride], c = w[i + 2 * stride],
                d = w[i + 3 * stride];
    // At most 64 * 255 = 16320 per step: no overflow in 32 bits.
    sum += add_bytes(d, add_bytes(c, add_bytes(b, add_bytes(a, 0u))));
  }
  for (; i < n16; i += stride) sum += add_bytes(w[i], 0u);
  if (gid < (size_t)n_tail) sum += tail[gid];

  for (int o = 16; o > 0; o >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, o);
  __shared__ unsigned long long warp_sums[kThreads / 32];
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
    for (int k = 0; k < kThreads / 32; ++k) total += warp_sums[k];
    partial[blockIdx.x] = total;
  }
}

__global__ void stream_finish_kernel(
    const unsigned long long* __restrict__ partial, int blocks,
    const float* __restrict__ x, float* __restrict__ out) {
  unsigned long long total = 0;
  for (int b = 0; b < blocks; ++b) total += partial[b];
  out[0] = static_cast<float>(total) * x[0];
}

// Thread t holds elements t + 256 j of the tile (j < 4), zero past n.
__global__ void __launch_bounds__(kThreads) grid_steps_kernel(
    const float* __restrict__ x, float* __restrict__ out, int n, int steps,
    unsigned zero) {
  constexpr int kPer = 4;
  float v[kPer], o[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = threadIdx.x + kThreads * j;
    v[j] = i < n ? x[i] : 0.f;
    o[j] = v[j];
  }
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      // 1.0 with the bits of the last step's o anded with `zero` (0, an
      // argument the compiler cannot see): exact for every o, and a use
      // of it, so no step is merged with or dropped for another.
      const float one =
          __uint_as_float((__float_as_uint(o[j]) & zero) | 0x3F800000u);
      o[j] = v[j] + one;
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = threadIdx.x + kThreads * j;
    if (i < n) out[i] = o[j];
  }
}

// Nothing is read or written before the wait: the last launch may still be
// writing x, or reading the tile this one writes.
__global__ void __launch_bounds__(kThreads) add_one_kernel(
    const float* __restrict__ x, float* __restrict__ out, int n) {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  asm volatile("griddepcontrol.wait;" ::: "memory");
  for (int i = threadIdx.x; i < n; i += kThreads) out[i] = x[i] + 1.f;
}

}  // namespace

// out (1) f32 = x[0] * (sum of the n_bytes bytes at w). w must be 16-byte
// aligned; partial holds `blocks` 64-bit integers. Returns a cudaError_t, or
// -1 for arguments the kernel does not take.
extern "C" int trackie_stream_sum(const void* x, const void* w,
                                  long long n_bytes, void* partial,
                                  int blocks, void* out, void* stream) {
  if (n_bytes < 0 || blocks < 1 || reinterpret_cast<uintptr_t>(w) % 16)
    return -1;
  const size_t n16 = static_cast<size_t>(n_bytes) / 16;
  const int n_tail = static_cast<int>(n_bytes % 16);
  auto s = static_cast<cudaStream_t>(stream);
  auto* p = static_cast<unsigned long long*>(partial);
  stream_sum_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const uint4*>(w), n16,
      static_cast<const uint8_t*>(w) + n16 * 16, n_tail, p);
  stream_finish_kernel<<<1, 1, 0, s>>>(p, blocks, static_cast<const float*>(x),
                                       static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// n (at least 1) dependent launches of add_one_kernel on the numel floats
// at x: launch j reads launch j-1's output (x for j = 1) and writes out
// where n - j is even, scratch where it is odd, so the n-th writes out;
// scratch may be null for n = 1. Returns the first launch's error, or -1
// for arguments the kernel does not take.
extern "C" int trackie_add_one_chain(const void* x, void* out, void* scratch,
                                     int numel, int n, void* stream) {
  if (numel < 1 || n < 1 || (n > 1 && scratch == nullptr)) return -1;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  const float* src = static_cast<const float*>(x);
  for (int j = 1; j <= n; ++j) {
    float* dst = static_cast<float*>((n - j) % 2 == 0 ? out : scratch);
    cfg.attrs = j > 1 ? pdl : nullptr;
    cfg.numAttrs = j > 1 ? 1 : 0;
    cudaLaunchKernelEx(&cfg, add_one_kernel, src, dst, numel);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
  }
  return 0;
}

// out[i] = x[i] + 1 for i < n (at most 1,024), by one block that runs
// `steps` (at least 1) steps of it on the resident tile.
extern "C" int trackie_grid64(const void* x, void* out, int n, int steps,
                              void* stream) {
  if (n < 1 || n > 1024 || steps < 1) return -1;
  grid_steps_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n, steps, 0u);
  return static_cast<int>(cudaGetLastError());
}
