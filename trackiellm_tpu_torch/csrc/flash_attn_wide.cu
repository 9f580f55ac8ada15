// Causal GQA flash attention (prefill) for Hopper (sm_90a) at the wide
// head dims, D = 192 (DeepSeek's MLA prefill) and 256 (Gemma): built apart
// from flash_attn.cu so that the two compile side by side. The kernels
// are in flash_attn.cuh.

#include "flash_attn.cuh"

namespace trackie_flash {

int dispatch_wide(const void* q, const void* k, const void* v,
                  const float* sinks, void* out, int H, int Hk, int S, int D,
                  int dtype, float scale, int causal, int window,
                  float softcap, cudaStream_t stream) {
  if (D == 192)
    return dispatch<192>(q, k, v, sinks, out, H, Hk, S, dtype, scale, causal,
                         window, softcap, stream);
  if (D == 256)
    return dispatch<256>(q, k, v, sinks, out, H, Hk, S, dtype, scale, causal,
                         window, softcap, stream);
  return -1;
}

int attrs_wide(int D, int dtype, int* regs, int* local_bytes,
               int* smem_bytes) {
  if (D == 192) return attrs<192>(dtype, regs, local_bytes, smem_bytes);
  if (D == 256) return attrs<256>(dtype, regs, local_bytes, smem_bytes);
  return -1;
}

}  // namespace trackie_flash
