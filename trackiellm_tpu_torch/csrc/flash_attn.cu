// Causal GQA flash attention (prefill) for Hopper (sm_90a): the entry
// points and the kernels at D = 64, 96 and 128. The kernels, their design
// and what bounds them are in flash_attn.cuh; D = 192 and 256 are built in
// flash_attn_wide.cu.

#include "flash_attn.cuh"

// dtype: 0 = f32 (flash_fwd_kernel), 1 = bf16 (flash_mma_kernel); D is 64,
// 96, 128, 192 or 256. sinks: (H,) f32 or null. scale: the final score
// scale (the wrapper resolves 0 to 1/sqrt(D)). Returns a cudaError_t, or
// -1 for arguments the kernel does not take.
extern "C" int trackie_flash_attn(const void* q, const void* k, const void* v,
                                  const void* sinks, void* out, int H, int Hk,
                                  int S, int D, int dtype, float scale,
                                  int causal, int window, float softcap,
                                  void* stream) {
  if (H < 1 || Hk < 1 || H % Hk || S < kBQ || S % kBQ) return -1;
  auto s = static_cast<cudaStream_t>(stream);
  auto* sk = static_cast<const float*>(sinks);
  int status;
  switch (D) {
    case 64:
      status = dispatch<64>(q, k, v, sk, out, H, Hk, S, dtype, scale, causal,
                            window, softcap, s);
      break;
    case 96:
      status = dispatch<96>(q, k, v, sk, out, H, Hk, S, dtype, scale, causal,
                            window, softcap, s);
      break;
    case 128:
      status = dispatch<128>(q, k, v, sk, out, H, Hk, S, dtype, scale,
                             causal, window, softcap, s);
      break;
    case 192:
    case 256:
      status = trackie_flash::dispatch_wide(q, k, v, sk, out, H, Hk, S, D,
                                            dtype, scale, causal, window,
                                            softcap, s);
      break;
    default:
      return -1;
  }
  if (status != 0) return status;
  return static_cast<int>(cudaGetLastError());
}

// The registers a thread, the local (spill) bytes a thread and the shared
// memory bytes a block of the head-dim-D kernel of ``dtype`` (as above).
// Returns a cudaError_t, or -1 for a D or dtype the kernels do not take.
extern "C" int trackie_flash_attn_attrs(int D, int dtype, int* regs,
                                        int* local_bytes, int* smem_bytes) {
  if (dtype != 0 && dtype != 1) return -1;
  switch (D) {
    case 64: return attrs<64>(dtype, regs, local_bytes, smem_bytes);
    case 96: return attrs<96>(dtype, regs, local_bytes, smem_bytes);
    case 128: return attrs<128>(dtype, regs, local_bytes, smem_bytes);
    case 192:
    case 256:
      return trackie_flash::attrs_wide(D, dtype, regs, local_bytes,
                                       smem_bytes);
    default: return -1;
  }
}
