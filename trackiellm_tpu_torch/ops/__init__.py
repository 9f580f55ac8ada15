"""Tensor ops: the quantized matmuls, attention, the fused MLP block and
the diagnostic probes, each with a hand-written CUDA kernel and a plain
PyTorch version."""


def kernel_wrappers() -> dict:
    """Every hand-written kernel's wrapper by name; each counts the
    launches of its kernel in ``launches``."""
    from trackiellm_tpu_torch.ops import attention, diag, fused, quant
    return {"q4_matmul_w4a8": quant.q4_matmul_w4a8,
            "quantize_activations": quant.quantize_activations,
            "flash_attention": attention.flash_attention,
            "q8_matmul": quant.q8_matmul,
            "q4_matmul_f32a": quant.q4_matmul_f32a,
            "fused_mlp_q4": fused.fused_mlp_q4,
            "q4_matmul_stream": quant.q4_matmul_stream,
            "stream": diag.stream, "grid64": diag.grid64,
            "chain_tiny": diag.chain_tiny}
