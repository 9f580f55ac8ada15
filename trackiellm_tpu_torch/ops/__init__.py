"""Tensor ops: the quantized matmuls, attention, the fused MLP block and
the diagnostic probes, each with a hand-written CUDA kernel and a plain
PyTorch version."""
