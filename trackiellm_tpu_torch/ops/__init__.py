"""Tensor ops: the Q4 dequant-matmul and attention, each with a
hand-written CUDA kernel and a plain PyTorch version."""
