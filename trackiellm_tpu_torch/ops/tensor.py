"""Generic tensor ops of the FFI surface: the JAX package's
``ops/tensor.py`` in plain torch ops on the tensors' own device.

The stable C ABI's tensor operations (matmul, blocked matmul; reference
``tk_ffi_api.h:251-382``) and the CUDA tensor extension's conv2d, pooling
and norms (``tk_cuda_tensor_ops.cu:101-452``); the JAX module's one-line
aliases of elementwise ops and reductions are torch's own and are not
repeated. Matmuls and convolutions sum in f32 (the JAX ops'
``preferred_element_type``) without TF32 (``exact_f32``). No JAX path
but the ops tests calls these, and none reaches a Pallas kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from trackiellm_tpu_torch.ops.backend import exact_f32


# -- matmul --------------------------------------------------------------------

def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matmul with f32 sums and an f32 result (inputs may be bf16)."""
    with exact_f32():
        return torch.matmul(a.float(), b.float())


def matmul_blocked(a: torch.Tensor, b: torch.Tensor,
                   block: int = 512) -> torch.Tensor:
    """Blocked matmul (FFI: tk_tensor_matmul_blocked): the K dimension in
    ``block``-sized slabs (zero-padded to a whole number), each product
    added to an f32 accumulator, so peak memory stays bounded on very
    large contractions."""
    k = a.shape[-1]
    if k <= block:
        return matmul(a, b)
    n_blocks = -(-k // block)
    pad = n_blocks * block - k
    a_p = F.pad(a.float(), (0, pad))
    b_p = torch.cat([b.float(), b.new_zeros((pad, *b.shape[1:]),
                                            dtype=torch.float32)])
    acc = torch.zeros((*a.shape[:-1], *b.shape[1:]), dtype=torch.float32,
                      device=a.device)
    for i in range(n_blocks):
        acc = acc + matmul(a_p[..., i * block:(i + 1) * block],
                           b_p[i * block:(i + 1) * block])
    return acc


# -- conv / pooling ---------------------------------------------------------------

def _same_pads(size: int, window: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME": the output is ceil(size / stride), the extra rows
    split with the smaller half first."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _pads(padding: str, hw, window, stride) -> Tuple[int, ...]:
    """F.pad's (left, right, top, bottom) for "SAME" or "VALID"."""
    if padding.upper() == "VALID":
        return (0, 0, 0, 0)
    (t, b), (l, r) = (_same_pads(hw[i], window[i], stride) for i in range(2))
    return (l, r, t, b)


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
           padding: str = "SAME", groups: int = 1) -> torch.Tensor:
    """NCHW conv with OIHW weights, f32 sums and an f32 result."""
    pads = _pads(padding, x.shape[2:], w.shape[2:], stride)
    with exact_f32():
        return F.conv2d(F.pad(x.float(), pads), w.float(), stride=stride,
                        groups=groups)


def max_pool2d(x: torch.Tensor, size: int = 2,
               stride: int = 2) -> torch.Tensor:
    """NCHW max pool, "SAME" padding with -inf."""
    pads = _pads("SAME", x.shape[2:], (size, size), stride)
    return F.max_pool2d(F.pad(x, pads, value=-float("inf")), size, stride)


def avg_pool2d(x: torch.Tensor, size: int = 2,
               stride: int = 2) -> torch.Tensor:
    """NCHW mean pool, "SAME" padding with zeros counted in the mean."""
    pads = _pads("SAME", x.shape[2:], (size, size), stride)
    return F.avg_pool2d(F.pad(x, pads), size, stride)


# -- normalization -----------------------------------------------------------------

def batch_norm(x, mean, var, scale, bias, eps: float = 1e-5):
    """Inference-mode batch norm over NCHW channel axis."""
    shape = (1, -1, 1, 1)
    inv = torch.rsqrt(var.reshape(shape) + eps)
    return ((x - mean.reshape(shape)) * inv * scale.reshape(shape)
            + bias.reshape(shape))


def layer_norm(x, scale, bias, eps: float = 1e-5):
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def rms_norm(x, scale, eps: float = 1e-5):
    ms = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return (x * torch.rsqrt(ms + eps)).to(x.dtype) * scale
