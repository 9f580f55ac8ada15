"""Group-quantized weights and the W4A8 dequant-matmul.

Port of ``trackiellm_tpu/ops/quant.py`` with its byte layout unchanged:
Q8 values are int8 (K, N); Q4 values are packed across the K halves into
uint8 (K/2, N), ``packed[r, n]`` holding ``w[r, n] + 8`` in the low nibble
and ``w[K/2 + r, n]`` in two's complement in the high nibble; scales are f32
(K/G, N) for both.

``q4_matmul_w4a8`` is the hand-written kernel (``csrc/q4_w4a8.cu``) that
replaces ``q4_matmul_pallas_i8``; ``q4_matmul_w4a8_ref`` is its plain
PyTorch twin. ``quantized_matmul`` dispatches as the JAX package does.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from trackiellm_tpu_torch.ops import _build
from trackiellm_tpu_torch.ops.backend import is_cuda

DEFAULT_GROUP = 256
# Largest M the W4A8 kernel takes inside quantized_matmul; above it the
# product is dequantize-then-matmul, as the JAX package leaves it to XLA.
KERNEL_MAX_M = 512


class QuantizedLinear(NamedTuple):
    """Group-quantized (K, N) weight (or a stack of them on leading axes)."""

    values: torch.Tensor  # int8 (K, N) for Q8; packed uint8 (K//2, N) for Q4
    scales: torch.Tensor  # f32 (K // group, N)

    @property
    def k(self) -> int:
        rows = self.values.shape[-2]
        return rows * (2 if self.values.dtype == torch.uint8 else 1)

    @property
    def n(self) -> int:
        return self.values.shape[-1]

    @property
    def group_size(self) -> int:
        return self.k // self.scales.shape[-2]


def quantize_q8(w: torch.Tensor, group: int = DEFAULT_GROUP) -> QuantizedLinear:
    """Symmetric int8 group quantization (values in [-127, 127])."""
    k, n = w.shape
    if k % group:
        raise ValueError(f"K={k} not divisible by group={group}")
    wg = w.float().reshape(k // group, group, n)
    scale = wg.abs().amax(dim=1) / 127.0
    safe = scale.clamp_min(1e-12)
    q = torch.clamp(torch.round(wg / safe[:, None, :]), -127, 127)
    return QuantizedLinear(values=q.to(torch.int8).reshape(k, n), scales=scale)


def quantize_q4(w: torch.Tensor, group: int = DEFAULT_GROUP) -> QuantizedLinear:
    """Symmetric int4 group quantization (values in [-8, 7]) packed two per
    uint8 across the K halves, with the mixed-bias nibble encoding."""
    k, n = w.shape
    if k % group or (k // 2) % group:
        raise ValueError(f"K={k} and K/2 must be divisible by group={group}")
    wg = w.float().reshape(k // group, group, n)
    scale = wg.abs().amax(dim=1) / 7.0
    safe = scale.clamp_min(1e-12)
    q = torch.clamp(torch.round(wg / safe[:, None, :]), -8, 7)
    q = q.to(torch.int32).reshape(k, n)
    lo = (q[: k // 2] + 8).to(torch.uint8)          # biased to [0, 15]
    hi = (q[k // 2:] & 0xF).to(torch.uint8)         # two's complement
    return QuantizedLinear(values=lo | (hi << 4), scales=scale)


def dequantize(qw: QuantizedLinear) -> torch.Tensor:
    """Dequantize one (K, N) weight to f32."""
    if qw.values.dtype == torch.int8:
        k, n = qw.values.shape
        g = k // qw.scales.shape[0]
        vals = qw.values.float().reshape(-1, g, n)
        return (vals * qw.scales[:, None, :]).reshape(k, n)
    packed = qw.values.to(torch.int32)
    half, n = packed.shape
    k = half * 2
    g = k // qw.scales.shape[0]
    lo = (packed & 0xF) - 8
    hi = (((packed >> 4) & 0xF) ^ 8) - 8
    q = torch.cat([lo, hi], dim=0).float()
    return (q.reshape(-1, g, n) * qw.scales[:, None, :]).reshape(k, n)


def quantized_matmul_ref(x: torch.Tensor, qw: QuantizedLinear) -> torch.Tensor:
    """Plain path: dequantize, then an f32 matmul (``quantized_matmul_xla``)."""
    return torch.matmul(x.float(), dequantize(qw))


def quantize_activations_q8(x: torch.Tensor, group: int
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-(row, group) symmetric int8 activation quantization. Returns
    ``(x_i8 (M, K), sx (M, K/G) f32, sxsum (M, K/G) f32 = sx * sum(x_i8))``.
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    m, k = x.shape
    xg = x.float().reshape(m, k // group, group)
    sx = xg.abs().amax(dim=2) / 127.0
    safe = sx.clamp_min(1e-12)
    xq = torch.clamp(torch.round(xg / safe[:, :, None]), -127, 127)
    sxsum = sx * xq.sum(dim=2)
    return xq.to(torch.int8).reshape(m, k), sx, sxsum


def _check_q4_operands(x: torch.Tensor, packed: torch.Tensor,
                       scales: torch.Tensor) -> int:
    """Validate the W4A8 operands; returns the group size."""
    if x.dim() != 2 or packed.dim() != 2 or scales.dim() != 2:
        raise ValueError("q4_matmul_w4a8 takes x (M, K), packed (K/2, N), "
                         "scales (K/G, N)")
    m, k = x.shape
    half, n = packed.shape
    if packed.dtype != torch.uint8 or scales.dtype != torch.float32:
        raise TypeError("packed must be uint8 and scales float32, got "
                        f"{packed.dtype} and {scales.dtype}")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"x must be a float tensor, got {x.dtype}")
    if 2 * half != k or scales.shape[1] != n or k % scales.shape[0]:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, packed "
                         f"{tuple(packed.shape)}, scales {tuple(scales.shape)}")
    g = k // scales.shape[0]
    if half % g:
        raise ValueError(f"group {g} does not divide K/2 = {half}")
    return g


def q4_matmul_w4a8_ref(x: torch.Tensor, packed: torch.Tensor,
                       scales: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the W4A8 kernel: the same activation
    quantization and per-group folds, with the int dots taken as exact f32
    matmuls (|dot| <= 127 * 15 * G stays below 2^24 for G <= 8192)."""
    g = _check_q4_operands(x, packed, scales)
    m, k = x.shape
    half, n = packed.shape
    ngh = half // g
    xq, sx, sxsum = quantize_activations_q8(x, g)
    p = packed.to(torch.int32)
    lo = (p & 0xF).float().reshape(ngh, g, n)                 # q + 8
    hi = ((((p >> 4) & 0xF) ^ 8) - 8).float().reshape(ngh, g, n)  # q
    x_lo = xq[:, :half].float().reshape(m, ngh, g).transpose(0, 1)
    x_hi = xq[:, half:].float().reshape(m, ngh, g).transpose(0, 1)
    dot_lo = torch.bmm(x_lo, lo)                              # (ngh, M, N)
    dot_hi = torch.bmm(x_hi, hi)
    sx_lo = sx[:, :ngh].t()[:, :, None]                       # (ngh, M, 1)
    sx_hi = sx[:, ngh:].t()[:, :, None]
    sum_lo = sxsum[:, :ngh].t()[:, :, None]
    s_lo = scales[:ngh, None, :]                              # (ngh, 1, N)
    s_hi = scales[ngh:, None, :]
    part = (dot_lo * sx_lo - 8.0 * sum_lo) * s_lo + (dot_hi * sx_hi) * s_hi
    return part.sum(dim=0)


def _w4a8_plan(m: int, k: int, n: int, g: int,
               sms: int = 132) -> Tuple[int, int, int]:
    """Tile rows, K splits and groups per split for the W4A8 kernel.

    Tiles are 64 columns wide and 4, 16 or 64 rows tall (the smallest that
    covers M, so decode does not multiply work it throws away). When the
    (M, N) tiles alone give fewer than four blocks per SM, K is split by
    whole groups until they do; the kernel sums the splits in a fixed
    order, so the result does not depend on the split."""
    bm = 4 if m <= 4 else 16 if m <= 16 else 64
    tiles = math.ceil(n / 64) * math.ceil(m / bm)
    ngh = k // 2 // g
    splits = max(1, min(ngh, math.ceil(4 * sms / tiles)))
    per_split = max(1, ngh // splits)
    return bm, math.ceil(ngh / per_split), per_split


def q4_matmul_w4a8(x: torch.Tensor, packed: torch.Tensor,
                   scales: torch.Tensor) -> torch.Tensor:
    """W4A8 matmul: (M, K) float @ q4 (K, N) -> (M, N) f32.

    Replaces ``trackiellm_tpu/ops/quant.py:q4_matmul_pallas_i8``. A CUDA
    tensor launches ``csrc/q4_w4a8.cu`` (see its header for what bounds it
    on the H100 and how the tiling answers that) or raises; a CPU tensor
    takes :func:`q4_matmul_w4a8_ref`. The activation quantization runs as
    torch ops before the kernel, as it runs outside the Pallas body."""
    g = _check_q4_operands(x, packed, scales)
    if not is_cuda(x):
        return q4_matmul_w4a8_ref(x, packed, scales)
    if not (packed.device == x.device == scales.device):
        raise ValueError("x, packed and scales must be on one device")
    if not (packed.is_contiguous() and scales.is_contiguous()):
        raise ValueError("packed and scales must be contiguous")
    m, k = x.shape
    n = packed.shape[1]
    if g % 32 or n % 4:
        raise ValueError(f"the kernel needs G % 32 == 0 and N % 4 == 0 "
                         f"(G={g}, N={n})")
    xq, sx, sxsum = quantize_activations_q8(x, g)
    bm, splits, per_split = _w4a8_plan(m, k, n, g)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    partial = (torch.empty((splits, m, n), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    lib = _build.library()
    status = lib.trackie_q4_w4a8(
        xq.data_ptr(), sx.data_ptr(), sxsum.data_ptr(), packed.data_ptr(),
        scales.data_ptr(), out.data_ptr(),
        partial.data_ptr() if partial is not None else None,
        m, k, n, g, bm, splits, per_split,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "q4_matmul_w4a8")
    q4_matmul_w4a8.launches += 1
    return out


q4_matmul_w4a8.launches = 0


def quantized_matmul(x: torch.Tensor, qw: QuantizedLinear) -> torch.Tensor:
    """(..., K) @ quantized (K, N) -> (..., N) f32.

    Same rule as the JAX package: on the device, Q4 with M <= 512 takes the
    W4A8 kernel and larger M is dequantize-then-matmul; a CPU tensor is
    dequantize-then-matmul, as the JAX package runs off the TPU. Q8 on the
    device waits for the ``q8_matmul_pallas`` port."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if is_cuda(x2) and qw.values.dtype == torch.int8:
        raise NotImplementedError(
            "Q8 weights on CUDA: q8_matmul_pallas is not ported yet "
            "(ROADMAP Queue 2)")
    if not is_cuda(x2) or x2.shape[0] > KERNEL_MAX_M:
        out = quantized_matmul_ref(x2, qw)
    else:
        out = q4_matmul_w4a8(x2, qw.values, qw.scales)
    return out.reshape(*lead, qw.n)
