"""Group-quantized weights and the W4A8 dequant-matmul.

Port of ``trackiellm_tpu/ops/quant.py`` with its byte layout unchanged:
Q8 values are int8 (K, N); Q4 values are packed across the K halves into
uint8 (K/2, N), ``packed[r, n]`` holding ``w[r, n] + 8`` in the low nibble
and ``w[K/2 + r, n]`` in two's complement in the high nibble; scales are f32
(K/G, N) for both.

Four hand-written kernels, each beside its plain PyTorch twin (``*_ref``):
``q4_matmul_w4a8`` (``csrc/q4_w4a8.cu``: its activation quantization,
``quantize_activations``, and an s8 tensor-core matmul) replaces
``q4_matmul_pallas_i8``,
``q8_matmul`` (``csrc/q8_matmul.cu``) replaces ``q8_matmul_pallas``,
``q4_matmul_f32a`` (``csrc/q4_f32a.cu``) replaces ``q4_matmul_pallas`` and
``q4_matmul_stream`` (``csrc/q4_stream.cu``) replaces
``q4_matmul_pallas_v2``. ``quantized_matmul`` dispatches as the JAX package
does, and so, like it, never takes the streaming kernel.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional, Tuple

import torch

from trackiellm_tpu_torch.ops import _build
from trackiellm_tpu_torch.ops.backend import is_cuda

DEFAULT_GROUP = 256
# Largest M that quantized_matmul sends to the default Q4 kernel (W4A8,
# which quantizes the activations to int8). Above it the JAX package
# computes exact activations times dequantized weights with f32 sums
# (``quantized_matmul_xla``); on the card the f32a (Q4) and Q8 kernels
# compute that function, at any M.
KERNEL_MAX_M = 512

# The C functions of the kernel library that these wrappers launch.
_quantize_act = _build.Launcher("trackie_quantize_act", "quantize_activations")
_q4_w4a8 = _build.Launcher("trackie_q4_w4a8", "q4_matmul_w4a8")
_SPLIT_K = {name: _build.Launcher(f"trackie_{name}", name)
            for name in ("q8_matmul", "q4_f32a")}
_q4_stream = _build.Launcher("trackie_q4_stream", "q4_matmul_stream")


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


def _group_scales(wg: torch.Tensor, qmax: float) -> torch.Tensor:
    """absmax / qmax per (group, column) of ``wg`` (K/G, G, N), divided as
    the JAX package divides. The divisor is a 0-dim tensor on wg's device:
    on CUDA, torch turns division by a Python number into a product with
    its f32 reciprocal, which differs from the division in the last bit of
    many scales."""
    amax = wg.abs().amax(dim=1)
    return amax / amax.new_full((), qmax)


def quantize_q8(w: torch.Tensor, group: int = DEFAULT_GROUP) -> QuantizedLinear:
    """Symmetric int8 group quantization (values in [-127, 127])."""
    k, n = w.shape
    if k % group:
        raise ValueError(f"K={k} not divisible by group={group}")
    wg = w.float().reshape(k // group, group, n)
    scale = _group_scales(wg, 127.0)
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
    scale = _group_scales(wg, 7.0)
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
    ``torch.round`` rounds half to even, as ``jnp.round`` does. The divisor
    127 is a tensor on x's device: on CUDA, torch turns division by a
    Python number into a product with its f32 reciprocal, which can differ
    from the division in the last bit."""
    m, k = x.shape
    xg = x.float().reshape(m, k // group, group)
    amax = xg.abs().amax(dim=2)
    sx = amax / amax.new_full((), 127.0)
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


def _split_k_plan(m: int, n: int, n_groups: int,
                  sms: int = 132) -> Tuple[int, int, int]:
    """Tile rows, K splits and groups per split for the f32-activation
    kernels that split K by whole groups (``n_groups`` is the count of
    groups a block walks).

    Tiles are 64 columns wide and 4, 16 or 64 rows tall (the smallest that
    covers M, so decode does not multiply work it throws away). When the
    (M, N) tiles alone give fewer than four blocks per SM, K is split by
    whole groups until they do; the kernels sum the splits in a fixed
    order, so the result does not depend on the split."""
    bm = 4 if m <= 4 else 16 if m <= 16 else 64
    tiles = math.ceil(n / 64) * math.ceil(m / bm)
    splits = max(1, min(n_groups, math.ceil(4 * sms / tiles)))
    per_split = max(1, n_groups // splits)
    return bm, math.ceil(n_groups / per_split), per_split


# Columns of a block tile of the tensor-core kernels (csrc/q4_w4a8.cu,
# csrc/q8_matmul.cu, csrc/q4_f32a.cu).
W4A8_BN = Q8_BN = F32A_BN = 128


def _w4a8_plan(m: int, n: int, n_groups: int,
               sms: int = 132) -> Tuple[int, int, int]:
    """Tile rows, K splits and groups per split of the W4A8 tensor-core
    kernel (``n_groups`` is the count of groups in each K half).

    Tiles are 128 columns wide; 16 rows (one m16 slab, 4 warps, mma.sync)
    for M <= 16, where decode pads M to 16 (the 64-row tile is 1.2-1.8x
    slower there, see the kernel's header), and 64 rows (two warpgroups,
    wgmma) above. When the (M, N) tiles give fewer than four blocks per SM,
    K is split by whole groups until they do; the kernel sums the splits in
    split order."""
    bm = 16 if m <= 16 else 64
    tiles = math.ceil(n / W4A8_BN) * math.ceil(m / bm)
    splits = max(1, min(n_groups, math.ceil(4 * sms / tiles)))
    per_split = max(1, n_groups // splits)
    return bm, math.ceil(n_groups / per_split), per_split


def _q8_plan(m: int, n: int, n_groups: int,
             sms: int = 132) -> Tuple[int, int, int]:
    """Tile rows, K splits and groups per split of the bf16 Q8 tensor-core
    kernel (``n_groups`` is the count of K groups).

    Tiles are 128 columns wide: 16 rows for M <= 16 (decode; four blocks
    fit an SM), 64 rows above (two fit). K is split by whole groups, as
    evenly as the groups allow, until the 16-row tiles give 16 blocks per
    SM, four waves: a decode block streams a few groups and the last wave
    leaves few SMs idle (on the five Mistral-7B projections at M = 1, one or
    two groups a block were within 1% of four or eight, or faster, up to 4x;
    ``tools/kernel_times.py``). The 64-row tiles are split only
    until there is one block per SM: at M = 512, halving K sped up none of
    the five by more than 3%. The kernel sums the splits in split order."""
    bm = 16 if m <= 16 else 64
    tiles = math.ceil(n / Q8_BN) * math.ceil(m / bm)
    target = (16 if bm == 16 else 1) * sms
    splits = max(1, min(n_groups, math.ceil(target / tiles)))
    per_split = math.ceil(n_groups / splits)
    return bm, math.ceil(n_groups / per_split), per_split


def _f32a_plan(m: int, n: int, n_groups: int,
               sms: int = 132) -> Tuple[int, int, int]:
    """Tile rows, K splits and groups per split of the bf16 f32a
    tensor-core kernel (``n_groups`` is the count of groups in each K
    half; a split walks whole group pairs).

    Tiles are 128 columns wide: 16 rows for M <= 16 (decode; four blocks
    fit an SM), 64 rows above (two fit). K is split, as evenly as the
    group pairs allow, until the 16-row tiles give 8 blocks per SM (at
    M = 1, two group pairs a split of ``w_gu`` and ``lm_head``, about 7
    blocks an SM, beat one, about 14; ``tools/kernel_times.py``), the
    64-row tiles one. The kernel sums the splits in split order."""
    bm = 16 if m <= 16 else 64
    tiles = math.ceil(n / F32A_BN) * math.ceil(m / bm)
    target = (8 if bm == 16 else 1) * sms
    splits = max(1, min(n_groups, math.ceil(target / tiles)))
    per_split = math.ceil(n_groups / splits)
    return bm, math.ceil(n_groups / per_split), per_split


_ACT_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def quantize_activations(x: torch.Tensor, group: int
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`quantize_activations_q8` as one kernel launch.

    A CUDA tensor launches ``quantize_act_kernel`` of ``csrc/q4_w4a8.cu``,
    whose outputs equal the plain version's bit for bit, or raises; a CPU
    tensor takes :func:`quantize_activations_q8`. x is (M, K) f32, bf16 or
    f16 with K % group == 0 and group % 32 == 0 on the card."""
    if x.dim() != 2 or x.shape[1] % group:
        raise ValueError(f"x must be (M, K) with K % {group} == 0, got "
                         f"{tuple(x.shape)}")
    if not is_cuda(x):
        return quantize_activations_q8(x, group)
    if x.dtype not in _ACT_DTYPES:
        raise TypeError(f"x must be f32, bf16 or f16, got {x.dtype}")
    if group % 32:
        raise ValueError(f"the kernel needs group % 32 == 0, got {group}")
    xq, s = _launch_quantize(x.contiguous(), group, _build.stream(x))
    return xq, s[0], s[1]


quantize_activations.launches = 0


def _launch_quantize(x: torch.Tensor, group: int, stream: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``quantize_act_kernel`` on contiguous x on the card and count
    it in ``quantize_activations.launches``; returns xq (M, K) int8 and one
    (2, M, K/G) f32 tensor holding sx, then sxsum (one allocation: the W4A8
    wrapper's host time per call is on the decode path)."""
    m, k = x.shape
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    s = torch.empty((2, m, k // group), dtype=torch.float32, device=x.device)
    _quantize_act(x.data_ptr(), xq.data_ptr(), s.data_ptr(),
                  s.data_ptr() + 4 * s.stride(0), m, k, group,
                  _ACT_DTYPES[x.dtype], stream)
    quantize_activations.launches += 1
    return xq, s


def q4_matmul_w4a8(x: torch.Tensor, packed: torch.Tensor,
                   scales: torch.Tensor) -> torch.Tensor:
    """W4A8 matmul: (M, K) float @ q4 (K, N) -> (M, N) f32.

    Replaces ``trackiellm_tpu/ops/quant.py:q4_matmul_pallas_i8``. A CUDA
    tensor launches the activation-quantization kernel, then the s8
    tensor-core kernel of ``csrc/q4_w4a8.cu`` (see its header for what
    bounds it on the H100 and how the design answers that), with nothing
    between them but ``torch.empty``; or it raises. A CPU tensor takes
    :func:`q4_matmul_w4a8_ref`."""
    g = _check_q4_operands(x, packed, scales)
    if not is_cuda(x):
        return q4_matmul_w4a8_ref(x, packed, scales)
    if not (packed.device == x.device == scales.device):
        raise ValueError("x, packed and scales must be on one device")
    if not (packed.is_contiguous() and scales.is_contiguous()):
        raise ValueError("packed and scales must be contiguous")
    if packed.data_ptr() % 16 or scales.data_ptr() % 16:
        raise ValueError("packed and scales must be 16-byte aligned")
    m, k = x.shape
    n = packed.shape[1]
    if g % 32 or n % 4:
        raise ValueError(f"the kernel needs G % 32 == 0 and N % 4 == 0 "
                         f"(G={g}, N={n})")
    bm, splits, per_split = _w4a8_plan(m, n, k // 2 // g)
    stream = _build.stream(x)
    xq, s = _launch_quantize(x.contiguous(), g, stream)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    partial = (torch.empty((splits, m, n), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    _q4_w4a8(xq.data_ptr(), s.data_ptr(), s.data_ptr() + 4 * s.stride(0),
             packed.data_ptr(), scales.data_ptr(), out.data_ptr(),
             partial.data_ptr() if partial is not None else None,
             m, k, n, g, bm, splits, per_split, stream)
    q4_matmul_w4a8.launches += 1
    return out


q4_matmul_w4a8.launches = 0


def _check_f32a_x(x: torch.Tensor) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")


def _check_q8_operands(x: torch.Tensor, values: torch.Tensor,
                       scales: torch.Tensor) -> int:
    """Validate the Q8 operands; returns the group size."""
    if x.dim() != 2 or values.dim() != 2 or scales.dim() != 2:
        raise ValueError("q8_matmul takes x (M, K), values (K, N), "
                         "scales (K/G, N)")
    if values.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError("values must be int8 and scales float32, got "
                        f"{values.dtype} and {scales.dtype}")
    _check_f32a_x(x)
    k, n = values.shape
    if (x.shape[1] != k or scales.shape[1] != n or scales.shape[0] == 0
            or k % scales.shape[0]):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, values "
                         f"{tuple(values.shape)}, scales "
                         f"{tuple(scales.shape)}")
    return k // scales.shape[0]


def q8_matmul_ref(x: torch.Tensor, values: torch.Tensor,
                  scales: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the Q8 kernel, as ``_q8_kernel`` computes it:
    per K group, the raw f32 dot of x with the group's int8 rows times the
    group's (1, N) scale row, summed in f32."""
    g = _check_q8_operands(x, values, scales)
    m, k = x.shape
    n = values.shape[1]
    ng = k // g
    xg = x.float().reshape(m, ng, g).transpose(0, 1)          # (ng, M, G)
    part = torch.bmm(xg, values.float().reshape(ng, g, n))    # (ng, M, N)
    return (part * scales[:, None, :]).sum(dim=0)


def q4_matmul_f32a_ref(x: torch.Tensor, packed: torch.Tensor,
                       scales: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the f32-activation Q4 kernel, as ``_q4_kernel``
    computes it: f32 activations, no activation quantization; per group,
    ``(x_lo . (q + 8) - 8 * sum(x_lo)) * s_lo + x_hi . (16 q) * s_hi / 16``
    (the biased low nibble and the high nibble read as 16q)."""
    g = _check_q4_operands(x, packed, scales)
    _check_f32a_x(x)
    m, k = x.shape
    half, n = packed.shape
    ngh = half // g
    p = packed.to(torch.int32)
    lo = (p & 0xF).float().reshape(ngh, g, n)                           # q + 8
    hi16 = (((((p >> 4) & 0xF) ^ 8) - 8) * 16).float().reshape(ngh, g, n)
    xf = x.float()
    x_lo = xf[:, :half].reshape(m, ngh, g).transpose(0, 1)    # (ngh, M, G)
    x_hi = xf[:, half:].reshape(m, ngh, g).transpose(0, 1)
    bias = 8.0 * x_lo.sum(dim=2, keepdim=True)                # (ngh, M, 1)
    part_lo = (torch.bmm(x_lo, lo) - bias) * scales[:ngh, None, :]
    part_hi = torch.bmm(x_hi, hi16) * (scales[ngh:, None, :] * (1.0 / 16.0))
    return (part_lo + part_hi).sum(dim=0)


def _bf16_operands(x: torch.Tensor, values: torch.Tensor,
                   scales: torch.Tensor) -> torch.Tensor:
    """The tensor-core kernels copy x and the scale rows 16 bytes at a time
    and the weights at least 4: refuse scales or weights off those
    boundaries, and return x contiguous and 16-byte aligned (a copy where
    it is not)."""
    if scales.data_ptr() % 16 or values.data_ptr() % 4:
        raise ValueError("scales must be 16-byte and values 4-byte aligned")
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def _launch_split_k(name: str, x: torch.Tensor, values: torch.Tensor,
                    scales: torch.Tensor, g: int, n_groups: int,
                    plan=_split_k_plan) -> torch.Tensor:
    """Launch ``trackie_<name>``, an f32-activation kernel that reads x as
    it lies (f32 or bf16) and splits K by whole groups as ``plan`` says;
    returns (M, N) f32."""
    if not (values.device == x.device == scales.device):
        raise ValueError("x, values and scales must be on one device")
    if not (values.is_contiguous() and scales.is_contiguous()):
        raise ValueError("values and scales must be contiguous")
    x = x.contiguous()
    m, k = x.shape
    n = values.shape[1]
    if g % 32 or n % 4:
        raise ValueError(f"the kernel needs G % 32 == 0 and N % 4 == 0 "
                         f"(G={g}, N={n})")
    bm, splits, per_split = plan(m, n, n_groups)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    partial: Optional[torch.Tensor] = (
        torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
        if splits > 1 else None)
    _SPLIT_K[name](
        x.data_ptr(), values.data_ptr(), scales.data_ptr(), out.data_ptr(),
        partial.data_ptr() if partial is not None else None,
        m, k, n, g, 0 if x.dtype == torch.float32 else 1, bm, splits,
        per_split, _build.stream(x))
    return out


def q8_matmul(x: torch.Tensor, values: torch.Tensor,
              scales: torch.Tensor) -> torch.Tensor:
    """Q8 matmul: (M, K) f32/bf16 @ int8 (K, N) -> (M, N) f32.

    Replaces ``trackiellm_tpu/ops/quant.py:q8_matmul_pallas``. A CUDA
    tensor launches ``csrc/q8_matmul.cu`` (see its header for what bounds
    it on the H100 and what its design does about that) or raises: bf16 x
    (the model's) its tensor-core kernel at every M, f32 x its f32-FMA
    kernel. A CPU tensor takes :func:`q8_matmul_ref`."""
    g = _check_q8_operands(x, values, scales)
    if not is_cuda(x):
        return q8_matmul_ref(x, values, scales)
    plan = _split_k_plan
    if x.dtype == torch.bfloat16:
        x = _bf16_operands(x, values, scales)
        plan = _q8_plan
    out = _launch_split_k("q8_matmul", x, values, scales, g,
                          values.shape[0] // g, plan)
    q8_matmul.launches += 1
    return out


q8_matmul.launches = 0


def q4_matmul_f32a(x: torch.Tensor, packed: torch.Tensor,
                   scales: torch.Tensor) -> torch.Tensor:
    """Q4 matmul with f32 activations: (M, K) f32/bf16 @ q4 (K, N) ->
    (M, N) f32.

    Replaces ``trackiellm_tpu/ops/quant.py:q4_matmul_pallas``. A CUDA
    tensor launches ``csrc/q4_f32a.cu`` (see its header for what bounds it
    on the H100 and what its design does about that) or raises: bf16 x
    (the model's) its tensor-core kernel at every M, f32 x its f32-FMA
    kernel. A CPU tensor takes :func:`q4_matmul_f32a_ref`."""
    g = _check_q4_operands(x, packed, scales)
    _check_f32a_x(x)
    if not is_cuda(x):
        return q4_matmul_f32a_ref(x, packed, scales)
    plan = _split_k_plan
    if x.dtype == torch.bfloat16:
        x = _bf16_operands(x, packed, scales)
        plan = _f32a_plan
    out = _launch_split_k("q4_f32a", x, packed, scales, g,
                          packed.shape[0] // g, plan)
    q4_matmul_f32a.launches += 1
    return out


q4_matmul_f32a.launches = 0


# Card defaults of q4_matmul_stream (``tools/kernel_times.py`` sweeps them;
# PERF.md has the sweep). The TPU defaults (tile_n 2048, tile_k 512) would
# stage 1 MiB a chunk, about 4.5x an H100 block's shared memory. A TMA copy
# fetches its box one row of tile_n bytes at a time, and a row costs about
# as much at 16 bytes as at 32, so wide tiles stream faster where N gives
# every SM a block: the default tile_n is the widest power of two from
# STREAM_TILE_N down to 16 that keeps N / tile_n >= STREAM_SMS
# (:func:`_stream_tile_n`; 128 for ``w_gu`` and ``lm_head``, 16 for N =
# 4096, ``wo`` and ``w_down``, 256 blocks). 256 packed rows a stage are
# one TMA box and at least one group.
STREAM_TILE_N = 128
STREAM_TILE_K = 256
STREAM_SMS = 132
STREAM_SMEM = 232448 - 1024   # shared memory bytes the kernel asks at most
STREAM_RING = 32768           # packed bytes a block aims to keep in flight
STREAM_MAX_STAGES = 32
_STREAM_HEAD = 2048           # the kernel's barriers and alignment slack


def q4_matmul_stream_ref(x: torch.Tensor, packed: torch.Tensor,
                         scales: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the streaming Q4 kernel, as
    ``_q4_stream_kernel`` computes it: the nibbles unbiased in the unpack
    (``lo = (p & 0xF) - 8``, ``hi = ((p >> 4 & 0xF) ^ 8) - 8``) and per
    group ``(x_lo . lo) * s_lo + (x_hi . hi) * s_hi``, with no bias fold
    and no 1/16 factor."""
    g = _check_q4_operands(x, packed, scales)
    _check_f32a_x(x)
    m, k = x.shape
    half, n = packed.shape
    ngh = half // g
    p = packed.to(torch.int32)
    lo = ((p & 0xF) - 8).float().reshape(ngh, g, n)
    hi = ((((p >> 4) & 0xF) ^ 8) - 8).float().reshape(ngh, g, n)
    xf = x.float()
    x_lo = xf[:, :half].reshape(m, ngh, g).transpose(0, 1)    # (ngh, M, G)
    x_hi = xf[:, half:].reshape(m, ngh, g).transpose(0, 1)
    part = (torch.bmm(x_lo, lo) * scales[:ngh, None, :]
            + torch.bmm(x_hi, hi) * scales[ngh:, None, :])
    return part.sum(dim=0)


def _stream_tile_n(n: int, sms: int = STREAM_SMS) -> int:
    """The default tile_n of an (., N) product: the widest power of two
    from STREAM_TILE_N down to 16 that divides N with at least one block an
    SM (N / tile_n >= sms); 16 where none does."""
    tile_n = STREAM_TILE_N
    while tile_n > 16 and (n % tile_n or n // tile_n < sms):
        tile_n //= 2
    return tile_n


def _stream_rows(m: int, x_bytes: int) -> int:
    """Rows of x a block of the streaming kernel computes: 16 (one m16 mma
    tile) for bf16 x, 1 for f32 x at M = 1, else 8."""
    return 16 if x_bytes == 2 else (1 if m == 1 else 8)


def _stream_plan(m: int, k: int, g: int, tile_n: int, tile_k: int,
                 x_bytes: int) -> Tuple[int, int]:
    """(stages, shared memory bytes) of a ``csrc/q4_stream.cu`` launch, as
    its ``smem_bytes`` computes them.

    A stage holds tile_k x tile_n packed bytes, both K halves of the
    block's rows of x for those packed rows (each row padded by 16 bytes)
    and both scale rows of the tile_k / g groups it ends. The ring takes
    enough stages to hold STREAM_RING bytes of packed weights, at least two
    (one where K/2 is one stage) and at most STREAM_MAX_STAGES or the
    stages K/2 holds; :func:`_stream_tiles` refuses tiles whose ring does
    not fit a block. The epilogue's sums reuse the ring: 1 KiB a consumer
    warp (bf16), or the row slices' (slices, rows, tile_n) floats (f32)."""
    rows = _stream_rows(m, x_bytes)
    stage = (tile_k * tile_n + 2 * min(rows, m) * (tile_k * x_bytes + 16)
             + 2 * (tile_k // g) * tile_n * 4)
    chunks = k // 2 // tile_k
    warps = 4 if tile_n <= 256 else tile_n // 64
    red = (warps * 32 * 8 * 4 if x_bytes == 2
           else warps * 32 // (tile_n // 4) * rows * tile_n * 4)
    stages = max(min(2, chunks), min(chunks, STREAM_MAX_STAGES,
                                     -(-STREAM_RING // (tile_k * tile_n))))
    return stages, _STREAM_HEAD + max(stages * stage, red)


def _stream_tiles(k: int, n: int, g: int, tile_n: int, tile_k: int,
                  m: int = 16, x_bytes: int = 2) -> Tuple[int, int]:
    """``q4_matmul_pallas_v2``'s tile rule (both clamped to the matrix,
    ``half % tile_k == n % tile_n == tile_k % g == 0``) plus the card's:
    ``tile_n`` a power of two in [16, 1024] (16-byte rows of TMA boxes), g
    a multiple of 32 (the bf16 kernel's 32-row units), and the
    :func:`_stream_plan` of an (m, k) x of ``x_bytes`` bytes an element
    within a block's shared memory (by default the largest x a block
    stages). Returns the clamped (tile_n, tile_k)."""
    half = k // 2
    tile_k, tile_n = min(tile_k, half), min(tile_n, n)
    if tile_k < 1 or half % tile_k or n % tile_n or tile_k % g:
        raise ValueError(f"tiles (tile_k={tile_k}, tile_n={tile_n}) do not "
                         f"divide K/2={half} and N={n} in whole groups of {g}")
    if tile_n < 16 or tile_n > 1024 or tile_n & (tile_n - 1):
        raise ValueError(f"tile_n={tile_n} must be a power of two in "
                         "[16, 1024]")
    if g % 32:
        raise ValueError(f"the kernel needs G % 32 == 0, got G={g}")
    stages, smem = _stream_plan(m, k, g, tile_n, tile_k, x_bytes)
    if smem > STREAM_SMEM:
        raise ValueError(f"{stages} stages of tile_k x tile_n = {tile_k} x "
                         f"{tile_n} with their x rows and scales take {smem} "
                         f"bytes, above the {STREAM_SMEM} bytes of shared "
                         "memory a block may take")
    return tile_n, tile_k


def q4_matmul_stream(x: torch.Tensor, packed: torch.Tensor,
                     scales: torch.Tensor, tile_n: Optional[int] = None,
                     tile_k: int = STREAM_TILE_K) -> torch.Tensor:
    """Q4 matmul streaming all of K per column tile: (M, K) f32/bf16 @ q4
    (K, N) -> (M, N) f32.

    Replaces ``trackiellm_tpu/ops/quant.py:q4_matmul_pallas_v2``, with its
    ``tile_n`` (columns per block; by default :func:`_stream_tile_n` of N)
    and ``tile_k`` (packed rows per staged chunk). A CUDA tensor launches ``csrc/q4_stream.cu`` (see its header) or
    raises; a CPU tensor takes :func:`q4_matmul_stream_ref`. The tile rule
    of :func:`_stream_tiles` holds on either device, for this x."""
    g = _check_q4_operands(x, packed, scales)
    _check_f32a_x(x)
    m, k = x.shape
    n = packed.shape[1]
    if tile_n is None:
        tile_n = _stream_tile_n(n)
    tile_n, tile_k = _stream_tiles(k, n, g, tile_n, tile_k, m,
                                   x.element_size())
    if not is_cuda(x):
        return q4_matmul_stream_ref(x, packed, scales)
    if not (packed.device == x.device == scales.device):
        raise ValueError("x, packed and scales must be on one device")
    if not (packed.is_contiguous() and scales.is_contiguous()):
        raise ValueError("packed and scales must be contiguous")
    if packed.data_ptr() % 16 or scales.data_ptr() % 16:
        raise ValueError("packed and scales must be 16-byte aligned")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    stages, _ = _stream_plan(m, k, g, tile_n, tile_k, x.element_size())
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    _q4_stream(x.data_ptr(), packed.data_ptr(), scales.data_ptr(),
               out.data_ptr(), m, k, n, g,
               0 if x.dtype == torch.float32 else 1, tile_k, tile_n, stages,
               _build.stream(x))
    q4_matmul_stream.launches += 1
    return out


q4_matmul_stream.launches = 0


def quantized_matmul(x: torch.Tensor, qw: QuantizedLinear) -> torch.Tensor:
    """(..., K) @ quantized (K, N) -> (..., N) f32.

    The JAX package's rule (``trackiellm_tpu/ops/quant.py:562-587``): a CPU
    tensor is dequantize-then-matmul, as the JAX package runs off the TPU.
    On the device, Q8 weights take :func:`q8_matmul` at every M. Q4 weights
    at M <= 512 take :func:`q4_matmul_w4a8`, or :func:`q4_matmul_f32a` when
    ``TRACKIE_Q4_F32A=1``; above 512 rows they take :func:`q4_matmul_f32a`
    whatever the variable says, since the JAX package's route there
    (``quantized_matmul_xla``) multiplies the exact activations by the
    dequantized weights with f32 sums, the function f32a and Q8 compute,
    and never quantizes the activations. The variable is read at each
    call, with the meaning the JAX package gives it at trace time; no
    route sends a CUDA tensor to a plain version. The JAX package's other
    levers (``TRACKIE_PALLAS_MAX_M``, ``TRACKIE_PREFILL_XLA_M``,
    ``TRACKIE_Q4_WIDE_W``) tune TPU tiles or route to the plain path, and
    are not read."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if not is_cuda(x2):
        out = quantized_matmul_ref(x2, qw)
    elif qw.values.dtype == torch.int8:
        out = q8_matmul(x2, qw.values, qw.scales)
    elif (x2.shape[0] > KERNEL_MAX_M
          or os.environ.get("TRACKIE_Q4_F32A") == "1"):
        out = q4_matmul_f32a(x2, qw.values, qw.scales)
    else:
        out = q4_matmul_w4a8(x2, qw.values, qw.scales)
    return out.reshape(*lead, qw.n)
