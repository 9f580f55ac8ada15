"""The one-launch Q4 decode MLP block.

Port of ``trackiellm_tpu/ops/fused.py``: ``x + down(silu(gate) * up)`` over
``rmsnorm(x)`` for small-M Q4 weights, behind the ``TRACKIE_FUSED_MLP=1``
opt-in. ``fused_mlp_q4`` is the hand-written kernel
(``csrc/fused_mlp_q4.cu``) that replaces ``fused_mlp_q4_pallas``;
``fused_mlp_ref`` is its plain PyTorch twin with ``fused_mlp_xla``'s
numerics, which differ from the unfused ``models/llm.py:_mlp_block``: the
norm stays in f32, and ``silu(gate) * up`` reaches the down product in f32
without a cast to x's dtype.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.nn.functional as F

from trackiellm_tpu_torch.ops import _build
from trackiellm_tpu_torch.ops.backend import is_cuda
from trackiellm_tpu_torch.ops.quant import (QuantizedLinear,
                                            quantized_matmul_ref)

# Largest M the fused block takes (``_can_fuse``).
FUSED_MAX_M = 8
# The kernel's work units (csrc/fused_mlp_q4.cu), for M rounded up to R
# rows (1, 2, 4 or 8): phase A cuts the hidden pairs into tiles of
# ``_TILE_PAIRS[R]`` and W_gu's D/2 packed rows into chunks of
# ``_CHUNK_A[R]``; phase B cuts the output columns into slices of
# ``_SLICE_COLS[R]`` and W_down's H/2 packed rows into chunks of 64. Each
# phase's units are split over the blocks as contiguous ranges
# (``unit_ranges``); a block has ``_THREADS[R]`` threads, each on
# ``_COLS[R]`` columns.
CHUNK_B = 64
_THREADS = {1: 512, 2: 512, 4: 512, 8: 256}
_TILE_PAIRS = {1: 128, 2: 128, 4: 64, 8: 32}
_CHUNK_A = {1: 16, 2: 16, 4: 32, 8: 32}
_SLICE_COLS = {1: 128, 2: 128, 4: 128, 8: 64}
_COLS = {1: 4, 2: 4, 4: 2, 8: 4}
_STAGES = 8
# Dynamic shared memory the kernel may ask for: Hopper's 232,448 bytes a
# block, less room for its static shared memory.
_MAX_SMEM = 232448 - 1024


def fused_mlp_ref(x: torch.Tensor, norm_scale: torch.Tensor,
                  w_gu: QuantizedLinear, w_down: QuantizedLinear,
                  eps: float) -> torch.Tensor:
    """Plain path (``fused_mlp_xla``): x + down(silu(gate) * up) over
    rmsnorm(x), every intermediate in f32, one cast at the end."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    h2 = xf * torch.rsqrt(ms + eps) * norm_scale.float()
    gate, up = quantized_matmul_ref(h2, w_gu).chunk(2, dim=-1)
    out = quantized_matmul_ref(F.silu(gate) * up, w_down)
    return (xf + out).to(x.dtype)


def use_fused_mlp() -> bool:
    """The opt-in gate: ``TRACKIE_FUSED_MLP=1``, read at each call, with the
    meaning the JAX package gives it at trace time."""
    return os.environ.get("TRACKIE_FUSED_MLP") == "1"


def _can_fuse(x: torch.Tensor, w_gu, w_down) -> bool:
    """Every gate of the JAX package's ``_can_fuse``, the TPU tiling ones
    (``g % 128``, ``d % 256``) included, so the port takes the fused route
    exactly where the JAX package does."""
    if not isinstance(w_gu, QuantizedLinear) or not isinstance(
            w_down, QuantizedLinear):
        return False
    if w_gu.values.dtype != torch.uint8 or w_down.values.dtype != torch.uint8:
        return False
    m, d = x.shape
    if m > FUSED_MAX_M:
        return False
    h = w_gu.values.shape[1] // 2
    g = d // w_gu.scales.shape[0]
    if w_down.scales.shape[0] * g != h:
        return False  # mismatched group sizes
    if (h // 2) % g != 0 or (d // 2) % g != 0:
        return False
    if g % 128 != 0 or d % 256 != 0:
        return False
    return True


def _check_fused_operands(x, norm_scale, gu_packed, gu_scales, down_packed,
                          down_scales) -> int:
    """Validate the fused block's operands; returns the group size."""
    if x.dim() != 2 or norm_scale.dim() != 1:
        raise ValueError("fused_mlp_q4 takes x (M, D) and norm_scale (D,)")
    m, d = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16) or (
            norm_scale.dtype not in (torch.float32, torch.bfloat16)):
        raise TypeError(f"x and norm_scale must be float32 or bfloat16, got "
                        f"{x.dtype} and {norm_scale.dtype}")
    if gu_packed.dtype != torch.uint8 or down_packed.dtype != torch.uint8:
        raise TypeError("packed weights must be uint8")
    if gu_scales.dtype != torch.float32 or down_scales.dtype != torch.float32:
        raise TypeError("scales must be float32")
    if not 1 <= m <= FUSED_MAX_M:
        raise ValueError(f"the fused block takes 1 <= M <= {FUSED_MAX_M}, "
                         f"got {m}")
    two_h = gu_packed.shape[1]
    h = two_h // 2
    g = d // gu_scales.shape[0] if gu_scales.shape[0] else 0
    if (norm_scale.shape[0] != d or gu_packed.shape[0] * 2 != d
            or gu_scales.shape[1] != two_h or two_h % 2
            or down_packed.shape != (h // 2, d) or down_scales.shape[1] != d
            or not g or d % g or down_scales.shape[0] * g != h):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, gu {tuple(gu_packed.shape)}"
            f" + {tuple(gu_scales.shape)}, down {tuple(down_packed.shape)} + "
            f"{tuple(down_scales.shape)}")
    return g


class FusedPlan(NamedTuple):
    """How ``csrc/fused_mlp_q4.cu`` splits one call: ``rows`` is M rounded
    up to the kernel's row count (1, 2, 4 or 8), ``blocks`` the grid (one
    block an SM at most), ``tile_pairs`` the hidden pairs of a phase-A tile,
    ``chunk_a`` the W_gu rows and ``slice_cols`` the output columns of a
    unit, ``units_a`` and ``units_b`` the (tile, chunk) and (slice, chunk)
    units of its two phases, ``scratch_floats`` its f32 scratch (act (H/2,
    2, rows), then a (rows, 4 tile_pairs) and a (rows, slice_cols) partial
    a block) and ``smem_bytes`` the shared memory a block needs."""
    rows: int
    blocks: int
    tile_pairs: int
    chunk_a: int
    slice_cols: int
    units_a: int
    units_b: int
    scratch_floats: int
    smem_bytes: int


def fused_plan(m: int, d: int, h: int, g: int, sms: int) -> FusedPlan:
    """The kernel's split of an (M, D) x (D, 2H) x (H, D) block over
    ``sms`` SMs, with the kernel's shape rules; raises ValueError on a shape
    the kernel does not take."""
    if (d % 128 or (h // 2) % 128 or g % CHUNK_B or (d // 2) % g
            or (h // 2) % g):
        raise ValueError(
            f"the kernel needs D and H/2 to be multiples of 128 and G a "
            f"multiple of {CHUNK_B} dividing D/2 and H/2 (D={d}, H={h}, "
            f"G={g})")
    rows = 1 if m == 1 else 2 if m == 2 else 4 if m <= 4 else 8
    tile_pairs, chunk_a = _TILE_PAIRS[rows], _CHUNK_A[rows]
    slice_cols, row_a = _SLICE_COLS[rows], 4 * _TILE_PAIRS[rows]
    stage_a = chunk_a * row_a + 2 * row_a * 4
    stage_b = (CHUNK_B * slice_cols + CHUNK_B * 2 * rows * 4
               + 2 * slice_cols * 4)
    smem = (max(d * rows * 4 + _STAGES * stage_a, _STAGES * stage_b)
            + _THREADS[rows] * _COLS[rows] * rows * 4
            + rows * max(row_a, slice_cols) * 4)
    if smem > _MAX_SMEM:
        raise ValueError(f"the kernel keeps rmsnorm(x) in shared memory: "
                         f"M={m} rounds to {rows} rows, and {rows} x D={d} "
                         f"needs {smem} bytes, more than {_MAX_SMEM}")
    units_a = (h // 2 // tile_pairs) * (d // 2 // chunk_a)
    units_b = (d // slice_cols) * (h // 2 // CHUNK_B)
    blocks = min(sms, max(units_a, units_b))
    scratch = rows * (h + blocks * (row_a + slice_cols))
    return FusedPlan(rows, blocks, tile_pairs, chunk_a, slice_cols, units_a,
                     units_b, scratch, smem)


def unit_ranges(units: int, blocks: int) -> list:
    """Block b's units [units * b // blocks, units * (b + 1) // blocks), as
    the kernel's ``unit_begin`` computes them."""
    return [(units * b // blocks, units * (b + 1) // blocks)
            for b in range(blocks)]


_FLAGS = {}
_fused_mlp = _build.Launcher("trackie_fused_mlp_q4", "fused_mlp_q4")


def _flags(device: torch.device) -> torch.Tensor:
    """The kernel's int32 flags on ``device``, two an SM: zero before the
    first launch, and each launch leaves them zero (the block that waits on
    a flag clears it), so one tensor serves every launch in stream order."""
    flags = _FLAGS.get(device)
    if flags is None:
        flags = torch.zeros(2 * torch.cuda.get_device_properties(
            device).multi_processor_count, dtype=torch.int32, device=device)
        _FLAGS[device] = flags
    return flags


def fused_mlp_q4(x: torch.Tensor, norm_scale: torch.Tensor,
                 gu_packed: torch.Tensor, gu_scales: torch.Tensor,
                 down_packed: torch.Tensor, down_scales: torch.Tensor,
                 eps: float = 1e-5) -> torch.Tensor:
    """One-launch MLP block: x (M, D) -> x + down(silu(gate) * up)
    (rmsnorm(x)), in x's dtype; gu (D/2, 2H) u8 + (D/G, 2H) f32, down
    (H/2, D) u8 + (H/G, D) f32.

    Replaces ``trackiellm_tpu/ops/fused.py:fused_mlp_q4_pallas``. A CUDA
    tensor launches ``csrc/fused_mlp_q4.cu`` (see its header for what
    bounds it on the H100 and what its design does about that) or raises;
    a CPU tensor takes :func:`fused_mlp_ref`."""
    g = _check_fused_operands(x, norm_scale, gu_packed, gu_scales,
                              down_packed, down_scales)
    if not is_cuda(x):
        return fused_mlp_ref(x, norm_scale,
                             QuantizedLinear(gu_packed, gu_scales),
                             QuantizedLinear(down_packed, down_scales), eps)
    operands = (x, norm_scale, gu_packed, gu_scales, down_packed, down_scales)
    if any(t.device != x.device for t in operands):
        raise ValueError("every operand must be on x's device")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("every operand must be contiguous")
    if any(t.data_ptr() % 16 for t in (x, *operands[2:])):
        raise ValueError("x, the packed weights and the scales must be "
                         "16-byte aligned (the kernel reads them 16 bytes at "
                         "a time)")
    m, d = x.shape
    h = gu_packed.shape[1] // 2
    plan = fused_plan(m, d, h, g, torch.cuda.get_device_properties(
        x.device).multi_processor_count)   # blocks <= SMs: fits the flags
    scratch = torch.empty(plan.scratch_floats, dtype=torch.float32,
                          device=x.device)
    out = torch.empty_like(x)
    _fused_mlp(
        x.data_ptr(), norm_scale.data_ptr(), gu_packed.data_ptr(),
        gu_scales.data_ptr(), down_packed.data_ptr(), down_scales.data_ptr(),
        scratch.data_ptr(), _flags(x.device).data_ptr(),
        out.data_ptr(), m, d, h, g, 0 if x.dtype == torch.float32 else 1,
        0 if norm_scale.dtype == torch.float32 else 1, eps, plan.blocks,
        _build.stream(x))
    fused_mlp_q4.launches += 1
    return out


fused_mlp_q4.launches = 0


def fused_mlp(x: torch.Tensor, norm_scale: torch.Tensor,
              w_gu: QuantizedLinear, w_down: QuantizedLinear,
              eps: float) -> torch.Tensor:
    """Drop-in for the norm -> gate/up -> silu * up -> down -> residual
    block: a CPU tensor takes :func:`fused_mlp_ref`, a CUDA tensor the
    kernel. Callers gate on :func:`use_fused_mlp` and :func:`_can_fuse`
    (``models/llm.py:_mlp_block`` does)."""
    if not is_cuda(x):
        return fused_mlp_ref(x, norm_scale, w_gu, w_down, eps)
    return fused_mlp_q4(x, norm_scale, w_gu.values, w_gu.scales,
                        w_down.values, w_down.scales, eps)
