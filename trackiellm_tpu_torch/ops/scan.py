"""Cumulative sums in the reference's order.

The JAX package's durations come from ``jnp.cumsum`` of f32 values
(``models/tts.py`` and ``models/vits.py``), then a truncation or a
comparison against frame indices: one ulp can move a frame to the next
phoneme or change the frame count. On the CPU, XLA rewrites a cumulative
sum longer than 16 into blocks of 16: each block summed left to right, the
blocks' totals summed the same way (recursively) and added to the blocks.
``torch.cumsum`` does not: on the CPU it accumulates f32 in f64, on the
card it scans in parallel. :func:`cumsum` repeats XLA's order with f32
adds only, so its bits are the same on the CPU and the card, and equal to
the reference's on the CPU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BLOCK = 16  # XLA's base length for the cumulative-sum rewrite


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum over the last axis, in XLA's CPU order."""
    n = x.shape[-1]
    if n <= BLOCK:
        cols = [x[..., 0]]
        for j in range(1, n):
            cols.append(cols[-1] + x[..., j])
        return torch.stack(cols, dim=-1)
    nb = -(-n // BLOCK)
    blocks = F.pad(x, (0, nb * BLOCK - n)).reshape(*x.shape[:-1], nb, BLOCK)
    local = cumsum(blocks)
    totals = cumsum(local[..., -1])
    before = torch.cat([torch.zeros_like(totals[..., :1]), totals[..., :-1]],
                       dim=-1)
    out = local + before[..., None]
    return out.reshape(*x.shape[:-1], nb * BLOCK)[..., :n]
