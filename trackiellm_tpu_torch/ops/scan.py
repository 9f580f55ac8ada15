"""Cumulative sums and associative scans in the reference's order.

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

:func:`associative_scan` is ``jax.lax.associative_scan``'s recursion, which
the Mamba models' selective scans run (``models/mamba.py``,
``models/mamba2.py``): torch has no eager twin, and the combine order
decides the bits of every state.
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


def associative_scan(fn, elems, axis: int = 0):
    """Inclusive scan of ``elems`` (a list or tuple of tensors sharing the
    length of ``axis``) under the associative ``fn(left, right)``, which
    takes and returns lists like ``elems``: ``jax.lax.associative_scan``'s
    odd/even recursion (Blelloch), so every element is combined in the
    reference's order and its bits are the reference's wherever ``fn`` is.

    Each level combines adjacent pairs, scans those by recursion (the odd
    outputs), then combines each odd output with the next even input (the
    even outputs). The outputs are written into one fresh tensor a level,
    and a level's pair sums are freed once the recursion returns, so the
    peak is a few times the input, not its log."""
    elems = [e.movedim(axis, 0) for e in elems]
    out = _assoc(fn, elems)
    return [o.movedim(0, axis) for o in out]


def _assoc(fn, elems):
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = fn([e[0:-1:2] for e in elems], [e[1::2] for e in elems])
    odd = _assoc(fn, reduced)
    del reduced
    if n % 2 == 0:
        even = fn([o[:-1] for o in odd], [e[2::2] for e in elems])
    else:
        even = fn(odd, [e[2::2] for e in elems])
    out = []
    for e, ev, od in zip(elems, even, odd):
        shape = torch.broadcast_shapes(ev.shape[1:], od.shape[1:],
                                       e.shape[1:])
        full = e.new_empty((n, *shape),
                           dtype=torch.result_type(ev, od))
        full[0] = e[0]
        full[2::2] = ev
        full[1::2] = od
        out.append(full)
    return out
