"""The kernels of the diagnostic probes.

Port of the Pallas kernels that the JAX package's diagnostic tools time, each
beside its plain PyTorch twin (``*_ref``), all in ``csrc/diag_probes.cu``:
``stream`` replaces ``tools/diag_envelope.py:stream_pallas`` (the
device-memory stream envelope), ``grid64`` replaces
``tools/diag_scan_overhead.py:grid64`` (a grid of 64 steps on one tile) and
``chain_tiny`` replaces ``tools/diag_overhead.py:chain_tiny`` (a chain of
dependent near-empty calls). Both compute ``o = x + 1``: ``grid64`` as one
block that runs the steps of the TPU grid as a loop on the resident tile,
``chain_tiny`` as one one-block launch a call, all ``n`` of them issued by
one host call with programmatic dependent launch. The tools that time them
are in ``trackiellm_tpu_torch/tools/``.
"""

from __future__ import annotations

import torch

from trackiellm_tpu_torch.ops import _build
from trackiellm_tpu_torch.ops.backend import is_cuda

GRID_STEPS = 64       # grid=(64,) of tools/diag_scan_overhead.py:grid64
GRID_MAX = 1024       # floats grid64's one block holds (4 a thread of 256)
CHAIN = 64            # N_CHAIN of tools/diag_overhead.py
TILE = (8, 128)       # the near-empty kernels' f32 tile
_STREAM_BLOCKS_PER_SM = 8

_stream_sum = _build.Launcher("trackie_stream_sum", "stream")
_grid64 = _build.Launcher("trackie_grid64", "grid64")
_add_one_chain = _build.Launcher("trackie_add_one_chain", "chain_tiny")


def _check_stream(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.shape != (1, 1) or x.dtype != torch.float32:
        raise ValueError(f"x must be (1, 1) float32, got {tuple(x.shape)} "
                         f"{x.dtype}")
    if w.dtype != torch.uint8:
        raise TypeError(f"w must be uint8, got {w.dtype}")


def stream_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`stream` (``stream_xla``): the f32 sum of ``w``
    times ``x[0, 0]``, as (1, 1) f32."""
    _check_stream(x, w)
    return (w.float().sum() * x[0, 0]).reshape(1, 1)


def stream(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(1, 1) f32 = x[0, 0] * the sum of the uint8 array ``w``.

    A CUDA tensor launches ``csrc/diag_probes.cu``'s exact integer
    reduction (see its header) or raises; a CPU tensor takes
    :func:`stream_ref`."""
    _check_stream(x, w)
    if not is_cuda(w):
        return stream_ref(x, w)
    if x.device != w.device:
        raise ValueError("x and w must be on one device")
    if not w.is_contiguous() or w.data_ptr() % 16:
        raise ValueError("w must be contiguous and 16-byte aligned")
    x = x.contiguous()
    blocks = (_STREAM_BLOCKS_PER_SM
              * torch.cuda.get_device_properties(w.device).multi_processor_count)
    partial = torch.empty((blocks,), dtype=torch.int64, device=w.device)
    out = torch.empty((1, 1), dtype=torch.float32, device=w.device)
    _stream_sum(x.data_ptr(), w.data_ptr(), w.numel(), partial.data_ptr(),
                blocks, out.data_ptr(), _build.stream(w))
    stream.launches += 1
    return out


stream.launches = 0


def _check_tile(x: torch.Tensor) -> None:
    if x.dtype != torch.float32 or x.numel() == 0:
        raise TypeError(f"x must be a non-empty float32 tensor, got "
                        f"{x.dtype} {tuple(x.shape)}")


def _check_steps(steps: int) -> None:
    if steps < 1:
        raise ValueError(f"steps must be at least 1, got {steps}")


def grid64_ref(x: torch.Tensor, steps: int = GRID_STEPS) -> torch.Tensor:
    """Plain twin of :func:`grid64`: x + 1 (every step writes the same
    value)."""
    _check_tile(x)
    _check_steps(steps)
    return x + 1.0


def grid64(x: torch.Tensor, steps: int = GRID_STEPS) -> torch.Tensor:
    """x + 1 by one launch of one block that loads x once, runs ``steps``
    steps of ``o = x + 1`` on it as a loop, as the TPU grid of 64 steps
    does on its one resident block, and stores o once. A CUDA tensor (at
    most GRID_MAX floats) launches the kernel or raises; a CPU tensor takes
    :func:`grid64_ref`."""
    _check_tile(x)
    _check_steps(steps)
    if not is_cuda(x):
        return grid64_ref(x, steps)
    if x.numel() > GRID_MAX:
        raise ValueError(f"grid64 takes at most {GRID_MAX} floats, got "
                         f"{x.numel()}")
    x = x.contiguous()
    out = torch.empty_like(x)
    _grid64(x.data_ptr(), out.data_ptr(), x.numel(), steps, _build.stream(x))
    grid64.launches += 1
    return out


grid64.launches = 0


def chain_tiny_ref(x: torch.Tensor, n: int = CHAIN) -> torch.Tensor:
    """Plain twin of :func:`chain_tiny`: ``n`` times x = x + 1."""
    _check_tile(x)
    for _ in range(n):
        x = x + 1.0
    return x


def chain_tiny(x: torch.Tensor, n: int = CHAIN) -> torch.Tensor:
    """``n`` (at least 1) dependent one-block launches of x + 1, each
    reading the last one's output; returns a new tensor. A CUDA tensor makes
    one call into ``csrc/diag_probes.cu``, which issues the ``n`` launches
    with programmatic dependent launch, ping-ponging between the output and
    one scratch tile, and the count rises by ``n``; or it raises. A CPU
    tensor takes :func:`chain_tiny_ref`."""
    _check_tile(x)
    if n < 1:
        raise ValueError(f"n must be at least 1, got {n}")
    if not is_cuda(x):
        return chain_tiny_ref(x, n)
    x = x.contiguous()
    out = torch.empty_like(x)
    scratch = torch.empty_like(x) if n > 1 else None
    _add_one_chain(x.data_ptr(), out.data_ptr(),
                   scratch.data_ptr() if scratch is not None else None,
                   x.numel(), n, _build.stream(x))
    chain_tiny.launches += n
    return out


chain_tiny.launches = 0
