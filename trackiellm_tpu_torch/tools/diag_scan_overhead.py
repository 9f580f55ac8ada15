"""What an op, a graph replay and a grid step cost on the card.

Twin of the JAX package's ``tools/diag_scan_overhead.py``; every probe is
timed on the host clock over its executions, ending in one synchronize,
and prints ms per execution:

  - scanN: N trivial f32 body steps (two torch ops each) captured in one
    CUDA graph, N in {8, 64, 512}: the slope is the per-step cost inside a
    graph, the intercept the cost of one replay (the counterpart of one jit
    program with a scan);
  - unroll64: the same 64 steps as eager ops;
  - grid64: one launch of the near-empty kernel (``ops/diag.py:grid64``) with
    64 blocks on the one tile;
  - 1, 8 and 64 separate eager executions of one body step.

    python -m trackiellm_tpu_torch.tools.diag_scan_overhead
"""

from __future__ import annotations

import sys
from typing import Dict, Sequence

import torch

from trackiellm_tpu_torch.ops import diag
from trackiellm_tpu_torch.tools import capture, cuda_device, host_ms

N_OUTER = 8
SCAN_LENGTHS = (8, 64, 512)
UNROLL = 64
EXECUTIONS = (1, 8, 64)


def body(x: torch.Tensor) -> torch.Tensor:
    return x * 1.0000001 + 0.0000001


def _timed(fn, dev: torch.device, label: str, n_outer: int) -> float:
    ms = host_ms(fn, dev, n_outer)
    print(f"{label:22s} {ms:9.4f} ms/exec", flush=True)
    return ms


def run(dev: torch.device, scan_lengths: Sequence[int] = SCAN_LENGTHS,
        unroll: int = UNROLL, executions: Sequence[int] = EXECUTIONS,
        n_outer: int = N_OUTER, seed: int = 0) -> Dict[str, float]:
    """Every probe; returns ms per execution by label."""
    x = torch.randn(diag.TILE, generator=torch.Generator(
        device=dev).manual_seed(seed), device=dev)

    def steps(n):
        def run_steps():
            y = x
            for _ in range(n):
                y = body(y)
            return y
        return run_steps

    out = {}
    for n in scan_lengths:
        out[f"scan{n}"] = _timed(capture(steps(n), dev), dev, f"scan{n}",
                                 n_outer)
    out[f"unroll{unroll}"] = _timed(steps(unroll), dev, f"unroll{unroll}",
                                    n_outer)
    out["grid64"] = _timed(lambda: diag.grid64(x), dev,
                           f"kernel grid={diag.GRID_STEPS}", n_outer)
    for n in executions:
        out[f"{n} exec"] = _timed(lambda: body(x), dev, f"{n} exec trivial",
                                  n)
    return out


def main() -> int:
    dev = cuda_device("diag_scan_overhead")
    if dev is None:
        return 1
    run(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
