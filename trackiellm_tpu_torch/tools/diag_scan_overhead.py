"""What an op, a graph replay and a grid step cost on the card.

Twin of the JAX package's ``tools/diag_scan_overhead.py``; every probe is
timed on the host clock over its executions, ending in one synchronize,
and prints ms per execution:

  - scanN: N trivial f32 body steps (two torch ops each) captured in one
    CUDA graph, N in {8, 64, 512}: the slope is the per-step cost inside a
    graph, the intercept the cost of one replay (the counterpart of one jit
    program with a scan);
  - unroll64: the same 64 steps as eager ops;
  - grid64: one launch of the near-empty kernel (``ops/diag.py:grid64``),
    one block that runs 64 steps of o = x + 1 on the resident tile;
  - what a grid step costs on the device: grid64 with 1 and with 64 steps,
    each as a chain of 64 calls captured in a CUDA graph and timed by CUDA
    events, their difference over 63 (launch and graph costs cancel);
  - 1, 8 and 64 separate eager executions of one body step.

    python -m trackiellm_tpu_torch.tools.diag_scan_overhead
"""

from __future__ import annotations

import sys
from typing import Dict, Sequence

import torch

from trackiellm_tpu_torch.ops import diag
from trackiellm_tpu_torch.tools import capture, cuda_device, device_ms, host_ms

N_OUTER = 8
SCAN_LENGTHS = (8, 64, 512)
UNROLL = 64
EXECUTIONS = (1, 8, 64)
STEP_CHAIN = 64       # grid64 calls in the captured chain a step is read from


def body(x: torch.Tensor) -> torch.Tensor:
    return x * 1.0000001 + 0.0000001


def _timed(fn, dev: torch.device, label: str, n_outer: int) -> float:
    ms = host_ms(fn, dev, n_outer)
    print(f"{label:22s} {ms:9.4f} ms/exec", flush=True)
    return ms


def grid_steps(x: torch.Tensor, dev: torch.device, n_calls: int = STEP_CHAIN,
               n_outer: int = N_OUTER) -> Dict[str, float]:
    """Device ms per grid64 call with 1 and GRID_STEPS steps (a chain of
    ``n_calls`` calls in a CUDA graph, timed by CUDA events), and what one
    step costs in us: their difference over GRID_STEPS - 1."""
    def chain(steps):
        def run_chain():
            for _ in range(n_calls):
                y = diag.grid64(x, steps)
            return y
        return run_chain

    one, full = (device_ms(capture(chain(n), dev), dev, n_outer) / n_calls
                 for n in (1, diag.GRID_STEPS))
    step_us = (full - one) * 1e3 / (diag.GRID_STEPS - 1)
    print(f"{'grid64, 1 step':22s} {one:9.4f} ms/call (device)\n"
          f"{f'grid64, {diag.GRID_STEPS} steps':22s} {full:9.4f} ms/call "
          f"(device)\n{'grid step':22s} {step_us:9.4f} us", flush=True)
    return {"grid64 1 step": one, f"grid64 {diag.GRID_STEPS} steps": full,
            "grid step us": step_us}


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
    out.update(grid_steps(x, dev, n_outer=n_outer))
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
