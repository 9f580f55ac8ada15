"""Diagnostic tools, the twins of the JAX package's ``tools/diag_*.py``.

    python -m trackiellm_tpu_torch.tools.diag_overhead       # per-call cost
    python -m trackiellm_tpu_torch.tools.diag_scan_overhead  # per-op, graph
    python -m trackiellm_tpu_torch.tools.diag_envelope       # HBM, decode

Each times one CUDA card and prints the card's name and power limit first;
its ``main()`` exits non-zero without a card, so no plain path is timed on
the CPU in a card's name. Their measurement functions take the device and
the sizes as arguments. On a CPU device (the tests, for control flow only)
a "graph" is the function itself and every time comes from the host clock.
"""

from __future__ import annotations

import subprocess
import sys
import time
from typing import Callable, Optional

import torch


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=30)
    return out.stdout.strip().splitlines()[0]


def cuda_device(tool: str) -> Optional[torch.device]:
    """The first CUDA device, after printing the card line; None, with a
    message on stderr, where there is none."""
    if not torch.cuda.is_available():
        print(f"{tool}: no CUDA device; this diagnostic times the card only",
              file=sys.stderr)
        return None
    print(card(), flush=True)
    return torch.device("cuda", 0)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def capture(fn: Callable[[], torch.Tensor],
            dev: torch.device) -> Callable[[], torch.Tensor]:
    """``fn`` captured once in a CUDA graph, after two warm-up calls on a
    side stream; the returned callable replays it and returns the graph's
    static output. ``fn`` must read only tensors that outlive the graph.
    Launch counters count the launches of the warm-up and of the capture,
    not of the replays. On a CPU device: ``fn`` itself."""
    if dev.type != "cuda":
        return fn
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()

    def replay() -> torch.Tensor:
        graph.replay()
        return out

    replay.graph = graph  # the graph lives as long as the callable
    return replay


def host_ms(fn: Callable[[], object], dev: torch.device, n: int) -> float:
    """Mean ms per call of ``fn`` on the host clock, over ``n`` calls
    enqueued back to back and one synchronize, after one warm-up call:
    host dispatch included."""
    fn()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    sync(dev)
    return (time.perf_counter() - t0) * 1e3 / n


def device_ms(fn: Callable[[], object], dev: torch.device, n: int) -> float:
    """Mean device ms per call of ``fn`` between two CUDA events around
    ``n`` calls, after one warm-up call (the host clock on a CPU device)."""
    if dev.type != "cuda":
        return host_ms(fn, dev, n)
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n
