"""What one kernel call costs on the card, eager and inside a CUDA graph.

Twin of the JAX package's ``tools/diag_overhead.py``. Each probe is a chain
of 64 dependent calls (each reads the last one's output):

  - the near-empty kernel (``ops/diag.py:chain_tiny``, x + 1 on (8, 128)),
    timed eager (host dispatch included) and captured once in a CUDA graph
    and replayed (the counterpart of one jit program, which leaves per-call
    host dispatch out), three ways: the chain from one host call (the port
    of the JAX tool's scan: the C side issues the 64 launches with
    programmatic dependent launch), one host call a launch
    (``chain_tiny(x, 1)`` from Python: the per-launch path every kernel
    wrapper takes), and ``x + 1`` one torch call a launch;
  - the read of the current stream's handle that every launch makes, on the
    host: through ``torch.cuda.current_stream`` and as the wrappers read
    it (``ops/_build.py:stream``);
  - the streaming Q4 matmul (``ops/quant.py:q4_matmul_stream``) at (K, N) =
    (4096, 4096), Mistral-7B's ``wo`` (8.4 MB packed), M = 1, in a graph,
    over (tile_k, tile_n) pairs that change the count of staged chunks at
    constant bytes; us per call = a * chunks + b is fitted as the JAX tool
    fits grid steps. Each call is followed by the JAX tool's renormalization
    (three torch ops), timed alone beside it; ``q4_matmul_f32a`` at the same
    shape is timed the same way;
  - an rmsnorm chain in torch ops, eager and in a graph.

    python -m trackiellm_tpu_torch.tools.diag_overhead
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from trackiellm_tpu_torch.ops import _build, diag, quant
from trackiellm_tpu_torch.tools import capture, cuda_device, device_ms, host_ms

N_CHAIN = 64
N_OUTER = 8
K, N = 4096, 4096
GROUP = 256
# (tile_k, tile_n); staged chunks per call = (N / tile_n) * (K / 2 / tile_k)
SWEEP = ((2048, 32), (1024, 64), (1024, 32), (512, 64), (512, 32),
         (256, 64), (256, 32), (256, 16))


def chain_us(chain: Callable[[], torch.Tensor], dev: torch.device,
             n_calls: int, n_outer: int = N_OUTER) -> Tuple[float, float]:
    """(eager, graph) us per call of a chain of ``n_calls`` calls: eager on
    the host clock with a synchronize after ``n_outer`` chains; the graph
    (the chain captured once) by CUDA events over ``n_outer`` replays."""
    eager = host_ms(chain, dev, n_outer) * 1e3 / n_calls
    graph = device_ms(capture(chain, dev), dev, n_outer) * 1e3 / n_calls
    return eager, graph


def _renorm(y: torch.Tensor) -> torch.Tensor:
    """The JAX tool's step between calls: keeps the chain finite."""
    return y / (y.abs().amax() + 1e-6)


def tiny(dev: torch.device, n_chain: int = N_CHAIN,
         n_outer: int = N_OUTER) -> Dict[str, Tuple[float, float]]:
    """(eager, graph) us per launch of the near-empty kernel: the chain
    from one host call, one host call a launch, and ``x + 1`` a launch."""
    x = torch.zeros(diag.TILE, dtype=torch.float32, device=dev)

    def a_launch(call):
        def chain():
            y = x
            for _ in range(n_chain):
                y = call(y)
            return y
        return chain

    rows = {"chain from one call": lambda: diag.chain_tiny(x, n_chain),
            "chain_tiny(x, 1) a launch": a_launch(
                lambda y: diag.chain_tiny(y, 1)),
            "x + 1 a launch": a_launch(lambda y: y + 1.0)}
    out = {}
    for label, chain in rows.items():
        eager, graph = chain_us(chain, dev, n_chain, n_outer)
        print(f"{label:28s} eager {eager:9.2f} us/call  "
              f"graph {graph:9.2f} us/call", flush=True)
        out[label] = (eager, graph)
    return out


def stream_handle_us(dev: torch.device, n: int = 10000) -> Dict[str, float]:
    """us per read of the current stream's handle on the host clock:
    ``torch.cuda.current_stream(dev).cuda_stream`` (a ``Stream`` object a
    read) and ``_build.stream`` (the raw handle). A CUDA device only."""
    if dev.type != "cuda":
        raise ValueError(f"reads a CUDA stream; got a {dev.type} device")
    x = torch.zeros(1, device=dev)
    out = {"torch.cuda.current_stream": host_ms(
               lambda: torch.cuda.current_stream(dev).cuda_stream, dev, n),
           "_build.stream": host_ms(lambda: _build.stream(x), dev, n)}
    out = {k: v * 1e3 for k, v in out.items()}
    for label, us in out.items():
        print(f"stream handle by {label:26s} {us:9.3f} us", flush=True)
    return out


def q4_sweep(dev: torch.device, k: int = K, n: int = N, group: int = GROUP,
             sweep: Sequence[Tuple[int, int]] = SWEEP,
             n_chain: int = N_CHAIN, n_outer: int = N_OUTER,
             seed: int = 0) -> Dict[str, object]:
    """The Q4 chain in a graph over the tile pairs, the fit, the renorm
    alone and ``q4_matmul_f32a`` at the same shape; us per call."""
    if k != n:  # the chain feeds each output back in
        raise ValueError(f"the chain needs K == N, got {k} and {n}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    qw = quant.quantize_q4(
        torch.randn((k, n), generator=gen, device=dev) / 64.0, group)
    x = torch.randn((1, k), generator=gen, device=dev)

    def chain(matmul):
        def run():
            y = x
            for _ in range(n_chain):
                y = _renorm(matmul(y))
            return y
        return run

    print(f"--- q4_matmul_stream {k}x{n} ({k // 2 * n / 1e6:.1f} MB packed),"
          f" chain of {n_chain} in a CUDA graph ---", flush=True)
    rows = []
    for tile_k, tile_n in sweep:
        chunks = (n // tile_n) * (k // 2 // tile_k)
        _, us = chain_us(chain(lambda y, tk=tile_k, tn=tile_n:
                               quant.q4_matmul_stream(y, qw.values, qw.scales,
                                                      tile_n=tn, tile_k=tk)),
                         dev, n_chain, n_outer)
        print(f"tiles=({tile_k},{tile_n}) chunks={chunks:5d} "
              f"({k // 2 // tile_k}/block) {us:9.2f} us/call", flush=True)
        rows.append((tile_k, tile_n, chunks, us))
    a, b = np.polyfit([r[2] for r in rows], [r[3] for r in rows], 1)
    mb = k // 2 * n / 1e6
    print(f"fit: {a:.4f} us/chunk + {b:.2f} us/call base (stream {mb:.1f} MB"
          f" -> {mb / b * 1e3:.0f} GB/s if base were pure stream)",
          flush=True)
    _, renorm = chain_us(chain(lambda y: y), dev, n_chain, n_outer)
    _, f32a = chain_us(chain(lambda y: quant.q4_matmul_f32a(
        y, qw.values, qw.scales)), dev, n_chain, n_outer)
    print(f"{'renorm alone':28s} {renorm:9.2f} us/call\n"
          f"{'q4_matmul_f32a':28s} {f32a:9.2f} us/call", flush=True)
    return {"sweep": rows, "fit": (float(a), float(b)), "renorm_us": renorm,
            "f32a_us": f32a}


def rmsnorm(dev: torch.device, d: int = K, n_chain: int = N_CHAIN,
            n_outer: int = N_OUTER) -> Tuple[float, float]:
    """(eager, graph) us per step of an rmsnorm chain in torch ops."""
    x = torch.ones((1, d), dtype=torch.float32, device=dev)

    def chain():
        y = x
        for _ in range(n_chain):
            y = y * torch.rsqrt(y.square().mean(dim=-1, keepdim=True) + 1e-5)
        return y

    eager, graph = chain_us(chain, dev, n_chain, n_outer)
    print(f"{'rmsnorm torch ops':28s} eager {eager:9.2f} us/call  "
          f"graph {graph:9.2f} us/call", flush=True)
    return eager, graph


def main() -> int:
    dev = cuda_device("diag_overhead")
    if dev is None:
        return 1
    q4_sweep(dev)
    tiny(dev)
    stream_handle_us(dev)
    rmsnorm(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
