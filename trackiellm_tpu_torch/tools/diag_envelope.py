"""The card's device-memory stream envelope and how decode time composes.

Twin of the JAX package's ``tools/diag_envelope.py``:

  - envelope: a 512 MiB uint8 array summed by the stream kernel
    (``ops/diag.py:stream``) and by its plain version (an f32 sum), each
    timed by CUDA events and reported in GB/s; the two results must agree;
  - decode L=32/16/8: Mistral-7B Q4 (random weights from a seed) cut to 32,
    16 and 8 layers (views of the stacked layer tensors), a 128-token
    prefill, 4 warm and 32 timed greedy ``decode_step``s at ``attn_len``
    256; the slope is the cost of one layer, the intercept what a token
    costs besides the layers;
  - greedy chunks=16: ``generate_greedy`` in chunks of 16 tokens against
    the serial loop above, at 32 layers.

Step times are host-clock times around work that ends in a synchronize.

    python -m trackiellm_tpu_torch.tools.diag_envelope
"""

from __future__ import annotations

import sys
import time
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from trackiellm_tpu_torch.models import llm
from trackiellm_tpu_torch.ops import diag
from trackiellm_tpu_torch.ops.quant import QuantizedLinear
from trackiellm_tpu_torch.tools import cuda_device, device_ms, sync

MIB = 2 ** 20
STREAM_BYTES = 512 * MIB
COLS = 4096
ROWS = STREAM_BYTES // COLS
STREAM_TOL = 1e-5   # rel: the plain version's f32 sum against an exact one
N_STREAM = 10
LAYERS = (32, 16, 8)
PROMPT = 128
ATTN_LEN = 256
SEED = 0


def envelope(dev: torch.device, rows: int = ROWS, cols: int = COLS,
             n: int = N_STREAM, seed: int = SEED) -> Dict[str, float]:
    """ms per call and GB/s of the stream kernel and its plain version over
    a (rows, cols) uint8 array; raises if their results differ by more than
    ``STREAM_TOL`` relative."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randint(0, 255, (rows, cols), generator=gen, device=dev,
                      dtype=torch.uint8)
    x = torch.randn((1, 1), generator=gen, device=dev)
    got, ref = diag.stream(x, w), diag.stream_ref(x, w)
    err = ((got - ref).abs() / ref.abs()).item()
    if not err <= STREAM_TOL:
        raise AssertionError(f"stream: kernel {got.item()} and plain "
                             f"{ref.item()} differ by {err:.3e} relative")
    out = {"rel_err": err, "bytes": float(w.numel())}
    for label, fn in (("kernel", diag.stream), ("plain", diag.stream_ref)):
        ms = device_ms(lambda fn=fn: fn(x, w), dev, n)
        out[f"{label}_ms"] = ms
        out[f"{label}_gb_s"] = w.numel() / ms / 1e6
        print(f"envelope {label:9s} {ms:9.4f} ms  {w.numel() / ms / 1e6:8.1f}"
              f" GB/s ({w.numel() / MIB:.0f} MiB)", flush=True)
    print(f"envelope kernel vs plain: rel err {err:.3e} (tol {STREAM_TOL:.0e})",
          flush=True)
    return out


def layer_slice(params: Dict[str, Any], n_layers: int) -> Dict[str, Any]:
    """The params with the first ``n_layers`` layers: views, no copies."""
    layers = {}
    for name, w in params["layers"].items():
        if isinstance(w, QuantizedLinear):
            layers[name] = QuantizedLinear(w.values[:n_layers],
                                           w.scales[:n_layers])
        else:
            layers[name] = w[:n_layers]
    return {**params, "layers": layers}


def _prefilled(params, cfg: llm.LLMConfig, dev: torch.device, prompt: int,
               seed: int) -> Tuple[torch.Tensor, llm.KVCache]:
    """The first greedy token (on the device) after a ``prompt``-token
    prefill of random ids, and the cache."""
    toks = torch.randint(0, cfg.vocab_size, (prompt,), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(
                             seed))
    logits, cache = llm.prefill(params, cfg, toks, prompt,
                                llm.KVCache.create(cfg, device=dev))
    return torch.argmax(logits), cache


def time_decode(params, cfg: llm.LLMConfig, dev: torch.device,
                prompt: int = PROMPT, attn_len: int = ATTN_LEN,
                n_warm: int = 4, n_tokens: int = 32,
                seed: int = SEED) -> float:
    """ms per token of the serial greedy loop (decode_step, then argmax on
    the device), timed over ``n_tokens`` after ``n_warm``."""
    tok, cache = _prefilled(params, cfg, dev, prompt, seed)
    for _ in range(n_warm):
        logits, cache = llm.decode_step(params, cfg, tok, cache,
                                        attn_len=attn_len)
        tok = torch.argmax(logits)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(n_tokens):
        logits, cache = llm.decode_step(params, cfg, tok, cache,
                                        attn_len=attn_len)
        tok = torch.argmax(logits)
    sync(dev)
    ms = (time.perf_counter() - t0) * 1e3 / n_tokens
    if not torch.isfinite(logits).all():
        raise AssertionError("decode: non-finite logits")
    print(f"decode L={cfg.n_layers:<3d}      {ms:9.3f} ms/token "
          f"{1e3 / ms:8.2f} tok/s", flush=True)
    return ms


def time_greedy_chunks(params, cfg: llm.LLMConfig, dev: torch.device,
                       chunk: int = 16, n_chunks: int = 3,
                       prompt: int = PROMPT, attn_len: int = ATTN_LEN,
                       seed: int = SEED) -> float:
    """ms per token of ``generate_greedy`` in chunks of ``chunk`` tokens,
    timed over ``n_chunks`` after one warm chunk."""
    tok, cache = _prefilled(params, cfg, dev, prompt, seed)
    out, cache = llm.generate_greedy(params, cfg, tok, cache, chunk,
                                     attn_len=attn_len)
    tok = out[-1]
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        out, cache = llm.generate_greedy(params, cfg, tok, cache, chunk,
                                         attn_len=attn_len)
        tok = out[-1]
    sync(dev)
    ms = (time.perf_counter() - t0) * 1e3 / (n_chunks * chunk)
    if not 0 <= int(out.min()) <= int(out.max()) < cfg.vocab_size:
        raise AssertionError(f"greedy: token ids out of range: {out}")
    print(f"greedy chunks={chunk:<3d}  {ms:9.3f} ms/token "
          f"{1e3 / ms:8.2f} tok/s", flush=True)
    return ms


def decode_composition(params, cfg: llm.LLMConfig, dev: torch.device,
                       layers: Sequence[int] = LAYERS, prompt: int = PROMPT,
                       attn_len: int = ATTN_LEN, n_tokens: int = 32,
                       chunk: int = 16, n_chunks: int = 3) -> Dict[str, Any]:
    """Decode at each layer count (none above ``cfg.n_layers``), the linear
    fit ms/token = slope * layers + intercept, and greedy chunks at the
    first count."""
    ms = {}
    for n in layers:
        ms[n] = time_decode(layer_slice(params, n), cfg._replace(n_layers=n),
                            dev, prompt=prompt, attn_len=attn_len,
                            n_tokens=n_tokens)
    slope, intercept = np.polyfit(list(ms), list(ms.values()), 1)
    print(f"decode fit: {slope:.4f} ms/layer + {intercept:.3f} ms/token",
          flush=True)
    first = layers[0]
    greedy = time_greedy_chunks(layer_slice(params, first),
                                cfg._replace(n_layers=first), dev,
                                chunk=chunk, n_chunks=n_chunks,
                                prompt=prompt, attn_len=attn_len)
    return {"decode_ms": ms, "slope_ms": float(slope),
            "intercept_ms": float(intercept), "greedy_ms": greedy,
            "serial_ms": ms[first]}


def main() -> int:
    dev = cuda_device("diag_envelope")
    if dev is None:
        return 1
    envelope(dev)
    cfg = llm.LLMConfig.mistral_7b()._replace(max_seq=512, sliding_window=512)
    params = llm.init_params_quantized(
        torch.Generator(device=dev).manual_seed(SEED), cfg, bits=4,
        device=dev)
    decode_composition(params, cfg, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
