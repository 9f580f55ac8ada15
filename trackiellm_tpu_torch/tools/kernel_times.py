"""Time the main path's kernels, the Q8 and f32a matmuls and the fused
MLP block.

    python3 trackiellm_tpu_torch/tools/kernel_times.py [--root DIR]

Imports ``trackiellm_tpu_torch`` from ``--root`` (default: the checkout that
holds this file), builds its CUDA kernels and times, on one card, the
headline cases of ``chip_smoke.py``'s phase 3 for the two kernels the main
path launches: W4A8 ``w_gu`` (K 4096, N 28672, group 256) at M 1 and 512,
and causal bf16 flash attention (H 32, Hk 8, D 128) at S 256 and 512, with
SDPA on the same inputs beside it; and Q8 ``w_gu`` at M 1 and 512 (the
Q8 checkpoint's path), with the device-only time of Q8 on the five
Mistral-7B projections at M 1 and 512 beside that of a dense bf16
``torch.matmul`` of the same shape (a yardstick of the card's rate, not the
same function: its weights are bf16), and, where the checkout has
``_q8_plan``, the bf16 Q8 kernel's device-only ms by groups a K split.
The f32-activation Q4 matmul (``q4_matmul_f32a``, the
``TRACKIE_Q4_F32A=1`` route) is timed the same way, by group pairs a K
split where the checkout has ``_f32a_plan``.
Each call is timed as ``chip_smoke.py``
times it: ``time_ms`` (CUDA events, L2 flushed before each call, a
synchronize after it) and ``device_only_ms`` (the profiler's device clock,
in all and by kernel). The timers and the seed come from the
``chip_smoke.py`` of the checkout that holds this file, so two checkouts
are timed the same way.

Where the checkout's W4A8 takes its tile height from ``_w4a8_plan``, the
kernel is also timed, device only, at M 1, 8 and 16 on the five Mistral-7B
projections at every tile height its C entry takes.

The fused Q4 decode MLP block (``fused_mlp_q4``, D 4096, H 14336, group
256, bf16 x) is timed at M 1, 4 and 8 as ``_times`` reads it, beside the
device-only ms of the unfused block on the default route
(``models/llm.py:_mlp_block`` with the levers unset: W4A8 ``w_gu``,
silu * up, W4A8 ``w_down``, the residual).

The streaming Q4 matmul (``q4_matmul_stream``, the overhead tool's kernel)
is timed as ``_times`` reads it on the five Mistral-7B projections at M 1
and 8, bf16 and f32 x, at the checkout's default tiles, and, device only at
M = 1, over (tile_n, tile_k) at ``wo`` and ``w_gu`` (each pair held against
the plain version first; None where the checkout's tile rule refuses it).
``grid64`` is timed beside ``tile + 1`` (the library call for the same
function), and at 1 step where the checkout's ``grid64`` takes ``steps``.
The 64-call chain (``chain``) is timed three ways: ``chain_tiny`` from one
host call, ``chain_tiny(x, 1)`` from Python a launch, and ``tile + 1`` a
launch (its library chain); each as ``_times`` reads it, then as the
CUDA-event span and the host clock over chains back to back, and replayed
from a CUDA graph. ``decode`` runs ``chip_smoke.py``'s phase-5 profile
window (Mistral-7B, 32 layers, random Q4 weights, default routes) once to
warm up and once to keep: wall, device busy, idle share, launches and the
copy and cast kernels of the bucket-512 prefill and of a decode token.
``prefill`` times a bucket-1024 prefill of the same model at max_seq 2048
(``chip_smoke.py``'s phase-10 long prompt, 600-1000 tokens, on a fresh
cache each time): its wall ms three times after one warm-up, then one
profile (device busy, launches, the largest kernels).

``--only`` picks row sets (default: all). Prints the card line, then one
JSON line. To compare two checkouts, run the tool on each, alternating (A,
B, B, A), back to back on one card. Runs that are not on a CUDA device exit
non-zero.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import inspect
import json
import math
import os
import pathlib
import sys
import time

import torch

CHECKOUT = pathlib.Path(__file__).resolve().parents[2]
DECODE_MS = (1, 8, 16)
TILE_ROWS = (16, 64)   # the tile heights the W4A8 C entry takes
STREAM_SWEEP_N = (16, 32, 64, 128)
STREAM_SWEEP_K = (256, 512, 1024)
STREAM_SWEPT = ("wo", "w_gu")
ROW_SETS = ("main", "fused", "q8", "f32a", "w4a8_tiles", "stream", "grid64",
            "chain", "decode", "prefill")
CHAIN_REPS = 50   # chains back to back in the event and host spans


def _chip_smoke():
    """The ``chip_smoke.py`` of this file's checkout, as a module."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", CHECKOUT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _times(cs, fn) -> dict:
    """ms per call, device-only ms, and device-only ms by kernel name."""
    device = cs.device_only_ms(fn) or {"total": None, "kernels": {}}
    by_kernel = {}
    for name, ms in device["kernels"].items():   # names cut to 72 chars
        by_kernel[name[:72]] = by_kernel.get(name[:72], 0.0) + ms
    return {"ms": cs.time_ms(fn), "device_ms": device["total"],
            "device_kernels": by_kernel}


def _w4a8_at(quant, lib, check, x, w, bm: int):
    """A callable that runs W4A8 on x as the wrapper does, at tile height
    ``bm``; None where the C entry refuses that height."""
    m, k = x.shape
    n = w.values.shape[1]
    g = k // w.scales.shape[0]
    _, splits, per_split = quant._w4a8_plan(m, n, k // 2 // g)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    partial = torch.empty((splits, m, n), dtype=torch.float32,
                          device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def call():
        xq, sx, sxsum = quant.quantize_activations(x, g)
        return lib.trackie_q4_w4a8(
            xq.data_ptr(), sx.data_ptr(), sxsum.data_ptr(),
            w.values.data_ptr(), w.scales.data_ptr(), out.data_ptr(),
            partial.data_ptr(), m, k, n, g, bm, splits, per_split, stream)
    status = call()
    if status == -1:
        return None
    check(status, f"q4_matmul_w4a8 at tile height {bm}")
    torch.cuda.synchronize()
    ref = quant.q4_matmul_w4a8(x, w.values, w.scales)
    if not torch.equal(out, ref):
        raise AssertionError(f"tile height {bm} differs from the wrapper")
    return call


def tile_heights(cs, quant, lib, check, dev, gen) -> dict:
    """Device-only ms of W4A8 at M in DECODE_MS on the Mistral projections,
    by tile height."""
    out = {}
    for name, (k, n) in cs.MISTRAL_SHAPES.items():
        w = quant.quantize_q4(
            torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k),
            cs.GROUP)
        for m in DECODE_MS:
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            row = {}
            for bm in TILE_ROWS:
                call = _w4a8_at(quant, lib, check, x, w, bm)
                if call is not None:
                    device = cs.device_only_ms(call)
                    row[bm] = device["total"] if device else None
            out[f"{name} M={m}"] = row
    return out


def _split_at(cs, entry, check, plain, x, w, bm: int, splits: int,
              per_split: int):
    """A callable that runs ``entry`` (the C entry of the bf16 Q8 or f32a
    kernel; both take x, values, scales, out, partial, M, K, N, G, dtype,
    BM, splits, groups a split, stream) on x as its wrapper does, but with
    the given tiling; checked against ``plain`` first."""
    m, k = x.shape
    n = w.values.shape[1]
    g = k // w.scales.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    partial = torch.empty((splits, m, n), dtype=torch.float32,
                          device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def call():
        return entry(x.data_ptr(), w.values.data_ptr(), w.scales.data_ptr(),
                     out.data_ptr(), partial.data_ptr(), m, k, n, g, 1, bm,
                     splits, per_split, stream)
    what = f"{splits} splits of {per_split} groups"
    check(call(), what)
    torch.cuda.synchronize()
    err = cs.rel_l2(out, plain(x, w.values, w.scales))
    if not err < cs.MATMUL_TOL:
        raise AssertionError(f"{what}: rel L2 {err}")
    return call


# The bf16 tensor-core kernels a split sweep times: the names of their
# plan, C entry and plain version.
SWEPT = {"q8": ("_q8_plan", "trackie_q8_matmul", "q8_matmul_ref"),
         "f32a": ("_f32a_plan", "trackie_q4_f32a", "q4_matmul_f32a_ref")}


def group_splits(kind: str, quant, lib, check):
    """The bf16 ``kind`` kernel (a key of SWEPT) by groups a K split (group
    pairs for f32a, whose splits walk both K halves): 1, 2, 4 and 8 at
    M = 1; all and half of them at M = 512. None where the checkout has no
    plan for it."""
    plan, entry, plain = SWEPT[kind]
    if not hasattr(quant, plan):
        return None

    def sweep(cs, x, w):
        m, k = x.shape
        rows, n = w.values.shape
        ng = rows // (k // w.scales.shape[0])   # groups a split may walk
        bm = getattr(quant, plan)(m, n, ng)[0]
        return {per: _split_at(cs, getattr(lib, entry), check,
                               getattr(quant, plain), x, w, bm,
                               -(-ng // per), per)
                for per in ((1, 2, 4, 8) if m == 1 else (ng, -(-ng // 2)))}
    return sweep


def matmul_times(cs, kind: str, quantize, kernel, sweep, dev, gen) -> dict:
    """A quantized matmul (``kind``: "q8" or "f32a") with bf16 x: ``w_gu``
    at M 1 and 512 as ``_times`` reads it, and device-only ms on every
    Mistral projection at M 1 and 512, each beside the dense bf16
    yardstick's. Where ``sweep`` is given (``group_splits``), also
    device-only ms by groups a K split."""
    out, by_split = {}, {}
    for name, (k, n) in cs.MISTRAL_SHAPES.items():
        w = quantize(
            torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k),
            cs.GROUP)
        dense = torch.randn((k, n), generator=gen, device=dev).to(
            torch.bfloat16)
        for m in (1, 512):
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            call = functools.partial(kernel, x, w.values, w.scales)
            if name == "w_gu":
                times = _times(cs, call)
                out[f"{kind} w_gu M={m}"] = times
                ms = times["device_ms"]
            else:
                device = cs.device_only_ms(call)
                ms = device["total"] if device else None
            device = cs.device_only_ms(functools.partial(torch.matmul, x,
                                                         dense))
            out[f"{kind} device_ms {name} M={m}"] = {
                kind: ms, "dense_bf16": device["total"] if device else None}
            if sweep is not None:
                row = {}
                for size, split_call in sweep(cs, x, w).items():
                    device = cs.device_only_ms(split_call)
                    row[size] = device["total"] if device else None
                by_split[f"{name} M={m}"] = row
        del w, dense
    if by_split:
        out[f"{kind} device_ms by K split"] = by_split
    return out


def fused_times(cs, quant, fused, llm, dev, gen) -> dict:
    """``fused_mlp_q4`` at M in FUSED_MS, bf16, as ``_times`` reads it, and
    the unfused block's device-only ms on the same inputs."""
    d, hid, grp = cs.FUSED_SHAPE
    w_gu = quant.quantize_q4(torch.randn(
        (d, 2 * hid), generator=gen, device=dev) / math.sqrt(d), grp)
    w_down = quant.quantize_q4(torch.randn(
        (hid, d), generator=gen, device=dev) / math.sqrt(hid), grp)
    out = {}
    for m in cs.FUSED_MS:
        x = torch.randn((m, d), generator=gen, device=dev).to(torch.bfloat16)
        norm = (1.0 + 0.1 * torch.randn((d,), generator=gen, device=dev)).to(
            torch.bfloat16)
        out[f"fused M={m}"] = _times(cs, lambda: fused.fused_mlp_q4(
            x, norm, w_gu.values, w_gu.scales, w_down.values, w_down.scales))
        device = cs.device_only_ms(
            lambda: llm._mlp_block(x, norm, w_gu, w_down, 1e-5))
        out[f"unfused device_ms M={m}"] = device["total"] if device else None
    return out


def main_times(cs, quant, attention, dev, gen) -> dict:
    """The main path's two kernels: W4A8 ``w_gu`` at M 1 and 512, and causal
    bf16 flash attention at S 256 and 512 beside SDPA."""
    import torch.nn.functional as F
    out = {}
    k, n = cs.MISTRAL_SHAPES["w_gu"]
    w = quant.quantize_q4(
        torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k),
        cs.GROUP)
    for m in (1, 512):
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        out[f"w4a8 w_gu M={m}"] = _times(
            cs, lambda: quant.q4_matmul_w4a8(x, w.values, w.scales))
    del w
    h, hk, d = 32, 8, 128
    for s in (256, 512):
        q = torch.randn((h, s, d), generator=gen, device=dev).to(
            torch.bfloat16)
        kk = torch.randn((hk, s, d), generator=gen, device=dev).to(
            torch.bfloat16)
        v = torch.randn((hk, s, d), generator=gen, device=dev).to(
            torch.bfloat16)
        out[f"flash causal S={s}"] = _times(
            cs, lambda: attention.flash_attention(q, kk, v))
        out[f"sdpa causal S={s}"] = _times(
            cs, lambda: F.scaled_dot_product_attention(
                q[None], kk[None], v[None], is_causal=True, enable_gqa=True))
    return out


def stream_times(cs, quant, dev, gen, sweep_n=STREAM_SWEEP_N,
                 sweep_k=STREAM_SWEEP_K) -> dict:
    """``q4_matmul_stream`` at the checkout's default tiles on every Mistral
    projection, M 1 and 8, bf16 and f32 x, as ``_times`` reads it; and at
    M = 1, device only, over (tile_n, tile_k) on STREAM_SWEPT, each pair
    first held against the plain version (None where the tile rule refuses
    it)."""
    out, by_tiles = {}, {}
    for name, (k, n) in cs.MISTRAL_SHAPES.items():
        w = quant.quantize_q4(
            torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k),
            cs.GROUP)
        for dtype in (torch.bfloat16, torch.float32):
            kind = str(dtype)[6:]
            for m in (1, 8):
                x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
                out[f"stream {name} M={m} {kind}"] = _times(
                    cs, functools.partial(quant.q4_matmul_stream, x,
                                          w.values, w.scales))
            if name not in STREAM_SWEPT:
                continue
            x = torch.randn((1, k), generator=gen, device=dev).to(dtype)
            ref = quant.q4_matmul_stream_ref(x, w.values, w.scales)
            row = {}
            for tn in sweep_n:
                for tk in sweep_k:
                    call = functools.partial(quant.q4_matmul_stream, x,
                                             w.values, w.scales, tile_n=tn,
                                             tile_k=tk)
                    try:
                        got = call()
                    except ValueError:
                        row[f"{tn},{tk}"] = None
                        continue
                    err = cs.rel_l2(got, ref)
                    if not err < cs.MATMUL_TOL:
                        raise AssertionError(
                            f"stream {name} tiles ({tn}, {tk}): rel L2 {err}")
                    device = cs.device_only_ms(call)
                    row[f"{tn},{tk}"] = device["total"] if device else None
            by_tiles[f"{name} M=1 {kind}"] = row
        del w
    out["stream device_ms by (tile_n, tile_k)"] = by_tiles
    return out


def grid_times(cs, diag, dev, gen) -> dict:
    """``grid64`` on its (8, 128) tile beside ``tile + 1``, as ``_times``
    reads them, and grid64 at 1 step where it takes ``steps``; each checked
    exact first."""
    tile = torch.randn(diag.TILE, generator=gen, device=dev)
    calls = {"grid64": lambda: diag.grid64(tile), "tile + 1": lambda: tile + 1}
    if "steps" in inspect.signature(diag.grid64).parameters:
        calls["grid64 1 step"] = lambda: diag.grid64(tile, 1)
    out = {}
    for label, call in calls.items():
        if not torch.equal(call(), tile + 1):
            raise AssertionError(f"{label} is not tile + 1")
        out[label] = _times(cs, call)
    return out


def chain_times(cs, diag, dev, gen, n: int = 64,
                reps: int = CHAIN_REPS) -> dict:
    """The ``n``-call chain on the (8, 128) tile three ways, each checked
    exact first, as the module's docstring says."""
    from trackiellm_tpu_torch.tools import capture, device_ms, host_ms
    tile = torch.randn(diag.TILE, generator=gen, device=dev)

    def a_launch(call):
        def chain():
            y = tile
            for _ in range(n):
                y = call(y)
            return y
        return chain
    calls = {"chain_tiny": lambda: diag.chain_tiny(tile, n),
             "chain_tiny(x, 1) a launch": a_launch(
                 lambda y: diag.chain_tiny(y, 1)),
             "tile + 1 a launch": a_launch(lambda y: y + 1)}
    want = a_launch(lambda y: y + 1)()
    out = {}
    for label, call in calls.items():
        if not torch.equal(call(), want):
            raise AssertionError(f"{label} is not {n} times tile + 1")
        row = _times(cs, call)
        row.update(event_ms=device_ms(call, dev, reps),
                   host_ms=host_ms(call, dev, reps),
                   graph_ms=device_ms(capture(call, dev), dev, reps))
        out[f"chain {label}"] = row
    return out


def decode_times(cs, llm, dev) -> dict:
    """``chip_smoke.py``'s phase-5 profile window, warmed up once."""
    from trackiellm_tpu_torch.llm import runner, tokenizer
    cfg = llm.LLMConfig.mistral_7b()._replace(max_seq=512,
                                              sliding_window=512)
    params = cs.build_model(dev, llm, cfg, 4)
    cs.profile_path(dev, runner, tokenizer, params, cfg)
    return {"q4 profile": cs.profile_path(dev, runner, tokenizer, params,
                                          cfg)}


def prefill_times(cs, llm, dev) -> dict:
    """A bucket-1024 prefill (phase 10's long prompt) of Mistral-7B with
    random Q4 weights at max_seq 2048, on a fresh cache each time."""
    from trackiellm_tpu_torch.llm import runner, tokenizer
    cfg = llm.LLMConfig.mistral_7b()._replace(max_seq=cs.SLICE10_MAX_SEQ)
    params = cs.build_model(dev, llm, cfg, 4)
    r = runner.LLMRunner(
        params, cfg, tokenizer.ByteTokenizer(cfg.vocab_size),
        runner.GenerationConfig(max_tokens=1, temperature=0.0,
                                speculative=False), device=dev)
    prompt = cs.long_prompt(r)
    wall = []
    for i in range(4):
        r.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.prepare_generation(prompt)
        torch.cuda.synchronize()
        if i:   # the first is the warm-up
            wall.append((time.perf_counter() - t0) * 1e3)
    r.reset()
    torch.cuda.synchronize()
    busy, n, by_name = cs.device_breakdown(lambda: r.prepare_generation(
        prompt))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    return {"prefill 1024": {
        "tokens": r.count_tokens(prompt) + 1, "wall_ms": wall,
        "busy_ms": busy, "launches": n,
        "top": [[k[:80], ms, c] for k, (ms, c) in top]}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=pathlib.Path, default=CHECKOUT,
                    help="the checkout whose port is timed")
    ap.add_argument("--only", nargs="+", choices=ROW_SETS, default=ROW_SETS,
                    help="the row sets to time (default: all)")
    args = ap.parse_args(argv)
    only = set(args.only)
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device; this tool times the card only",
              file=sys.stderr)
        return 1
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import trackiellm_tpu_torch
    found = pathlib.Path(trackiellm_tpu_torch.__file__).resolve().parents[1]
    if found != root:
        print(f"kernel_times: imported the port from {found}, not {root}",
              file=sys.stderr)
        return 1
    from trackiellm_tpu_torch.models import llm
    from trackiellm_tpu_torch.ops import _build, attention, diag, fused, quant

    for name in ("TRACKIE_Q4_F32A", "TRACKIE_FUSED_MLP"):
        os.environ.pop(name, None)   # the unfused block's default route

    cs = _chip_smoke()
    print(cs.nvidia_smi(), flush=True)
    lib = _build.library()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    result = {"root": str(root)}

    if "main" in only:
        result.update(main_times(cs, quant, attention, dev, gen))
    if "fused" in only:
        result.update(fused_times(cs, quant, fused, llm, dev, gen))
    for kind, quantize, kernel in (
            ("q8", quant.quantize_q8, quant.q8_matmul),
            ("f32a", quant.quantize_q4, quant.q4_matmul_f32a)):
        if kind in only:
            result.update(matmul_times(
                cs, kind, quantize, kernel,
                group_splits(kind, quant, lib, _build.check), dev, gen))
    if ("w4a8_tiles" in only and hasattr(quant, "_w4a8_plan")
            and hasattr(quant, "quantize_activations")):
        result["w4a8 device_ms by tile height"] = tile_heights(
            cs, quant, lib, _build.check, dev, gen)
    if "stream" in only:
        result.update(stream_times(cs, quant, dev, gen))
    if "grid64" in only:
        result.update(grid_times(cs, diag, dev, gen))
    if "chain" in only:
        result.update(chain_times(cs, diag, dev, gen))
    if "decode" in only:
        result.update(decode_times(cs, llm, dev))
    if "prefill" in only:
        result.update(prefill_times(cs, llm, dev))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
