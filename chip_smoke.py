#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on an NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure is an uncaught exception and a non-zero exit):
  1. device: torch, capability (must be (9, 0)), nvidia-smi name and power
     limit;
  2. build: nvcc builds the CUDA kernels from ``trackiellm_tpu_torch/csrc``;
  3. kernels: each of the ten CUDA kernels against its plain PyTorch
     version at the shapes its path gives it (W4A8 at M in {1, 8, 16, 64,
     128, 256, 512}, Q8 and f32-activation Q4 also at 1024, 2048 and 4096:
     the model paths' rows and those of phase 12's admission waves, extend
     chunks and decode steps, ``serve_shapes``; the streaming Q4 at M in
     {1, 8}; all on the five Mistral-7B projections, plus one streaming
     case at other tiles; W4A8's activation quantization at M in {1, 512},
     K in {4096, 14336}, bit for bit; flash attention in five variants at
     H=32, Hk=8, D=128, S in {256, 512, 1024}, bf16 and f32, and causal
     bf16 at the waves' folded heads, 2, 4 and 8 rows of (32, 8) heads at
     S in {256, 512}; the fused MLP block at M in {1,
     4, 8}, D 4096, H 14336, bf16 and f32, also timed against the unfused
     path per call and on the device alone; the stream probe over 512 MiB,
     grid64 (64 steps in one block) and a 64-call chain_tiny on (8, 128)),
     with error, tolerance, times, the bound (bytes over the memory rate or
     operations over the peak rate, whichever is larger), the one PyTorch
     call that computes the same function where there is
     one (SDPA for causal bf16 flash, an int64 sum for the stream, x + 1
     for grid64, a chain of 64 x + 1 calls for chain_tiny), and the
     profiler's device-only time of each headline case and of those
     library calls (for chain_tiny also the CUDA-event span of a chain);
  4. width: Mistral-7B width cut to 2 layers, random weights from a seed,
     card against the port's CPU path: Q4 and Q8 prefill logits, and Q4
     with both opt-in levers through prefill and 8 decode steps;
  5. slice: Mistral-7B (32 layers, max_seq 512, random Q4 weights) behind
     ``LLMRunner`` answers four requests on the default routes, then a
     fresh bucket-512 prefill and 32 decode tokens run under the profiler
     (one ``{"profile": ...}`` line: wall, device busy, idle share,
     launches, the largest costs by kernel);
  6. Q8 slice: the same model with Q8 weights answers three requests,
     then runs phase 5's profiled window (its own ``{"profile": ...}``
     line);
  7. opt-in Q4 routes: phase 5's model under ``TRACKIE_Q4_F32A=1`` and
     ``TRACKIE_FUSED_MLP=1`` answers two requests, then runs phase 5's
     profiled window under both levers (its own ``{"profile": ...}`` line:
     the fused block's share of a decode token);
  8. entry point: a 2-layer Q8 checkpoint round-trips through
     ``save_checkpoint`` / ``load_checkpoint`` byte for byte, and
     ``python -m trackiellm_tpu_torch generate`` runs on it in-process;
  9. diagnostics: the measurement functions of the three
     ``trackiellm_tpu_torch.tools`` (per-call cost eager and in a CUDA
     graph: the 64-call chain from one host call, one host call a launch
     and x + 1 a launch; the stream handle's read; the streaming Q4 tile
     sweep, graph and op overheads, the 512
     MiB stream envelope, decode of phase 5's model cut to 32/16/8 layers,
     greedy chunks), with their numbers as one JSON line;
 10. tool calls and speculation: phase 5's model at max_seq 2048 behind
     ``LLMRunner`` on the default routes: a forced tool call on the cortex
     prompt with three tools (two with an argument schema) that must parse
     and conform, ``add_tool_response`` and the follow-up reply, and one
     offering only the two schema'd tools; a ``response_schema`` reply at
     temperature 0.7, twice from one seed, whose sampled tokens (not only
     the budget's closure) must advance the grammar; greedy speculation
     ("auto" and True) with the ids of plain decode, and True's passes on
     a repetitive prompt; sampled speculation, twice from one seed, with
     passes (the rejection-sampling verify on the card); a
     600-1000-token prompt (bucket 1024), which must take the f32a kernel
     and never the plain path; the verify pass
     (``extend(all_logits=True)``, 16 rows) against 16 decode steps; its
     numbers as one ``{"slice10": ...}`` line;
 11. GGUF to reply: a llama.cpp GGUF of Mistral-7B at its published widths
     cut to 4 layers, at the Q4_K_M mix (seeded random Q4_K and Q6_K blocks,
     F32 norms, a 32,000-piece SentencePiece vocabulary), written by this
     script; ``inspect`` names it, ``convert --bits 4`` requantizes it on
     the card into a checkpoint whose config, tokenizer and layer-0 and
     head bytes equal the CPU's requantization (Q8 too), and ``generate``
     answers from it through W4A8 and flash; its times and sizes as one
     ``{"gguf": ...}`` line;
 12. serving: phase 5's model behind ``LLMServer`` with eight slots:
     ``tools/measure_server.run`` (a warm burst, then 16 requests of 48
     tokens) per-step and in pipelined 8-step chunks, dense and paged
     (128-token pages), and a paged int8 pool, in two rounds, with their
     admission waves; then on each server a burst of the 16 requests
     queued whole before admission: chunks must give all 16 the per-step
     ids. Eight cortex prompts through the prefix cache, then eight more
     sharing their prefix (hits must count); a ~400-token prompt admitted
     in extend chunks while seven requests decode between them; a forced
     tool call among three cortex prompts (a wave of four at bucket 512:
     f32a), which must conform; a lone request's first token against
     ``LLMRunner``'s; ``prefill_batch`` in waves of 2, 4 and 8 against
     ``prefill`` of each prompt, by rel L2 (W4A8 at bucket 64, f32a and
     flash at bucket 512). Reported: how many requests the runner and the
     other layout answer alike, and a profile of 8-step chunks in a
     process of its own (launches and busy time a decode step, the
     admission's apart); one ``{"serve": ...}`` line before the slice10
     line.
 13. voice: Whisper-tiny at its published widths (random weights from the
     seed written to a whisper.cpp GGML file, f16 matrices) loaded with
     ``whisper_from_ggml`` on the card and on the CPU; ``WhisperASR``
     transcribes a 5-s signal given at 48 kHz (``resample_poly`` runs) at
     the 30-s window (n_audio_ctx 1500) and the app's 10-s window (500),
     96 tokens: the card's ids against the CPU's (reported), the first 8
     decode steps' logits teacher-forced with the CPU's ids (rel L2 1e-4),
     encode and decode times, RTF; the ``transcribe`` CLI on a checkpoint
     and a WAV written here. Whisper large-v3's widths cut to 2+2 layers
     transcribe once. Silero VAD (``SileroConfig()``) from an ONNX file
     under the ``silero_v5`` map's published names runs 312 chunks, state
     carried, against the CPU (max abs 1e-5). The app's TTS
     (``TTSConfig.default()``) says a 60-character reply through
     ``TTSEngine.stream`` and ``synthesize``: the joined chunks against the
     one-shot waveform (bit for bit, else max abs 1e-6). A Piper voice at
     ``VITSConfig()``'s widths from an ONNX file under the ``piper_vits``
     names and its JSON, through ``VITSVoice.from_piper`` and the ``synth``
     CLI: the waveform from injected noise against the CPU's (frames equal,
     rel L2 1e-4). The launches and idle share of the decode window (a
     token) and of the encoder (a call) come from a profile in a process
     of its own (``--voice-profile``); one
     ``{"voice": ...}`` line before the serve line. No hand-written kernel
     is on the voice path: every counter must stay at 0.
 14. vision: a seeded 480x640 floor-and-obstacle frame; YOLOv8n and YOLOv5nu
     at 640, MiDaS v2.1-small at 384, DPT-SwinV2 tiny_256 and the CRNN OCR
     at their published widths (random weights from the seed), each on the
     card and the CPU: the detectors' raw boxes and class probabilities
     (rel L2 1e-5), ``decode_and_nms`` on the card given the CPU's raw
     outputs (bit for bit), the MiDaS and DPT maps (rel L2 1e-5 and 1e-4),
     the OCR logits on the page grid's crops (max abs 1e-5, strings
     equal), the navigation grid given one depth map and the same RANSAC
     indices (equal); ``VisionPipeline.process_frame`` with
     ``AnalysisFlags.ALL``, with MiDaS and with DPT, with OCR and a
     ``NavigationEngine``: every requested ``valid_analyses`` bit must be
     set (a stage that degrades on the card fails the phase), the card's
     objects against the CPU's (reported), the frame wall p50 over 20
     frames; each stage's time and the NMS sweep's alone, with a sync. The
     launches and idle share of a frame come from a profile in a process
     of its own (``--vision-profile``); one ``{"vision": ...}`` line before
     the voice line. No hand-written kernel is on the vision path: every
     counter must stay at 0.
Phases 5-14 zero every launch counter just before they drive their path and
read them just after: the path's kernels must have launched, and the routes
it does not take must not have (no serving path launches the streaming Q4
or a probe; phase 9 must launch all four; phases 13 and 14 launch none).
In
phases 5-7 greedy text must not depend on the lookahead depth, in phase 10
not on speculation, and every logit vector must be finite. Phase 3's
device-only times come from profiles whose launch count matches the calls
(``device_only_ms``). Each phase's first line ends with the seconds since
the build began. The ``vision`` line, then the ``voice`` line, come just
before the last five lines, which are the ``serve`` line, the ``slice10``
line, the card line, the kernels' JSON summary and the result line.
"""

import contextlib
import io
import json
import math
import os
import resource
import struct
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

SEED = 1234
MISTRAL_SHAPES = {  # (K, N) of the quantized projections, group 256
    "wqkv": (4096, 6144), "wo": (4096, 4096), "w_gu": (4096, 28672),
    "w_down": (14336, 4096), "lm_head": (4096, 32000),
}
GROUP = 256
PROFILE_TOKENS = 32  # decode tokens in phase 5's profiled window
PROFILE_RETRIES = 3  # profiles of a timed window that missed launches
MATMUL_MS = (1, 8, 64, 256, 512)
# Q8 and f32a take M > 512 on the card: a bucket-1024 prefill's 1024 rows.
# Phase 12's admission waves add their rows (``serve_shapes``).
EXACT_MS = (*MATMUL_MS, 1024)
FLASH_S = (256, 512, 1024)   # prefill buckets; 1024 in phase 10
QUANT_MS, QUANT_KS = (1, 512), (4096, 14336)   # activation quantization
# One H100 SXM (the data sheet, at 700 W): the bound of a kernel is the
# larger of its bytes over the memory rate and its operations over the
# peak rate of their type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
STREAM_MS = (1, 8)   # the streaming Q4's decode shapes
STREAM_ALT = ("wo", 1024, 64)   # one case at non-default (tile_k, tile_n)
# rel: the stream kernel's sum is exact; the plain f32 sum of 512 MiB is not
STREAM_TOL = 1e-5
STREAM_SHAPE = (131072, 4096)   # 512 MiB of uint8, the JAX tool's array
PROBES = ("stream", "grid64", "chain_tiny")
# The kernels no serving path launches: phases 5-8 must leave them idle,
# phase 9 must launch each.
DIAGNOSTIC = ("q4_matmul_stream", *PROBES)
MATMUL_TOL = 1e-5    # rel L2: the same products, f32 sums in another order
# rel L2; in bf16 one rounding of the output may land on the other side
FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
FUSED_MS = (1, 4, 8)
FUSED_SHAPE = (4096, 14336, 256)  # Mistral-7B D, H, group
FUSED_TOL = FLASH_TOL
WIDTH_TOL = 5e-2     # rel L2: W4A8 activation quantization, ~0.5% per matmul
# rel L2 for the exact-activation routes (Q8, f32a, fused): only the f32
# sum order differs, yet through the bf16 activations of random weights
# that alone moves these logits by ~7e-3 (on the CPU, the Q8 products
# summed per group as the kernel does against dequantize-then-matmul:
# 7.4e-3).
EXACT_WIDTH_TOL = 2e-2
LEVERS = ("TRACKIE_Q4_F32A", "TRACKIE_FUSED_MLP")
SYSTEM = ("You are Trackie, an assistant for a blind user. Answer in one "
          "or two short sentences and warn about hazards first.")
CONTEXT = ("Objects: person 2.1 m ahead, bicycle 3.4 m left, door 5 m "
           "right. Depth: clear path 4 m. Text: EXIT. Sound: traffic.")
SHORT_PROMPT = f"descreva a cena a sua frente com detalhes ({SEED})"
# Phase 10: the cortex's tools (two with an argument schema), a reply
# schema, the token budgets and the long prompt's range (bucket 1024).
TOOLS = (
    ("navigate", "guide the user", {"direction": "left, right or ahead"},
     {"type": "object", "required": ["direction"],
      "properties": {"direction": {"type": "string",
                                   "enum": ["left", "right", "ahead",
                                            "back"]},
                     "meters": {"type": "number"}}}),
    ("describe", "describe an object", {"target": "what to describe"},
     {"type": "object", "required": ["target"],
      "properties": {"target": {"type": "string"},
                     "detail": {"type": "boolean"}}}),
    ("stop", "stop and wait", {}, None),
)
RESPONSE_SCHEMA = {"type": "object", "required": ["hazard", "objects"],
                   "properties": {"hazard": {"type": "string"},
                                  "distance_m": {"type": "number"},
                                  "objects": {"type": "array",
                                              "items": {"type": "string"},
                                              "maxItems": 4}}}
TOOL_TOKENS = 96     # budget of a constrained reply (the closure may end it)
# The response_schema reply's repetition penalty. The grammar tolerates
# whitespace without limit, as the JAX package's does, and the seed's
# random weights favour it: at the default penalty (1.1) the sampler emits
# whitespace until the budget's closure writes the whole object. A strong
# penalty pushes it off the whitespace it has used, so sampled tokens
# advance the grammar on the card.
SCHEMA_PENALTY = 3.0
# A prompt whose n-grams repeat: with spec_min_ngram=1, greedy and sampled
# speculation find proposals on it ("auto" too, unless its first two
# tokens find none and start its cooldown).
REPEAT_PROMPT = "abc abc abc abc abc abc abc abc ab"
SPEC_TOKENS = 48     # tokens of each speculation request
SLICE10_MAX_SEQ = 2048
LONG_PROMPT = (600, 1000)
VERIFY_ROWS = 16     # the verify pass's extend bucket
# Phase 11: a llama.cpp GGUF of Mistral-7B at its published widths, cut to
# GGUF_LAYERS layers (the whole model's conversion is
# trackiellm_tpu_torch/tools/convert_times.py), at llama.cpp's Q4_K_M mix:
# Q4_K for the embeddings, q, k, the attention output, gate and up; Q6_K
# for v, down and the output head; F32 norms.
GGUF_LAYERS = 4
GGML_F32, GGML_F16, GGML_Q4_K, GGML_Q6_K = 0, 1, 12, 14
# ggml type -> (elements a block, bytes a block, byte offset of the block's
# f16 d, of its f16 dmin or None, and the range d is drawn from). Q4_K's
# dmin is 7.5 d, so that random nibbles and scales give weights about 0
# (the mean scale times the mean nibble).
GGML_BLOCKS = {GGML_Q4_K: (256, 144, 0, 2, (5e-5, 1e-4)),
               GGML_Q6_K: (256, 210, 208, None, (1e-5, 2e-5))}
Q4_K_M = {"token_embd": GGML_Q4_K, "output": GGML_Q6_K,
          "attn_q": GGML_Q4_K, "attn_k": GGML_Q4_K, "attn_v": GGML_Q6_K,
          "attn_output": GGML_Q4_K, "ffn_gate": GGML_Q4_K,
          "ffn_up": GGML_Q4_K, "ffn_down": GGML_Q6_K}
GGUF_TOKENS = 32     # tokens of phase 11's generate


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=30)
    return out.stdout.strip().splitlines()[0]


def l2_flush() -> torch.Tensor:
    """256 MiB to zero before a timed call: it evicts the 50 MiB L2."""
    return torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` per call, with L2 flushed before each
    call (the main path finds weights cold: a 7B model is 70x L2)."""
    flush = l2_flush()
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def device_breakdown(fn):
    """Run ``fn`` under ``torch.profiler`` (CUDA activity): the device's
    busy ms (the sum of its kernels and copies), the launches, and ms and
    count by kernel name."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {e.key: (e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages() if e.self_device_time_total > 0}
    return (sum(ms for ms, _ in by_name.values()),
            sum(n for _, n in by_name.values()), by_name)


def device_only_ms(fn, iters: int = 20, counter=None, per_call: int = 1,
                   notes=None):
    """Device time per call of the kernels ``fn`` launches, by kernel name,
    with L2 flushed before each call and the flush left out: the wrapper's
    host cost is not in it. None where the profiler's count of launches is
    not what the calls made; then ``notes``, a list, gets why.

    One call profiled alone gives the launches of a call by kernel name;
    ``counter`` (a wrapper with a ``launches`` count), where given, must
    rise by ``per_call`` in it. The timed window of ``iters`` calls must
    then show ``iters`` times as many launches of each name. A lone call
    whose profile shows no launch, or a window that misses some, is
    profiled again, up to PROFILE_RETRIES times; a window that never shows
    them all gives no time (a per-call time from a partial count would be
    a fraction of the truth)."""
    flush = l2_flush()
    fn()
    torch.cuda.synchronize()
    for _ in range(1 + PROFILE_RETRIES):
        before = counter.launches if counter is not None else 0
        _, _, one = device_breakdown(fn)
        if counter is not None and counter.launches - before != per_call:
            raise AssertionError(f"one profiled call launched "
                                 f"{counter.launches - before} times, not "
                                 f"{per_call}")
        per = {k: n for k, (_, n) in one.items() if "Fill" not in k}
        if per:
            break
    note = "profiler saw no launch of one call"

    def calls():
        for _ in range(iters):
            flush.zero_()
            fn()
    for _ in range(1 + PROFILE_RETRIES if per else 0):
        _, _, by_name = device_breakdown(calls)
        seen = {k: by_name.get(k, (0.0, 0))[1] for k in per}
        if all(seen[k] == iters * n for k, n in per.items()):
            per_kernel = {k: by_name[k][0] / iters for k in per}
            return {"total": sum(per_kernel.values()), "kernels": per_kernel}
        note = (f"profiler saw {sum(seen.values())} of "
                f"{iters * sum(per.values())} launches")
    if notes is not None:
        notes.append(note)
    return None


def bound_ms(tensors, ops: float, kind: str):
    """(ms, "bytes" or "operations"): the least time the card could take
    for work that reads or writes each of ``tensors`` once and does ``ops``
    operations of type ``kind``, the larger of the two times."""
    by_bytes = sum(t.numel() * t.element_size()
                   for t in tensors) / HBM_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def add_row(rows, kname: str, kernel, counter, per_call: int = 1,
            **row) -> None:
    """One phase 3 result of ``kname``; a headline case (``KERNELS``) also
    gets the device-only time of ``kernel`` (``per_call`` launches a call
    by the wrapper ``counter``), or a note of why there is none."""
    if row["case"] in KERNELS[kname][2]:
        notes = []
        row["device"] = device_only_ms(kernel, counter=counter,
                                       per_call=per_call, notes=notes)
        if notes:
            row["device_note"] = notes[0]
            log(f"  {kname} {row['case']}: no device-only time, {notes[0]}")
    rows[kname].append(row)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def matmul_case(rows, kname: str, what: str, case: str, kernel, plain,
                inputs, kind: str, counter):
    """One matmul kernel call against its plain version: rel L2 within
    MATMUL_TOL, times and the bound beside (``inputs``: x and the weight's
    tensors; 2 M K N operations of type ``kind``)."""
    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    err = rel_l2(got, ref)
    abs_err = (got - ref).abs().max().item()
    ms, plain_ms = time_ms(kernel), time_ms(plain)
    (m, k), n = inputs[0].shape, got.shape[1]
    bound, by = bound_ms((*inputs, got), 2 * m * k * n, kind)
    log(f"  {what}: rel_l2={err:.3e} (tol {MATMUL_TOL:.0e}) max_abs="
        f"{abs_err:.3e} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={bound:.4f} ({by})")
    if not err < MATMUL_TOL:
        raise AssertionError(f"{kname} {case}: rel L2 {err}")
    add_row(rows, kname, kernel, counter, case=case, err=abs_err, ms=ms,
            plain=plain_ms, bound=bound, bound_by=by)


def quant_cases(rows, quant, gen, dev) -> None:
    """Phase 3, the activation quantization: the kernel against
    ``quantize_activations_q8`` on bf16 x, equal bit for bit."""
    for m in QUANT_MS:
        for k in QUANT_KS:
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            got = quant.quantize_activations(x, GROUP)
            ref = quant.quantize_activations_q8(x, GROUP)
            torch.cuda.synchronize()
            diff = sum((a != b).sum().item() for a, b in zip(got, ref))
            abs_err = max((a.float() - b.float()).abs().max().item()
                          for a, b in zip(got, ref))
            ms = time_ms(lambda: quant.quantize_activations(x, GROUP))
            plain_ms = time_ms(lambda: quant.quantize_activations_q8(x, GROUP))
            # per element: abs, max, divide, round, clamp, sum
            bound, by = bound_ms((x, *got), 6 * m * k, "f32")
            log(f"  quant M={m:3d} K={k}: {diff} elements differ (exact) "
                f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"bound_ms={bound:.4f} ({by})")
            if diff:
                raise AssertionError(f"quantize M={m} K={k}: {diff} differ")
            add_row(rows, "quantize_activations",
                    lambda: quant.quantize_activations(x, GROUP),
                    quant.quantize_activations,
                    case=f"M={m} K={k}", err=abs_err, ms=ms, plain=plain_ms,
                    bound=bound, bound_by=by)


def sdpa_ms(q, k, v, ref):
    """The one PyTorch call that computes causal GQA attention,
    ``scaled_dot_product_attention`` on (1, H, S, D), timed as the library
    yardstick (the port never calls it): (ms per call as ``time_ms`` reads
    it, device-only ms as ``device_only_ms`` reads it). Its output must
    agree with the dense oracle as the kernel's does."""
    import torch.nn.functional as F

    def call():
        return F.scaled_dot_product_attention(q[None], k[None], v[None],
                                              is_causal=True, enable_gqa=True)
    err = rel_l2(call()[0], ref)
    if not err < FLASH_TOL[q.dtype]:
        raise AssertionError(f"SDPA against the dense oracle: rel L2 {err}")
    device = device_only_ms(call)
    return time_ms(call), device["total"] if device else None


def attention_pairs(s: int, window: int) -> int:
    """(query, key) pairs a causal mask keeps, with a window if > 0."""
    if window <= 0:
        return s * (s + 1) // 2
    return sum(min(i + 1, window) for i in range(s))


def serve_shapes(runner_mod, max_m: int, max_seq: int, slots: int):
    """The shapes phase 12's LLMServer gives the kernels at ``max_seq``
    with ``slots`` slots. An admission wave is one prefill bucket times 1,
    2, 4 or 8 rows (a wave is padded to a power of two, at most
    ``slots``), an extend chunk one extend bucket, a decode step ``slots``
    rows. Returns the matmul rows at most ``max_m`` (W4A8 takes them)
    joined to MATMUL_MS, the rows above it (Q4 takes f32a there) joined to
    EXACT_MS, and the (S, rows) of the waves that reach flash: a wave
    folds its rows into the heads, (rows * H, S, D) queries against
    (rows * Hk, S, D) keys."""
    buckets = [b for b in runner_mod.PREFILL_BUCKETS if b <= max_seq]
    rows = [1 << i for i in range(slots.bit_length())]
    waves = {b * r for b in buckets for r in rows}
    small = (waves | {slots}
             | {b for b in runner_mod.EXTEND_BUCKETS if b <= max_seq})
    flash = [(s, r) for s in buckets if s >= 256 and s % 256 == 0
             for r in rows if r > 1]
    return (tuple(sorted(set(MATMUL_MS) | {m for m in small if m <= max_m})),
            tuple(sorted(set(EXACT_MS) | {m for m in waves if m > max_m})),
            flash)


def flash_case(rows, attention, gen, dev, heads, s: int, dtype, kw: dict,
               case: str, library: bool) -> None:
    """One flash call on ``heads`` (H, Hk) query and key heads at S=s
    against ``attention_ref``: rel L2 within FLASH_TOL, times and the bound
    beside, and SDPA's times where ``library``."""
    (h, hk), d = heads, 128
    q = torch.randn((h, s, d), generator=gen, device=dev).to(dtype)
    kk = torch.randn((hk, s, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((hk, s, d), generator=gen, device=dev).to(dtype)
    kw = dict(kw)
    if kw.pop("sinks", False):
        kw["sinks"] = torch.randn((h,), generator=gen, device=dev)
    got = attention.flash_attention(q, kk, v, **kw)
    ref = attention.attention_ref(q, kk, v, **kw)
    torch.cuda.synchronize()
    err = rel_l2(got, ref)
    abs_err = (got.float() - ref.float()).abs().max().item()
    ms = time_ms(lambda: attention.flash_attention(q, kk, v, **kw))
    plain = time_ms(lambda: attention.attention_ref(q, kk, v, **kw))
    pairs = attention_pairs(s, kw.get("window", 0))
    bound, by = bound_ms(
        (q, kk, v, got, *(t for t in kw.values() if torch.is_tensor(t))),
        4 * h * d * pairs, "bf16" if dtype == torch.bfloat16 else "f32")
    lib = lib_device = None
    if library:
        lib, lib_device = sdpa_ms(q, kk, v, ref)
    tol = FLASH_TOL[dtype]
    log(f"  flash {case}: rel_l2={err:.3e} (tol {tol:.0e}) max_abs="
        f"{abs_err:.3e} kernel_ms={ms:.4f} plain_ms={plain:.4f} bound_ms="
        f"{bound:.4f} ({by}) library_ms={lib} library_device_ms={lib_device}")
    if not err < tol:
        raise AssertionError(f"flash {case}: {err}")
    add_row(rows, "flash_attention",
            lambda: attention.flash_attention(q, kk, v, **kw),
            attention.flash_attention, case=case, err=abs_err, ms=ms,
            plain=plain, bound=bound, bound_by=by, library=lib,
            library_device=lib_device)


def phase_kernels(dev, quant, attention, fused, llm, diag, serve):
    """Phase 3: every kernel against its plain version, times beside, at
    the model paths' shapes and at those of phase 12's waves (``serve``,
    from ``serve_shapes``)."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    w4a8_ms, exact_ms, flash_waves = serve
    matmuls = {  # name: (quantize, kernel, plain, label, M values, op type)
        "q4_matmul_w4a8": (quant.quantize_q4, quant.q4_matmul_w4a8,
                           quant.q4_matmul_w4a8_ref, "w4a8", w4a8_ms,
                           "int8"),
        "q8_matmul": (quant.quantize_q8, quant.q8_matmul,
                      quant.q8_matmul_ref, "q8  ", exact_ms, "bf16"),
        "q4_matmul_f32a": (quant.quantize_q4, quant.q4_matmul_f32a,
                           quant.q4_matmul_f32a_ref, "f32a", exact_ms,
                           "bf16"),
        "q4_matmul_stream": (quant.quantize_q4, quant.q4_matmul_stream,
                             quant.q4_matmul_stream_ref, "strm", STREAM_MS,
                             "bf16"),
    }
    rows = {name: [] for name in KERNELS}
    for name, (k, n) in MISTRAL_SHAPES.items():
        w32 = torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)
        for kname, (quantize, kernel, plain, label, ms,
                    kind) in matmuls.items():
            w = quantize(w32)
            args = (w.values, w.scales)
            for m in ms:
                x = torch.randn((m, k), generator=gen, device=dev).to(
                    torch.bfloat16)
                matmul_case(rows, kname,
                            f"{label} {name:7s} M={m:3d} K={k} N={n}",
                            f"{name} M={m}", lambda: kernel(x, *args),
                            lambda: plain(x, *args), (x, *args), kind, kernel)
            if kname == "q4_matmul_stream" and name == STREAM_ALT[0]:
                _, tile_k, tile_n = STREAM_ALT
                x = torch.randn((1, k), generator=gen, device=dev).to(
                    torch.bfloat16)
                case = f"{name} M=1 tiles=({tile_k},{tile_n})"
                matmul_case(rows, kname, f"{label} {case}", case,
                            lambda: kernel(x, *args, tile_n=tile_n,
                                           tile_k=tile_k),
                            lambda: plain(x, *args), (x, *args), kind,
                            kernel)
            del w, args
        del w32
    quant_cases(rows, quant, gen, dev)
    h, hk = 32, 8
    variants = {"causal": {}, "window128": {"window": 128},
                "softcap50": {"softcap": 50.0},
                "sinks": {"sinks": True}, "scale0.05": {"scale": 0.05}}
    for s in FLASH_S:
        for dtype in (torch.bfloat16, torch.float32):
            for vname, kw in variants.items():
                flash_case(rows, attention, gen, dev, (h, hk), s, dtype, kw,
                           f"{vname} S={s} {str(dtype)[6:]}",
                           vname == "causal" and dtype == torch.bfloat16)
    for s, n in flash_waves:  # the serving model's attention: causal, bf16
        flash_case(rows, attention, gen, dev, (n * h, n * hk), s,
                   torch.bfloat16, {}, f"causal S={s} {n} rows bfloat16",
                   False)
    d, hid, grp = FUSED_SHAPE
    w_gu = quant.quantize_q4(torch.randn((d, 2 * hid), generator=gen,
                                         device=dev) / math.sqrt(d), grp)
    w_down = quant.quantize_q4(torch.randn((hid, d), generator=gen,
                                           device=dev) / math.sqrt(hid), grp)
    for dtype in (torch.bfloat16, torch.float32):
        for m in FUSED_MS:
            x = torch.randn((m, d), generator=gen, device=dev).to(dtype)
            norm = (1.0 + 0.1 * torch.randn((d,), generator=gen,
                                            device=dev)).to(dtype)
            args = (x, norm, w_gu.values, w_gu.scales, w_down.values,
                    w_down.scales)
            got = fused.fused_mlp_q4(*args)
            ref = fused.fused_mlp_ref(x, norm, w_gu, w_down, 1e-5)
            torch.cuda.synchronize()
            err = rel_l2(got, ref)
            abs_err = (got.float() - ref.float()).abs().max().item()
            ms = time_ms(lambda: fused.fused_mlp_q4(*args))
            plain = time_ms(
                lambda: fused.fused_mlp_ref(x, norm, w_gu, w_down, 1e-5))
            # The unfused block on the default route: W4A8 w_gu, silu * up,
            # W4A8 w_down, residual, with the levers unset; per call and on
            # the device alone (its ~10 launches follow the host).
            def unfused_block():
                return llm._mlp_block(x, norm, w_gu, w_down, 1e-5)
            unfused = time_ms(unfused_block)
            unfused_device = device_only_ms(unfused_block)
            if unfused_device:
                unfused_device = unfused_device["total"]
            bound, by = bound_ms(
                (*args, got), 2 * m * 3 * d * hid,
                "bf16" if dtype == torch.bfloat16 else "f32")
            tol = FUSED_TOL[dtype]
            log(f"  fused M={m} D={d} H={hid} {str(dtype)[6:]:8s}: "
                f"rel_l2={err:.3e} (tol {tol:.0e}) max_abs={abs_err:.3e} "
                f"kernel_ms={ms:.4f} plain_ms={plain:.4f} "
                f"unfused_ms={unfused:.4f} unfused_device_ms={unfused_device}"
                f" bound_ms={bound:.4f} ({by})")
            if not err < tol:
                raise AssertionError(f"fused M={m} {dtype}: rel L2 {err}")
            add_row(rows, "fused_mlp_q4", lambda: fused.fused_mlp_q4(*args),
                    fused.fused_mlp_q4,
                    case=f"M={m} {str(dtype)[6:]}", err=abs_err, ms=ms,
                    plain=plain, unfused=unfused,
                    unfused_device=unfused_device, bound=bound, bound_by=by)
    del w_gu, w_down
    phase_probes(dev, gen, diag, rows)
    return rows


def phase_probes(dev, gen, diag, rows) -> None:
    """Phase 3, the probes: the stream kernel over 512 MiB (rel tolerance
    STREAM_TOL), grid64 and a 64-call chain_tiny on (8, 128) (exact). The
    library yardsticks, per call and device only: ``w.sum(dtype=
    torch.int64)`` for the stream, ``tile + 1`` for grid64, and a chain of
    64 ``tile + 1`` calls for chain_tiny. The chain's bound counts its 64
    calls' bytes (each reads and writes the tile); its CUDA-event span over
    back-to-back chains is logged beside the profiler's kernel sum, which
    counts the overlap of programmatic dependent launches twice (each
    kernel's time includes its wait on the last)."""
    from trackiellm_tpu_torch.tools import device_ms
    x = torch.randn((1, 1), generator=gen, device=dev)
    w = torch.randint(0, 255, STREAM_SHAPE, generator=gen, device=dev,
                      dtype=torch.uint8)
    tile = torch.randn(diag.TILE, generator=gen, device=dev)

    def tile_chain():
        y = tile
        for _ in range(diag.CHAIN):
            y = y + 1
        return y
    cases = {  # name: (case, kernel, plain, rel tolerance, library call,
               #        inputs, calls, operations and their type)
        "stream": ("512 MiB", lambda: diag.stream(x, w),
                   lambda: diag.stream_ref(x, w), STREAM_TOL,
                   lambda: w.sum(dtype=torch.int64), (x, w), 1, w.numel(),
                   "int8"),
        "grid64": ("(8, 128)", lambda: diag.grid64(tile),
                   lambda: diag.grid64_ref(tile), 0.0, lambda: tile + 1,
                   (tile,), 1, diag.GRID_STEPS * tile.numel(), "f32"),
        "chain_tiny": (f"{diag.CHAIN} calls (8, 128)",
                       lambda: diag.chain_tiny(tile),
                       lambda: diag.chain_tiny_ref(tile), 0.0, tile_chain,
                       (tile,), diag.CHAIN, diag.CHAIN * tile.numel(),
                       "f32"),
    }
    for name, (case, kernel, plain, tol, lib, inputs, calls, ops,
               kind) in cases.items():
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        abs_err = (got - ref).abs().max().item()
        err = abs_err / ref.abs().max().item()
        ms, plain_ms = time_ms(kernel), time_ms(plain)
        library = time_ms(lib)
        device = device_only_ms(lib)
        library_device = device["total"] if device else None
        # each call reads its inputs and writes its output once
        bound, by = bound_ms((*inputs, got) * calls, ops, kind)
        log(f"  probe {name:10s} {case}: rel_err={err:.3e} (tol "
            f"{tol:.0e}) max_abs={abs_err:.3e} kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={library} "
            f"library_device_ms={library_device} bound_ms={bound:.6f} ({by})")
        if not err <= tol:
            raise AssertionError(f"{name} {case}: rel error {err}")
        spans = {}
        if name == "chain_tiny":
            spans = {"event_ms": device_ms(kernel, dev, 50),
                     "library_event_ms": device_ms(lib, dev, 50)}
        add_row(rows, name, kernel, getattr(diag, name), per_call=calls,
                case=case,
                err=abs_err, ms=ms, plain=plain_ms, library=library,
                library_device=library_device, bound=bound, bound_by=by,
                **spans)
        if spans:
            log(f"  probe chain_tiny: event span {spans['event_ms']:.4f} ms "
                f"a chain (the 64-call tile + 1 chain "
                f"{spans['library_event_ms']:.4f}), kernel sum "
                f"{rows[name][-1]['device']['total']:.4f} ms (counts the "
                f"launches' overlap twice); kernel_ms <= library_ms: "
                f"{ms <= library}")


def phase_width(dev, llm, quant, fused):
    """Phase 4: Mistral width, 2 layers, card against the CPU path: Q4 and
    Q8 prefill; Q4 with both levers through prefill and 8 decode steps."""
    cfg = llm.LLMConfig.mistral_7b()._replace(n_layers=2, max_seq=512,
                                              sliding_window=512)
    toks = torch.randint(0, 256, (256,),
                         generator=torch.Generator().manual_seed(SEED))
    for bits, tol in ((4, WIDTH_TOL), (8, EXACT_WIDTH_TOL)):
        params = llm.init_params_quantized(
            torch.Generator(device=dev).manual_seed(SEED), cfg, bits=bits,
            device=dev)
        cpu = llm.params_to(params, torch.device("cpu"))
        for bucket, length in ((64, 50), (256, 200)):
            lg, _ = llm.prefill(params, cfg, toks[:bucket].to(dev), length,
                                llm.KVCache.create(cfg, device=dev))
            lc, _ = llm.prefill(cpu, cfg, toks[:bucket], length,
                                llm.KVCache.create(cfg, device="cpu"))
            err = rel_l2(lg.cpu(), lc)
            log(f"  width Q{bits} prefill bucket={bucket}: rel_l2 card vs "
                f"cpu = {err:.3e} (tol {tol:.0e})")
            if not (torch.isfinite(lg).all() and err < tol):
                raise AssertionError(f"width Q{bits} bucket {bucket}: {err}")
    # params / cpu now hold the Q8 model; the levers run on Q4.
    params = llm.init_params_quantized(
        torch.Generator(device=dev).manual_seed(SEED), cfg, bits=4,
        device=dev)
    cpu = llm.params_to(params, torch.device("cpu"))
    steps = torch.randint(0, cfg.vocab_size, (8,),
                          generator=torch.Generator().manual_seed(SEED + 1))
    with levers_on():
        counts = (quant.q4_matmul_f32a.launches, fused.fused_mlp_q4.launches,
                  quant.q4_matmul_w4a8.launches)
        lg, cg = llm.prefill(params, cfg, toks[:64].to(dev), 50,
                             llm.KVCache.create(cfg, device=dev))
        lc, cc = llm.prefill(cpu, cfg, toks[:64], 50,
                             llm.KVCache.create(cfg, device="cpu"))
        errs = [rel_l2(lg.cpu(), lc)]
        for tok in steps.tolist():
            lg, cg = llm.decode_step(params, cfg, tok, cg)
            lc, cc = llm.decode_step(cpu, cfg, tok, cc)
            if not torch.isfinite(lg).all():
                raise AssertionError("width levers: non-finite logits")
            errs.append(rel_l2(lg.cpu(), lc))
        ran = (quant.q4_matmul_f32a.launches - counts[0],
               fused.fused_mlp_q4.launches - counts[1],
               quant.q4_matmul_w4a8.launches - counts[2])
    log(f"  width Q4 both levers, prefill bucket=64 + 8 decode steps: max "
        f"rel_l2 card vs cpu = {max(errs):.3e} (tol {EXACT_WIDTH_TOL:.0e});"
        f" launches f32a={ran[0]} fused={ran[1]} w4a8={ran[2]}")
    if not max(errs) < EXACT_WIDTH_TOL:
        raise AssertionError(f"width levers: rel L2 {errs}")
    if ran[0] == 0 or ran[1] != 8 * cfg.n_layers or ran[2] != 0:
        raise AssertionError(f"width levers took the wrong routes: {ran}")


@contextlib.contextmanager
def levers_on(names=LEVERS):
    """The levers ``names`` (TRACKIE_Q4_F32A=1 and TRACKIE_FUSED_MLP=1 by
    default) set inside the block; the environment is restored after,
    whatever happened."""
    saved = {name: os.environ.get(name) for name in names}
    try:
        for name in names:
            os.environ[name] = "1"
        yield
    finally:
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value


class LogitWatch:
    """Wraps the model's forward entry points (and, given ``paging``, the
    paged batch step) to record, without a host sync, whether each logit
    tensor they return is finite."""

    NAMES = ("prefill", "extend", "decode_step", "prefill_batch",
             "decode_step_batch")

    def __init__(self, llm, paging=None):
        self.flags = []
        targets = [(llm, n) for n in self.NAMES]
        if paging is not None:
            targets.append((paging, "decode_step_batch_paged"))
        self.orig = [(m, n, getattr(m, n)) for m, n in targets]
        for m, n, fn in self.orig:
            setattr(m, n, self._wrap(fn))

    def _wrap(self, fn):
        def watched(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.flags.append(torch.isfinite(out[0]).all())
            return out
        return watched

    def close(self) -> int:
        for m, n, fn in self.orig:
            setattr(m, n, fn)
        if not all(bool(f) for f in self.flags):
            raise AssertionError("a logit vector was not finite")
        return len(self.flags)


def request(runner, prompt: str, tag: str) -> dict:
    """One request through the streaming session API, timed in two parts:
    prompt ingestion (prefill) and decode; returns the numbers it logs."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.prepare_generation(prompt)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pieces = []
    while (piece := runner.generate_next_token()) is not None:
        pieces.append(piece)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    n_prompt = runner.count_tokens(prompt) + 1
    n_out = len(runner.generated_ids)
    text = "".join(pieces)
    log(f"  request {tag}: prompt_tokens={n_prompt} prefill_ms="
        f"{(t1 - t0) * 1e3:.2f} generated_tokens={n_out} text_bytes="
        f"{len(text.encode())} decode_tok_s={n_out / (t2 - t1):.2f}")
    if n_out == 0:
        raise AssertionError(f"request {tag} generated nothing")
    return {"prompt_tokens": n_prompt, "prefill_ms": (t1 - t0) * 1e3,
            "tokens": n_out, "decode_ms_per_token": (t2 - t1) * 1e3 / n_out,
            "decode_tok_s": n_out / (t2 - t1)}


def _flat(tree, prefix=""):
    """(path, tensor) for every tensor of a param tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}.{k}")
    elif isinstance(tree, tuple):  # QuantizedLinear
        yield from _flat(tree.values, prefix + ".values")
        yield from _flat(tree.scales, prefix + ".scales")
    else:
        yield prefix, tree


def param_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in _flat(tree))


def build_model(dev, llm, cfg, bits: int):
    """Random quantized params (group 256) from the seed, on the card."""
    t0 = time.perf_counter()
    params = llm.init_params_quantized(
        torch.Generator(device=dev).manual_seed(SEED), cfg, bits=bits,
        device=dev)
    torch.cuda.synchronize()
    log(f"  params: {cfg.n_layers} layers Q{bits} in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{param_bytes(params) / 2 ** 30:.2f} GiB on the card")
    return params


def drive(dev, llm, runner_mod, tokenizer_mod, params, cfg, counters,
          steps: str):
    """Answer the requests named in ``steps`` behind ``LLMRunner``: (a) a
    short prompt (bucket 64), (b) the cortex prompt (bucket 512), (c) a
    ``chat()`` follow-up (extend), (d) the cortex prompt rebuilt (prefix
    reuse) at temperature 0.7; then greedy (a) again at lookahead 4 and 1.
    Every counter is zeroed just before and read just after; returns the
    counts."""
    tok = tokenizer_mod.ByteTokenizer(cfg.vocab_size)
    gen = runner_mod.GenerationConfig(max_tokens=96, temperature=0.0,
                                      speculative=False)
    runner = runner_mod.LLMRunner(params, cfg, tok, gen, device=dev)
    prompt_a = SHORT_PROMPT
    prompt_b = runner.build_prompt(SYSTEM, CONTEXT,
                                   "What is in front of me right now?")
    prompt_d = runner.build_prompt(SYSTEM, CONTEXT,
                                   "Can I walk to the door safely?")
    n_b = runner.count_tokens(prompt_b) + 1
    if not 200 <= n_b <= 400:
        raise AssertionError(f"cortex prompt is {n_b} tokens, not 200-400")
    runner.generate(prompt_a)  # warm-up: allocator, cuBLAS, first launches

    for fn in counters.values():
        fn.launches = 0
    watch = LogitWatch(llm)
    try:
        if "a" in steps:
            request(runner, prompt_a, "a (short, bucket 64)")
        if "b" in steps:
            bucket = runner_mod._bucket_for(n_b, runner_mod.PREFILL_BUCKETS)
            request(runner, prompt_b,
                    f"b (cortex, {n_b} tokens, bucket {bucket})")
        if "c" in steps:
            t0 = time.perf_counter()
            reply = runner.chat("And what about the bicycle?")
            torch.cuda.synchronize()
            n_c = len(runner.generated_ids)
            log(f"  request c (chat follow-up, extend): reply_ms="
                f"{(time.perf_counter() - t0) * 1e3:.2f} generated_tokens="
                f"{n_c} text_bytes={len(reply.encode())}")
            if n_c == 0:
                raise AssertionError("the chat follow-up generated nothing")
        if "d" in steps:
            runner.gen.temperature = 0.7
            request(runner, prompt_d, "d (cortex rebuilt, prefix reuse, "
                    "temperature 0.7)")
            runner.gen.temperature = 0.0
        text_k4 = runner.generate(prompt_a)
        ids_k4 = runner.generated_ids
        serial = runner_mod.LLMRunner(
            params, cfg, tok, runner_mod.GenerationConfig(
                max_tokens=96, temperature=0.0, speculative=False,
                lookahead=1), device=dev)
        text_k1 = serial.generate(prompt_a)
        ids_k1 = serial.generated_ids
    finally:
        n_logits = watch.close()
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"  launches: {launches}; finite logit vectors: {n_logits}")
    # Random weights over a 32000-id vocab rarely pick a byte id (< 256),
    # so the text can be short: the token ids are compared as well.
    if text_k4.encode() != text_k1.encode() or ids_k4 != ids_k1:
        raise AssertionError("lookahead 4 and 1 gave different replies")
    if not ids_k4:
        raise AssertionError("request a generated nothing")
    log(f"  lookahead 4 == lookahead 1: {len(ids_k4)} token ids and "
        f"{len(text_k4.encode())} text bytes identical")
    return launches


# The kernels that each main-path wrapper launches, one a call, by the
# names the profiler gives them (substrings of its keys).
PROFILED_KERNELS = {
    "q4_matmul_w4a8": ("q4_w4a8_kernel",),
    "quantize_activations": ("quantize_act_kernel",),
    "flash_attention": ("flash_mma_kernel", "flash_fwd_kernel"),
    "q8_matmul": ("q8_mma_kernel", "q8_fma_kernel"),
    "q4_matmul_f32a": ("q4_f32a_mma_kernel", "q4_f32a_fma_kernel"),
    "fused_mlp_q4": ("fused_mlp_q4_kernel",),
}


def launch_counters() -> dict:
    """Every kernel wrapper by name: each counts its launches in
    ``launches``."""
    from trackiellm_tpu_torch.ops import attention, diag, fused, quant
    return {"q4_matmul_w4a8": quant.q4_matmul_w4a8,
            "quantize_activations": quant.quantize_activations,
            "flash_attention": attention.flash_attention,
            "q8_matmul": quant.q8_matmul,
            "q4_matmul_f32a": quant.q4_matmul_f32a,
            "fused_mlp_q4": fused.fused_mlp_q4,
            "q4_matmul_stream": quant.q4_matmul_stream,
            "stream": diag.stream, "grid64": diag.grid64,
            "chain_tiny": diag.chain_tiny}


def missed_launches(by_name, counted):
    """None when a profile (``by_name``: kernel name -> (ms, count)) shows
    as many launches of each main-path wrapper's kernels as its counter
    rose by in the window (``counted``); else what it missed."""
    missed = []
    for wrapper, names in PROFILED_KERNELS.items():
        seen = sum(n for key, (_, n) in by_name.items()
                   if any(name in key for name in names))
        if seen != counted.get(wrapper, 0):
            missed.append(f"{wrapper} {seen} of {counted.get(wrapper, 0)}")
    return "profiler saw " + ", ".join(missed) if missed else None


def profile_path(dev, runner_mod, tokenizer_mod, params, cfg) -> dict:
    """The breakdown of phases 5 (Q4) and 6 (Q8), on fresh runners: the
    cortex prompt's prefill (bucket 512), then PROFILE_TOKENS greedy decode
    tokens (lookahead 4).
    Each window runs once on the host clock (wall) and once under the
    profiler (device busy ms, launches, the largest costs by kernel, and
    the copy and cast kernels, whose names hold "copy"); the idle share is
    1 - busy / wall. A profile must show every launch the wrappers counted
    in its window, by kernel name; one that misses some is taken again on
    a fresh runner, up to PROFILE_RETRIES times, and a window that never
    shows them all keeps its wall and a ``partial`` note, and no device
    numbers."""
    tok = tokenizer_mod.ByteTokenizer(cfg.vocab_size)
    gen = runner_mod.GenerationConfig(max_tokens=PROFILE_TOKENS,
                                      temperature=0.0, speculative=False)
    counters = launch_counters()

    def windows():
        runner = runner_mod.LLMRunner(params, cfg, tok, gen, device=dev)
        prompt = runner.build_prompt(SYSTEM, CONTEXT,
                                     "What is in front of me right now?")

        def decode():
            while runner.generate_next_token() is not None:
                pass
        return runner, (lambda: runner.prepare_generation(prompt), decode)

    runner, fns = windows()
    wall = []
    for fn in fns:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    tokens = len(runner.generated_ids)
    out = {}
    for i, name, ms, per in zip((0, 1), ("prefill", "decode"), wall,
                                (1, max(tokens, 1))):
        for _ in range(1 + PROFILE_RETRIES):
            _, fns = windows()
            for fn in fns[:i]:  # the decode window follows its prefill
                fn()
            before = {k: f.launches for k, f in counters.items()}
            busy, n, by_name = device_breakdown(fns[i])
            note = missed_launches(by_name, {
                k: f.launches - before[k] for k, f in counters.items()})
            if note is None:
                break
        if note is not None:
            out[name] = {"wall_ms": ms / per, "partial": note}
            log(f"  profile {name}: partial after {PROFILE_RETRIES} "
                f"retries, {note}")
            continue
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
        copies = {k[:80]: [t / per, c / per] for k, (t, c) in by_name.items()
                  if "copy" in k}
        out[name] = {
            "wall_ms": ms / per, "busy_ms": busy / per,
            "idle_share": 1.0 - busy / ms, "launches": n / per,
            "top": [[k[:80], t / per, c / per] for k, (t, c) in top],
            "copy_ms": sum(t for t, _ in copies.values()),
            "copies": copies}
        log(f"  profile {name}: wall {out[name]['wall_ms']:.2f} ms busy "
            f"{out[name]['busy_ms']:.2f} ms, {out[name]['launches']:.0f} "
            f"launches (copies and casts {out[name]['copy_ms']:.2f} ms)"
            + (f" per token over {tokens} tokens" if i else ""))
    out["decode"]["tokens"] = tokens
    return out


def expect_routes(launches, ran, idle, phase: str) -> None:
    """The kernels in ``ran`` launched on this path; those in ``idle``
    (routes it does not take) did not."""
    for name in ran:
        if launches[name] == 0:
            raise AssertionError(f"{phase}: {name} never launched")
    for name in idle:
        if launches[name] != 0:
            raise AssertionError(f"{phase}: {name} launched "
                                 f"{launches[name]} times off its route")


def spm_spec(vocab_size: int) -> dict:
    """A SentencePiece tokenizer spec, as the JAX package's converter stores
    one in a checkpoint's metadata: llama's specials, the 256 byte-fallback
    pieces, then word pieces, so every id the model draws prints text."""
    pieces = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    words = ["\u2581"] + [chr(c) for c in range(ord("a"), ord("z") + 1)]
    words += ["\u2581" + chr(c) for c in range(ord("a"), ord("z") + 1)]
    words += [f"\u2581w{i}" for i in range(vocab_size - len(pieces)
                                           - len(words))]
    return {"model": "spm", "tokens": pieces + words,
            "scores": [0.0] * len(pieces) + [-float(i)
                                             for i in range(len(words))],
            "token_types": [2, 3, 3] + [6] * 256 + [1] * len(words),
            "pad_id": 0, "add_space_prefix": True}


def _gguf_str(text: str) -> bytes:
    data = text.encode("utf-8")
    return struct.pack("<Q", len(data)) + data


# numpy scalar dtype -> GGUF metadata value type
_GGUF_KV_TYPES = {"uint8": 0, "int8": 1, "uint16": 2, "int16": 3,
                  "uint32": 4, "int32": 5, "float32": 6, "bool": 7,
                  "uint64": 10, "int64": 11, "float64": 12}


def _gguf_kv(value) -> bytes:
    """One metadata value with its type: a numpy scalar as its dtype, a
    bool, a str, an int (uint32, or int32 below 0), a float (f32), or a list
    of str, int (int32) or float (f32)."""
    if isinstance(value, np.generic):
        return (struct.pack("<I", _GGUF_KV_TYPES[value.dtype.name])
                + value.astype(value.dtype.newbyteorder("<")).tobytes())
    if isinstance(value, bool):
        return struct.pack("<I?", 7, value)
    if isinstance(value, str):
        return struct.pack("<I", 8) + _gguf_str(value)
    if isinstance(value, int):
        return struct.pack("<Ii" if value < 0 else "<II",
                           5 if value < 0 else 4, value)
    if isinstance(value, float):
        return struct.pack("<If", 6, value)
    if isinstance(value, (list, tuple)):
        head = struct.pack("<I", 9)
        if all(isinstance(x, str) for x in value):
            return (head + struct.pack("<IQ", 8, len(value))
                    + b"".join(_gguf_str(x) for x in value))
        if all(isinstance(x, int) for x in value):
            return (head + struct.pack("<IQ", 5, len(value))
                    + np.asarray(value, "<i4").tobytes())
        if all(isinstance(x, float) for x in value):
            return (head + struct.pack("<IQ", 6, len(value))
                    + np.asarray(value, "<f4").tobytes())
    raise TypeError(f"no GGUF metadata type for {value!r}")


def write_gguf(path: str, tensors, metadata, align: int = 32) -> int:
    """Write a GGUF v3 file; returns its size in bytes. ``tensors``:
    {name: (array, GGML_F32 or GGML_F16)}, or {name: (raw uint8 blocks,
    ggml type, shape)}, shapes outermost first as numpy has them;
    ``metadata``: {key: value} as ``_gguf_kv`` takes it. Each tensor is
    written whole (a full-width model cannot wait for a writer that
    quantizes block by block in Python); the same tensors and metadata give
    the bytes of ``tests/test_loader.py:write_gguf``."""
    head = [b"GGUF", struct.pack("<IQQ", 3, len(tensors), len(metadata))]
    for key, value in metadata.items():
        head += [_gguf_str(key), _gguf_kv(value)]
    blobs, offset = [], 0
    for name, spec in tensors.items():
        if len(spec) == 3:
            raw, gtype, shape = spec
            data = np.ascontiguousarray(raw, np.uint8)
        else:
            arr, gtype = spec
            shape = arr.shape
            data = np.ascontiguousarray(
                arr, {GGML_F32: "<f4", GGML_F16: "<f2"}[gtype])
        dims = tuple(reversed(shape))  # GGUF stores innermost first
        head += [_gguf_str(name), struct.pack(f"<I{len(dims)}QIQ", len(dims),
                                              *dims, gtype, offset)]
        blobs.append(data)
        offset += -(-data.nbytes // align) * align
    header = b"".join(head)
    with open(path, "wb") as f:
        f.write(header + b"\0" * (-len(header) % align))
        for data in blobs:
            f.write(memoryview(data.reshape(-1).view(np.uint8)))
            f.write(b"\0" * (-data.nbytes % align))
    return os.path.getsize(path)


def kquant_blocks(rng, gtype: int, shape) -> np.ndarray:
    """Seeded random raw blocks (uint8) of a ``gtype`` tensor of ``shape``,
    with each block's f16 d (and dmin) small and finite."""
    per, nbytes, d_at, dmin_at, d_range = GGML_BLOCKS[gtype]
    n = math.prod(shape) // per
    raw = rng.integers(0, 256, (n, nbytes), dtype=np.uint8)
    d = rng.uniform(*d_range, n).astype("<f2")
    raw[:, d_at:d_at + 2] = d.view(np.uint8).reshape(n, 2)
    if dmin_at is not None:
        dmin = (d.astype(np.float32) * 7.5).astype("<f2")
        raw[:, dmin_at:dmin_at + 2] = dmin.view(np.uint8).reshape(n, 2)
    return raw.reshape(-1)


def mistral_gguf(cfg, spec: dict, seed: int):
    """(tensors, metadata) of a llama-arch GGUF of ``cfg``'s shapes at
    llama.cpp's Q4_K_M mix, as ``write_gguf`` takes them: seeded random
    raw blocks for the matrices, F32 norms about 1, and the SentencePiece
    vocabulary of ``spec`` (pieces, scores, token types, add_space_prefix)
    in the tokenizer keys llama.cpp writes."""
    rng = np.random.default_rng(seed)
    qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    shapes = {"attn_q": (qd, cfg.dim), "attn_k": (kvd, cfg.dim),
              "attn_v": (kvd, cfg.dim), "attn_output": (cfg.dim, qd),
              "ffn_gate": (cfg.hidden_dim, cfg.dim),
              "ffn_up": (cfg.hidden_dim, cfg.dim),
              "ffn_down": (cfg.dim, cfg.hidden_dim)}

    def quantized(kind, shape):
        return kquant_blocks(rng, Q4_K_M[kind], shape), Q4_K_M[kind], shape

    def norm():
        return (1.0 + 0.1 * rng.standard_normal(cfg.dim, np.float32),
                GGML_F32)
    tensors = {"token_embd.weight": quantized(
        "token_embd", (cfg.vocab_size, cfg.dim))}
    for i in range(cfg.n_layers):
        tensors[f"blk.{i}.attn_norm.weight"] = norm()
        tensors[f"blk.{i}.ffn_norm.weight"] = norm()
        for kind, shape in shapes.items():
            tensors[f"blk.{i}.{kind}.weight"] = quantized(kind, shape)
    tensors["output_norm.weight"] = norm()
    tensors["output.weight"] = quantized("output", (cfg.vocab_size, cfg.dim))
    metadata = {
        "general.architecture": "llama",
        "general.name": "mistral-7b random Q4_K_M",
        "general.file_type": 15,  # llama.cpp's LLAMA_FTYPE_MOSTLY_Q4_K_M
        "llama.context_length": cfg.max_seq,
        "llama.embedding_length": cfg.dim,
        "llama.block_count": cfg.n_layers,
        "llama.feed_forward_length": cfg.hidden_dim,
        "llama.rope.dimension_count": cfg.head_dim,
        "llama.attention.head_count": cfg.n_heads,
        "llama.attention.head_count_kv": cfg.n_kv_heads,
        # f64 (GGUF type 12), so the config reads back 1e-5 exactly.
        "llama.attention.layer_norm_rms_epsilon": np.float64(cfg.norm_eps),
        "llama.rope.freq_base": float(cfg.rope_theta),
        "tokenizer.ggml.model": "llama",
        "tokenizer.ggml.tokens": spec["tokens"],
        "tokenizer.ggml.scores": spec["scores"],
        "tokenizer.ggml.token_type": spec["token_types"],
        "tokenizer.ggml.bos_token_id": 1,
        "tokenizer.ggml.eos_token_id": 2,
        "tokenizer.ggml.unknown_token_id": 0,
        "tokenizer.ggml.padding_token_id": spec["pad_id"],
        "tokenizer.ggml.add_space_prefix": spec["add_space_prefix"],
    }
    return tensors, metadata


def _peak_rss() -> int:
    """This process's peak resident bytes so far (``ru_maxrss``, in KiB on
    Linux). Linux carries it across exec from the forking parent, so a
    process measured alone is started by a small one
    (``tools/convert_times.py``)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


@contextlib.contextmanager
def conversion_timer(convert, cli):
    """Host seconds of a conversion inside the block, by part: reading and
    dequantizing GGML tensors (by tensor name), requantizing on the device
    (by call, synchronized), and saving the checkpoint; and where the
    process's peak resident bytes grew, by 256 MiB or more, as [what had
    just run, bytes]. Yields the dict they go into; the patched functions
    are restored after."""
    split = {"dequant": {}, "requant": [], "save": 0.0,
             "peak_rss": [["start", _peak_rss()]]}
    saved = {name: getattr(convert, name) for name in
             ("load_gguf_tensor", "quantize_q4", "quantize_q8")}
    save = cli.save_checkpoint

    def peak(after: str) -> None:
        rss = _peak_rss()
        if rss >= split["peak_rss"][-1][1] + 2 ** 28:
            split["peak_rss"].append([after, rss])

    def dequant(gguf, name):
        t0 = time.perf_counter()
        try:
            return saved["load_gguf_tensor"](gguf, name)
        finally:
            split["dequant"][name] = (split["dequant"].get(name, 0.0)
                                      + time.perf_counter() - t0)
            peak(name)

    def requant(fn):
        def timed(w, group):
            t0 = time.perf_counter()
            q = fn(w, group)
            if q.values.is_cuda:
                torch.cuda.synchronize()
            split["requant"].append(time.perf_counter() - t0)
            peak(f"requantization {len(split['requant'])}")
            return q
        return timed

    def timed_save(*args, **kwargs):
        t0 = time.perf_counter()
        save(*args, **kwargs)
        split["save"] += time.perf_counter() - t0
        peak("save")
    convert.load_gguf_tensor = dequant
    convert.quantize_q4 = requant(saved["quantize_q4"])
    convert.quantize_q8 = requant(saved["quantize_q8"])
    cli.save_checkpoint = timed_save
    try:
        yield split
    finally:
        for name, fn in saved.items():
            setattr(convert, name, fn)
        cli.save_checkpoint = save


def conversion_split(split: dict, total_s: float, layers: int) -> dict:
    """``conversion_timer``'s seconds as totals and per layer: the layers'
    dequantization and requantization (four matrices a layer, in order
    before the head's), and the rest of the total."""
    layer_dequant = sum(t for name, t in split["dequant"].items()
                        if name.startswith("blk."))
    layer_requant = sum(split["requant"][:4 * layers])
    dequant, requant = (sum(split["dequant"].values()),
                        sum(split["requant"]))
    return {"total_s": total_s, "dequant_s": dequant, "requant_s": requant,
            "save_s": split["save"],
            "peak_rss_steps": split["peak_rss"],
            "other_s": total_s - dequant - requant - split["save"],
            "layer_dequant_s": layer_dequant / layers,
            "layer_requant_s": layer_requant / layers}


def run_cli(cli, argv):
    """``python -m trackiellm_tpu_torch`` in-process: (exit code, printed
    text, seconds)."""
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    return rc, out.getvalue(), time.perf_counter() - t0


def _same_bytes(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = a.detach().cpu().contiguous(), b.detach().cpu().contiguous()
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.view(torch.uint8), b.view(torch.uint8)))


def check_conversion(dev, convert, quant, path: str, params) -> int:
    """Layer 0's four matrices and lm_head of a Q4 conversion on the card
    against the CPU's requantization of the same dequantized tensors, byte
    for byte; the same for Q8 (``quantize_q8`` on the card and the CPU);
    and the bf16 embeddings and norms against the CPU's cast. Returns the
    tensors compared."""
    ref, _ = convert.gguf_to_llm_params(path, bits=None, dtype=torch.float32,
                                        max_layers=1,
                                        device=torch.device("cpu"))
    mats = {name: (params["layers"][name].values[0],
                   params["layers"][name].scales[0],
                   ref["layers"][name][0])
            for name in ("wqkv", "wo", "w_gu", "w_down")}
    mats["lm_head"] = (*params["lm_head"], ref["lm_head"])
    n = 0
    for name, (values, scales, w) in mats.items():
        cpu = quant.quantize_q4(w, GROUP)
        card8, cpu8 = quant.quantize_q8(w.to(dev), GROUP), quant.quantize_q8(
            w, GROUP)
        for kind, a, b in (("Q4 values", values, cpu.values),
                           ("Q4 scales", scales, cpu.scales),
                           ("Q8 values", card8.values, cpu8.values),
                           ("Q8 scales", card8.scales, cpu8.scales)):
            if not _same_bytes(a, b):
                raise AssertionError(f"phase 11: {name} {kind} from the card "
                                     "differ from the CPU's")
            n += 1
    for name, a, b in (
            ("tok_emb", params["tok_emb"], ref["tok_emb"]),
            ("attn_norm", params["layers"]["attn_norm"][0],
             ref["layers"]["attn_norm"][0]),
            ("out_norm", params["out_norm"], ref["out_norm"])):
        if not _same_bytes(a, b.to(torch.bfloat16)):
            raise AssertionError(f"phase 11: {name} in bf16 differs from the "
                                 "CPU's cast")
        n += 1
    return n


def phase_gguf(dev, cfg, llm, convert, checkpoint, quant, tokenizer_mod,
               cli, counters) -> dict:
    """Phase 11: a llama.cpp GGUF to a reply on the card, through the
    CLI's commands in-process: a Q4_K_M file of ``cfg`` (Mistral-7B cut to
    GGUF_LAYERS layers); (a) ``inspect`` names its arch and tensor count, and
    its header the mix's GGML types; (b) ``convert --bits 4`` on the card:
    the config is ``cfg``, the tokenizer spec the
    file's vocabulary, and ``check_conversion`` holds the bytes to the
    CPU's; (c) ``generate`` on the checkpoint: text, W4A8 with its
    quantization and flash launched (a prompt of bucket 256 or 512), the
    plain matmul never run, every logit finite. Returns the times and
    sizes; every counter is zeroed just before (c) and read just after."""
    from trackiellm_tpu_torch.models import loader
    start = time.perf_counter()
    spec = spm_spec(cfg.vocab_size)
    out = {"layers": cfg.n_layers}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gguf_") as tmp:
        path, ckpt = os.path.join(tmp, "mistral.gguf"), os.path.join(
            tmp, "ckpt")
        t0 = time.perf_counter()
        tensors, metadata = mistral_gguf(cfg, spec, SEED)
        out["file_bytes"] = write_gguf(path, tensors, metadata)
        out["write_s"] = time.perf_counter() - t0
        types = {name: spec_[1] for name, spec_ in tensors.items()}
        del tensors
        log(f"  GGUF: {out['file_bytes'] / 1e9:.3f} GB, {len(types)} "
            f"tensors, written in {out['write_s']:.1f} s")

        rc, text, out["inspect_s"] = run_cli(cli, ["inspect", path])
        info = json.loads(text)
        header = loader.read_gguf_header(path)
        if (rc != 0 or info.get("architecture") != "llama"
                or info.get("n_tensors") != len(types)
                or {n: t.ggml_type for n, t in header.tensors.items()}
                != types):
            raise AssertionError(f"phase 11: inspect gave {info} (exit {rc})")
        log(f"  inspect: {info} in {out['inspect_s']:.2f} s; header types "
            "are the Q4_K_M mix")

        with conversion_timer(convert, cli) as split:
            rc, text, total = run_cli(
                cli, ["convert", path, "-o", ckpt, "--bits", "4"])
        if rc != 0:
            raise AssertionError(f"phase 11: convert exited {rc}: {text}")
        out["convert"] = conversion_split(split, total, cfg.n_layers)
        out["checkpoint_bytes"] = sum(
            os.path.getsize(os.path.join(ckpt, f)) for f in os.listdir(ckpt))
        t0 = time.perf_counter()
        params, lcfg, meta = checkpoint.load_checkpoint(ckpt, device=dev)
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        if lcfg != cfg:
            raise AssertionError(f"phase 11: converted config {lcfg}")
        if meta.get("tokenizer_spec") != spec or meta.get("bits") != 4:
            raise AssertionError("phase 11: the checkpoint's tokenizer spec "
                                 "is not the file's vocabulary")
        t0 = time.perf_counter()
        out["bytes_checked"] = check_conversion(dev, convert, quant, path,
                                                params)
        out["check_s"] = time.perf_counter() - t0
        del params
        log(f"  convert --bits 4: {json.dumps(out['convert'])}; checkpoint "
            f"{out['checkpoint_bytes'] / 1e9:.3f} GB, load "
            f"{out['load_s']:.2f} s; config, tokenizer spec and "
            f"{out['bytes_checked']} tensors equal to the CPU's (checked in "
            f"{out['check_s']:.1f} s)")

        prompt = f"{SYSTEM} {CONTEXT}"
        n_prompt = len(tokenizer_mod.tokenizer_from_spec(spec).encode(
            prompt)) + 1
        if not 128 < n_prompt <= 512:
            raise AssertionError(f"phase 11: the prompt is {n_prompt} tokens")
        plain_calls = []
        plain = quant.quantized_matmul_ref
        quant.quantized_matmul_ref = (
            lambda *a: plain_calls.append(1) or plain(*a))
        for fn in counters.values():
            fn.launches = 0
        watch = LogitWatch(llm)
        try:
            rc, text, out["generate_s"] = run_cli(
                cli, ["generate", ckpt, "-p", prompt, "--max-tokens",
                      str(GGUF_TOKENS)])
        finally:
            quant.quantized_matmul_ref = plain
            n_logits = watch.close()
    out["launches"] = {name: fn.launches for name, fn in counters.items()}
    out["phase_s"] = time.perf_counter() - start
    log(f"  generate ({n_prompt} prompt tokens): exit {rc} in "
        f"{out['generate_s']:.2f} s, {n_logits} finite logit vectors, "
        f"printed {text[:60]!r}; launches: {out['launches']}")
    if rc != 0 or not text.strip():
        raise AssertionError(f"phase 11: generate exited {rc} and printed "
                             f"{text!r}")
    if plain_calls:
        raise AssertionError(f"phase 11: quantized_matmul_ref ran "
                             f"{len(plain_calls)} times")
    expect_routes(out["launches"], ("q4_matmul_w4a8", "quantize_activations",
                                    "flash_attention"),
                  ("q8_matmul", "q4_matmul_f32a", "fused_mlp_q4",
                   *DIAGNOSTIC), "phase 11")
    return out


def phase_entry(dev, llm, checkpoint, cli, counters):
    """Phase 8: a 2-layer Mistral-width Q8 checkpoint through the port's
    writer and reader, then the ``generate`` command on it, in-process."""
    cfg = llm.LLMConfig.mistral_7b()._replace(n_layers=2, max_seq=512,
                                              sliding_window=512)
    params = build_model(dev, llm, cfg, 8)
    meta = {"source": "chip_smoke.py", "bits": 8,
            "tokenizer_spec": spm_spec(cfg.vocab_size)}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt:
        t0 = time.perf_counter()
        checkpoint.save_checkpoint(ckpt, params, config=cfg, metadata=meta)
        t1 = time.perf_counter()
        loaded, lcfg, lmeta = checkpoint.load_checkpoint(ckpt, device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        size = sum(os.path.getsize(os.path.join(ckpt, f))
                   for f in os.listdir(ckpt))
        want, got = dict(_flat(params)), dict(_flat(loaded))
        if lcfg != cfg or lmeta != meta or want.keys() != got.keys():
            raise AssertionError("the checkpoint did not round-trip")
        for name, t in want.items():
            u = got[name]
            if (u.dtype != t.dtype or u.device != t.device or not torch.equal(
                    u.view(torch.uint8), t.view(torch.uint8))):
                raise AssertionError(f"checkpoint leaf {name} differs")
        log(f"  checkpoint: {size / 2 ** 30:.2f} GiB on disk, save "
            f"{t1 - t0:.2f} s, load {t2 - t1:.2f} s, {len(want)} tensors "
            "byte-equal, config and metadata equal")
        del loaded, got
        for fn in counters.values():
            fn.launches = 0
        rc, text, elapsed = run_cli(cli, ["generate", ckpt, "-p",
                                          "descreva a cena a sua frente",
                                          "--max-tokens", "32"])
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"  generate: exit {rc} in {elapsed:.2f} s, printed {len(text)} "
        f"chars {text[:60]!r}; launches: {launches}")
    if rc != 0 or not text.strip():
        raise AssertionError(f"generate exited {rc} and printed {text!r}")
    expect_routes(launches, ("q8_matmul",),
                  ("q4_matmul_w4a8", "quantize_activations", *DIAGNOSTIC),
                  "phase 8")


def phase_diagnostics(dev, params, cfg, counters) -> dict:
    """Phase 9: the three diagnostic tools' measurement functions on the
    card; phase 5's model (``cfg``'s 32 layers) is cut to 32/16/8 layers by
    views. Returns the launches; prints the numbers as one JSON line."""
    from trackiellm_tpu_torch.tools import (diag_envelope, diag_overhead,
                                            diag_scan_overhead)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = {"overhead": {"tiny_us": diag_overhead.tiny(dev),
                        "stream_handle_us":
                            diag_overhead.stream_handle_us(dev),
                        **diag_overhead.q4_sweep(dev),
                        "rmsnorm_us": diag_overhead.rmsnorm(dev)},
           "scan": diag_scan_overhead.run(dev),
           "envelope": diag_envelope.envelope(dev),
           "decode": diag_envelope.decode_composition(params, cfg, dev)}
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"  diagnostics in {time.perf_counter() - t0:.1f} s; launches: "
        f"{launches}")
    log(json.dumps({"diagnostics": out}))
    expect_routes(launches, DIAGNOSTIC, (), "phase 9")
    return launches


def conforms(value, schema) -> bool:
    """Whether ``value`` conforms to ``schema`` in the subset phase 10's
    schemas use (type, enum, properties, required, items, maxItems); no
    schema: any JSON object."""
    if schema is None:
        return isinstance(value, dict)
    if "enum" in schema and value not in schema["enum"]:
        return False
    kind = schema.get("type")
    if kind == "object":
        props = schema.get("properties", {})
        return (isinstance(value, dict) and set(value) <= set(props)
                and set(schema.get("required", ())) <= set(value)
                and all(conforms(v, props[k]) for k, v in value.items()))
    if kind == "array":
        return (isinstance(value, list)
                and len(value) <= schema.get("maxItems", len(value))
                and all(conforms(v, schema.get("items", {})) for v in value))
    types = {"string": str, "boolean": bool, "number": (int, float),
             "integer": int}
    if kind in types:
        return (isinstance(value, types[kind])
                and (kind == "boolean" or not isinstance(value, bool)))
    return True


def timed_reply(runner, tag: str, prompt: str, **kw):
    """One ``generate`` with its wall ms, tokens and the grammar mask's host
    ms a token logged (0 for an unconstrained reply). Returns the text and
    the number of tokens sampled under the grammar's mask, which lead the
    reply (a budget's closure follows them)."""
    mask_s, n_masked = [0.0], [0]
    masks = runner._grammar_mask

    def timed_mask():
        t = time.perf_counter()
        n_masked[0] += 1
        try:
            return masks()
        finally:
            mask_s[0] += time.perf_counter() - t
    runner._grammar_mask = timed_mask
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        text = runner.generate(prompt, **kw)
        torch.cuda.synchronize()
    finally:
        del runner._grammar_mask
    n = len(runner.generated_ids)
    log(f"  request {tag}: wall_ms={(time.perf_counter() - t0) * 1e3:.2f} "
        f"tokens={n} masked_tokens={n_masked[0]} mask_ms_per_token="
        f"{mask_s[0] * 1e3 / max(n, 1):.3f} text={text[:120]!r}")
    if n == 0:
        raise AssertionError(f"request {tag} generated nothing")
    return text, n_masked[0]


def long_prompt(runner) -> str:
    """A cortex prompt whose context repeats until it takes 600-1000
    tokens (prefill bucket 1024)."""
    reps = 1
    while True:
        prompt = runner.build_prompt(SYSTEM, " ".join([CONTEXT] * reps),
                                     "Describe everything around me.")
        n = runner.count_tokens(prompt) + 1
        if n >= LONG_PROMPT[0]:
            if n > LONG_PROMPT[1]:
                raise AssertionError(f"long prompt is {n} tokens")
            return prompt
        reps += 1


def phase_slice10(dev, llm, runner_mod, tokenizer_mod, quant, params, cfg,
                  counters) -> dict:
    """Phase 10: tool calls and speculation on phase 5's Q4 model under
    ``cfg`` (max_seq 2048: bucket 1024 exists), on the default routes.
    (e) a forced tool call on the cortex prompt with three tools (two with
    an argument schema), greedy, then add_tool_response and the follow-up
    reply, and one offering only the two schema'd tools; (f)
    ``response_schema`` at temperature 0.7, twice from one seed, whose
    sampled tokens must hold more than whitespace; (g) greedy speculation,
    "auto" and True, against plain decode on the short and the cortex
    prompts, and with one-token n-grams on a repetitive prompt, where True
    must make passes; (h) sampled speculation on that prompt, twice from
    one seed, with passes (``spec_verify_sampled`` on card tensors); (i) a
    600-1000-token prompt (bucket 1024): the f32a kernel and never the
    plain path; (j) the verify pass, ``extend(all_logits=True)`` on a
    16-token chunk, against 16 decode steps. Counters are zeroed just
    before and read just after; returns the summary (launches in it)."""
    tok = tokenizer_mod.ByteTokenizer(cfg.vocab_size)

    def runner(**gen_kw):
        gen_kw.setdefault("temperature", 0.0)
        return runner_mod.LLMRunner(params, cfg, tok,
                                    runner_mod.GenerationConfig(**gen_kw),
                                    device=dev)
    tools = [runner_mod.ToolDefinition(*t) for t in TOOLS]
    schemas = {t.name: t.schema for t in tools}
    warm = runner(max_tokens=8)
    warm.generate(SHORT_PROMPT)
    warm.generate(long_prompt(warm))   # first bucket-1024 shapes
    del warm
    plain_calls = []
    plain = quant.quantized_matmul_ref
    quant.quantized_matmul_ref = lambda *a: plain_calls.append(1) or plain(*a)
    verify_sampled = runner_mod.sampling.spec_verify_sampled
    verify_devices = []

    def watched_verify(logits, *args, **kw):
        verify_devices.append(logits.device.type)
        return verify_sampled(logits, *args, **kw)
    runner_mod.sampling.spec_verify_sampled = watched_verify
    for fn in counters.values():
        fn.launches = 0
    watch = LogitWatch(llm)
    out = {}
    try:
        r = runner(max_tokens=TOOL_TOKENS)
        ask = r.build_prompt(SYSTEM, CONTEXT, "Take me to the door.", tools)
        text, _ = timed_reply(r, "e (forced tool call, cortex prompt)", ask,
                              tools=tools, force_tool_call=True)
        call = json.loads(text)["tool_call"]
        if (set(json.loads(text)) != {"tool_call"}
                or call["name"] not in schemas
                or not conforms(call["arguments"], schemas[call["name"]])
                or r.parse_tool_call() != call):
            raise AssertionError(f"tool call {text!r} does not conform")
        r.add_tool_response(call["name"], {"ok": True, "distance_m": 4.2})
        follow, _ = timed_reply(r, "e (follow-up after the tool response)",
                                r.build_prompt(SYSTEM, f"Tool {call['name']}"
                                               ": ok", "Take me to the door."))
        rt = runner(max_tokens=TOOL_TOKENS)
        text, _ = timed_reply(rt, "e (forced tool call, the schema'd tools)",
                              ask, tools=tools[:2], force_tool_call=True)
        schema_call = json.loads(text)["tool_call"]
        if (schemas.get(schema_call["name"]) is None
                or schema_call["name"] not in (t.name for t in tools[:2])
                or not conforms(schema_call["arguments"],
                                schemas[schema_call["name"]])
                or rt.parse_tool_call() != schema_call):
            raise AssertionError(f"tool call {text!r} does not conform")
        out["tool_call"] = {"call": call, "follow_up_bytes":
                            len(follow.encode()), "schema_call": schema_call}
        replies = []
        for i in range(2):
            rf = runner(max_tokens=TOOL_TOKENS, temperature=0.7, seed=SEED,
                        repetition_penalty=SCHEMA_PENALTY)
            text, n_masked = timed_reply(
                rf, f"f (response_schema, temperature 0.7, {i})", ask,
                response_schema=RESPONSE_SCHEMA)
            sampled_text = tok.decode(rf.generated_ids[:n_masked])
            replies.append((text, sampled_text))
        if (replies[0] != replies[1]
                or not conforms(json.loads(replies[0][0]), RESPONSE_SCHEMA)
                or not replies[0][1].strip()):
            raise AssertionError(f"schema replies {replies!r}")
        out["response_schema"] = {"reply": json.loads(replies[0][0]),
                                  "sampled": replies[0][1]}
        out["speculation"] = {}
        for name, prompt, kw in (("short", SHORT_PROMPT, {}),
                                 ("cortex", ask, {}),
                                 ("repeat", REPEAT_PROMPT,
                                  {"spec_min_ngram": 1})):
            ids = {}
            for spec in (False, "auto", True):
                rs = runner(max_tokens=SPEC_TOKENS, speculative=spec, **kw)
                timed_reply(rs, f"g (greedy, {name}, speculative={spec})",
                            prompt)
                ids[spec] = rs.generated_ids
                if spec:
                    out["speculation"][f"{name} {spec}"] = rs.spec_stats
                    log(f"  spec_stats {name} {spec}: {rs.spec_stats}")
            if kw and not out["speculation"][f"{name} True"]["passes"]:
                raise AssertionError("greedy speculation made no pass")
            if not ids[False] == ids["auto"] == ids[True]:
                raise AssertionError(f"speculation changed the ids ({name})")
        sampled = []
        for i in range(2):
            rs = runner(max_tokens=SPEC_TOKENS, speculative=True,
                        temperature=0.7, seed=SEED, spec_min_ngram=1)
            timed_reply(rs, f"h (sampled speculation, {i})", REPEAT_PROMPT)
            log(f"  spec_stats sampled True: {rs.spec_stats}")
            sampled.append(rs.generated_ids)
            if not rs.spec_stats["passes"]:
                raise AssertionError("sampled speculation made no pass")
        out["speculation"]["sampled True"] = rs.spec_stats
        if (sampled[0] != sampled[1]
                or set(verify_devices) != {dev.type}):
            raise AssertionError(f"seeded sampled speculation differs, or "
                                 f"verified on {set(verify_devices)}")
        rl = runner(max_tokens=16)
        prompt = long_prompt(rl)
        n_long = rl.count_tokens(prompt) + 1
        f32a_before = quant.q4_matmul_f32a.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rl.prepare_generation(prompt)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        f32a = quant.q4_matmul_f32a.launches - f32a_before
        while rl.generate_next_token() is not None:
            pass
        log(f"  request i (long prompt, {n_long} tokens, bucket 1024): "
            f"prefill_ms={prefill_ms:.2f} f32a_launches={f32a} "
            f"plain_path_calls={len(plain_calls)}")
        if f32a == 0 or plain_calls:
            raise AssertionError("bucket 1024 did not take the f32a kernel")
        out["long_prefill"] = {"tokens": n_long, "prefill_ms": prefill_ms,
                               "f32a_launches": f32a}
        out["verify"] = verify_pass(dev, llm, params, cfg, tok)
    finally:
        quant.quantized_matmul_ref = plain
        runner_mod.sampling.spec_verify_sampled = verify_sampled
        n_logits = watch.close()
    out["launches"] = {name: fn.launches for name, fn in counters.items()}
    log(f"  launches: {out['launches']}; finite logit vectors: {n_logits}")
    return out


def verify_pass(dev, llm, params, cfg, tok) -> dict:
    """(j) The verify pass alone: after the short prompt's prefill, the
    logits of ``extend(all_logits=True)`` on a 16-token chunk against 16
    ``decode_step``s from the same cache: the same argmax at every row,
    rel L2 within EXACT_WIDTH_TOL."""
    ids = tok.encode(SHORT_PROMPT, add_bos=True)
    padded = torch.zeros(64, dtype=torch.int64)
    padded[:len(ids)] = torch.tensor(ids)
    cache = llm.KVCache.create(cfg, device=dev)
    _, cache = llm.prefill(params, cfg, padded.to(dev), len(ids), cache)
    chunk = torch.randint(0, 256, (VERIFY_ROWS,),
                          generator=torch.Generator().manual_seed(SEED))
    attn = 256   # the runner's attention bucket for offset + 16
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ext, _ = llm.extend(params, cfg, chunk.to(dev), VERIFY_ROWS, cache,
                        attn_len=attn, all_logits=True)
    torch.cuda.synchronize()
    extend_ms = (time.perf_counter() - t0) * 1e3
    steps, c = [], cache._replace(length=len(ids))
    t0 = time.perf_counter()
    for t in chunk.tolist():
        lg, c = llm.decode_step(params, cfg, t, c, attn_len=attn)
        steps.append(lg)
    torch.cuda.synchronize()
    steps_ms = (time.perf_counter() - t0) * 1e3
    steps = torch.stack(steps)
    err = rel_l2(ext, steps)
    same = int((ext.argmax(-1) == steps.argmax(-1)).sum())
    log(f"  request j (verify pass, {VERIFY_ROWS} rows): rel_l2 extend vs "
        f"decode = {err:.3e} (tol {EXACT_WIDTH_TOL:.0e}); argmax equal on "
        f"{same}/{VERIFY_ROWS} rows; extend_ms={extend_ms:.2f} "
        f"decode_steps_ms={steps_ms:.2f}")
    if not (err < EXACT_WIDTH_TOL and same == VERIFY_ROWS):
        raise AssertionError(f"verify pass: rel L2 {err}, argmax {same}")
    return {"rel_l2": err, "argmax_equal": same, "extend_ms": extend_ms,
            "decode_steps_ms": steps_ms}


# Phase 12: serving. Eight slots; measure_server's configurations and a
# paged int8 pool; the cortex prompts through the prefix cache; a long
# prompt admitted in extend chunks of at most SERVE_JOB_CHUNK tokens while
# seven short requests decode; a forced tool call among cortex prompts.
SERVE_SLOTS = 8
SERVE_INT8 = ("paged_int8_chunk8", dict(chunk_steps=8, page_size=128,
                                        cache_dtype=torch.int8))
SERVE_PAGE = 128
SERVE_JOB_CHUNK = 128
SERVE_LONG = (350, 450)   # (c)'s prompt tokens
SERVE_RUNNER = 4   # pinned-burst requests also answered by LLMRunner
SERVE_ROUNDS = 2   # measure_server's configurations, each run this often
# Tokens of the profile's two bursts: 32 (about 67,000 device records)
# and 16. A burst of 48 (about 100,000 records) came back without some of
# its launches in every retry.
SERVE_PROFILE = (32, 16)
SERVE_TIMEOUT = 600.0
# The waves prefill_batch is held to against prefill alone: rows a wave.
WAVE_ROWS = (2, 4, 8)
QUESTIONS = ("What is in front of me right now?", "Is the path clear?",
             "Where is the door?", "What does the sign say?",
             "Is the bicycle moving?", "How far is the person?",
             "What is that sound?", "Can I walk ahead safely?")


class ServerWatch:
    """Two private points of an ``LLMServer`` wrapped. ``_finish`` records
    each finished request's token ids by prompt (``ids``); ``_admit``
    records how many slots each admission wave filled (``waves``) and,
    inside ``held()``, waits before it admits. A burst submitted inside
    ``held()`` is queued whole before the serve loop takes any of it, so
    its waves are the free slots filled in submit order, in every run."""

    def __init__(self, server):
        self.ids, self.waves = {}, []
        self._open, self._parked = threading.Event(), threading.Event()
        self._open.set()
        self._server = server
        finish, admit = server._finish, server._admit

        def watched_finish(slot):
            if slot.request is not None:
                self.ids[slot.request.prompt] = list(slot.generated)
            finish(slot)

        def watched_admit():
            if not self._open.is_set():
                self._parked.set()
                if not self._open.wait(timeout=SERVE_TIMEOUT):
                    raise RuntimeError("admission held too long")
            busy = self._active()
            admit()
            if self._active() > busy:
                self.waves.append(self._active() - busy)
        server._finish, server._admit = watched_finish, watched_admit

    def _active(self) -> int:
        return sum(slot.active for slot in self._server._slots)

    @contextlib.contextmanager
    def held(self):
        self._parked.clear()
        self._open.clear()
        try:
            if not self._parked.wait(timeout=SERVE_TIMEOUT):
                raise AssertionError("phase 12: the serve loop never reached "
                                     "its admission")
            yield
        finally:
            self._open.set()


def first_divergence(a, b):
    """The first position where two id lists differ, None if equal."""
    if a == b:
        return None
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def burst(server, jobs, watch=None) -> list:
    """Submit ``jobs`` ((prompt, submit kwargs)) at once, inside
    ``watch.held()`` when given; their texts."""
    with watch.held() if watch is not None else contextlib.nullcontext():
        futs = [server.submit(p, **kw) for p, kw in jobs]
    texts = [f.result(timeout=SERVE_TIMEOUT) for f in futs]
    if not all(isinstance(t, str) for t in texts):
        raise AssertionError("phase 12: a future did not resolve to text")
    return texts


def wave_rows(dev, llm, runner_mod, params, cfg, tok, prompts,
              lone: dict) -> dict:
    """The server's two prefill routes on the card for ``prompts`` (one
    bucket): ``prefill_batch`` of the whole wave, padded to a power of two
    as the server pads it, against ``prefill`` of each prompt alone (kept
    in ``lone`` by prompt). Returns the bucket, the wave's matmul rows,
    each row's rel L2 against its lone logits and how many argmax agree."""
    ids = [tok.encode(p, add_bos=True) for p in prompts]
    bucket = next(b for b in runner_mod.PREFILL_BUCKETS
                  if b >= max(map(len, ids)))
    b_pad = 1 << (len(ids) - 1).bit_length()
    padded = np.zeros((b_pad, bucket), np.int64)
    lengths = np.zeros(b_pad, np.int32)
    for row, i in enumerate(ids):
        padded[row, :len(i)] = i
        lengths[row] = len(i)
    wave, _ = llm.prefill_batch(params, cfg, torch.from_numpy(padded).to(dev),
                                torch.from_numpy(lengths).to(dev))
    errs, same = [], 0
    for row, (p, i) in enumerate(zip(prompts, ids)):
        if p not in lone:
            lone[p] = llm.prefill(
                params, cfg, torch.from_numpy(padded[row]).to(dev), len(i),
                llm.KVCache.create(cfg, device=dev))[0].reshape(-1)
        errs.append(rel_l2(wave[row], lone[p]))
        same += int(wave[row].argmax() == lone[p].argmax())
    return {"bucket": bucket, "m": b_pad * bucket, "rel_l2": errs,
            "argmax_equal": same}


def wave_checks(dev, llm, runner_mod, params, cfg, tok, short, cortex):
    """``prefill_batch`` against ``prefill`` on the card, in waves of 2, 4
    and 8 rows (WAVE_ROWS). At bucket 64 (``short``) both take W4A8, at
    different M: within WIDTH_TOL, as the activation quantization may round
    a value the other way where the sums' order moved it. At bucket 512
    (``cortex``) under TRACKIE_Q4_F32A=1 both take f32a (the wave above
    512 rows, as by default; the lone prompt at 512) and flash (the wave's
    rows folded into the heads): within EXACT_WIDTH_TOL, only the sums'
    order differs. Reported, not checked: the bucket-512 waves on the
    default routes, where the lone prompt takes W4A8."""
    out = {}
    for label, prompts, levers, tol in (
            ("w4a8", short, (), WIDTH_TOL),
            ("f32a", cortex, ("TRACKIE_Q4_F32A",), EXACT_WIDTH_TOL),
            ("default", cortex, (), None)):
        lone = {}
        with levers_on(levers):
            for n in WAVE_ROWS:
                res = wave_rows(dev, llm, runner_mod, params, cfg, tok,
                                prompts[:n], lone)
                worst = max(res["rel_l2"])
                log(f"  prefill_batch of {n} vs prefill ({label}, bucket "
                    f"{res['bucket']}, M={res['m']}): rel_l2 max {worst:.3e}"
                    f" (tol {tol}), argmax equal on {res['argmax_equal']}"
                    f"/{n}")
                if tol is not None and not worst < tol:
                    raise AssertionError(
                        f"phase 12: prefill_batch of {n} ({label}) against "
                        f"prefill: rel L2 {res['rel_l2']}")
                out[f"{label} {n}"] = res
    return out


def server_factory(server_mod, params, cfg, tok):
    """A maker of SERVE_SLOTS-slot servers of ``params``, each with its
    ``ServerWatch``."""
    def server(**kw):
        s = server_mod.LLMServer(params, cfg, batch_slots=SERVE_SLOTS,
                                 tokenizer=tok, **kw)
        return s, ServerWatch(s)
    return server


def close_server(s) -> None:
    s.close()
    if s._fatal is not None:
        raise AssertionError(f"phase 12: a serve loop died: {s._fatal!r}")


def phase_serve(dev, llm, runner_mod, tokenizer_mod, server_mod, paging,
                measure, params, cfg, counters, profile=None) -> dict:
    """Phase 12: continuous batching on phase 5's model (``cfg``), eight
    slots. (a) ``measure_server.run`` in its four configurations and a
    paged int8 pool at 8-step chunks, SERVE_ROUNDS times (the second
    round in reverse order), each reporting its admission waves; then on
    each server a pinned burst (``ServerWatch.held``) of the 16 requests:
    in each layout the chunked path must give all 16 the per-step path's
    ids and text. (b) Eight cortex prompts (the 297-token SYSTEM/CONTEXT
    prompt, eight questions) in one wave on a paged server with the prefix
    cache, then eight more: hits and reused tokens must count. (c) A
    ~400-token prompt admitted in extend chunks (``prefill_chunk``) while
    seven short requests decode: decode steps must run between its chunks.
    (d) A forced tool call among three cortex prompts (one wave of four at
    bucket 512: f32a at 2048 rows), which must parse and conform. Every
    future must resolve, no serve loop may die, and every logit must be
    finite. Counters are zeroed just before and read just after. Then a
    lone request's first token must equal ``LLMRunner``'s on the same
    prompt, and ``prefill_batch`` must agree with ``prefill`` on the card
    (``wave_checks``); reported: the share of requests whose ids equal the
    runner's and the other layout's, and a profile of 8-step chunks
    (``serve_profile``, or ``profile()`` when given)."""
    tok = tokenizer_mod.ByteTokenizer(cfg.vocab_size)
    runner = runner_mod.LLMRunner(
        params, cfg, tok, runner_mod.GenerationConfig(
            max_tokens=measure.MAX_TOKENS, temperature=0.0,
            speculative=False), device=dev)
    cortex = [runner.build_prompt(SYSTEM, CONTEXT, q) for q in QUESTIONS]

    server = server_factory(server_mod, params, cfg, tok)
    close = close_server
    for fn in counters.values():
        fn.launches = 0
    watch = LogitWatch(llm, paging)
    configs = [*measure.CONFIGS.items(), SERVE_INT8]
    out = {"configs": {label: [] for label, _ in configs}}
    ids = {}
    prompts = measure.prompts(SEED)
    pinned = [(p, dict(max_tokens=measure.MAX_TOKENS)) for p in prompts]
    try:
        for rnd in range(SERVE_ROUNDS):
            for label, kw in (configs if rnd == 0 else configs[::-1]):
                s, w = server(**kw)
                try:
                    res = measure.run(s, SEED)
                    res["waves"] = list(w.waves)
                    if rnd == 0:
                        n = len(w.waves)
                        texts = burst(s, pinned, w)
                        ids[label] = ([w.ids[p] for p in prompts], texts,
                                      w.waves[n:])
                finally:
                    close(s)
                del res["texts"]
                out["configs"][label].append(res)
                log(f"  serve {label} (round {rnd + 1}): aggregate_tok_s="
                    f"{res['aggregate_tok_s']:.2f} wall_s={res['wall_s']:.3f}"
                    f" decode_steps={res['decode_steps']} admission waves "
                    f"{res['waves']} (the warm burst's, then the timed "
                    "burst's)")
        out["chunk_vs_step"] = {}
        for one, chunked in (("per_step", "chunk8"),
                             ("paged_per_step", "paged_chunk8")):
            differ = {i: first_divergence(ids[chunked][0][i], ids[one][0][i])
                      for i in range(len(prompts))
                      if ids[chunked][0][i] != ids[one][0][i]
                      or ids[chunked][1][i] != ids[one][1][i]}
            out["chunk_vs_step"][chunked] = {
                "requests": len(prompts), "differ": len(differ),
                "waves": [ids[one][2], ids[chunked][2]]}
            log(f"  {chunked} against {one} (pinned burst of {len(prompts)},"
                f" waves {ids[chunked][2]} and {ids[one][2]}): ids and texts"
                f" {'identical' if not differ else f'differ: {differ}'}")
            if differ:
                raise AssertionError(f"phase 12: {chunked} against {one}: "
                                     f"{differ}")

        s, w = server(paged=True, page_size=SERVE_PAGE,
                      n_pages=SERVE_SLOTS * 4 + 1)
        try:
            t0 = time.perf_counter()
            burst(s, [(p, dict(max_tokens=16)) for p in cortex], w)
            cold = time.perf_counter() - t0
            t0 = time.perf_counter()
            burst(s, [(p + " Answer briefly.", dict(max_tokens=16))
                      for p in cortex], w)
            warm = time.perf_counter() - t0
            stats = dict(s.pool.prefix_stats)
        finally:
            close(s)
        n_cortex = runner.count_tokens(cortex[0]) + 1
        log(f"  prefix cache: {len(cortex)} cortex prompts "
            f"({n_cortex} tokens) in {cold * 1e3:.2f} ms, then "
            f"{len(cortex)} sharing their prefix in {warm * 1e3:.2f} ms; "
            f"{stats}; waves {w.waves}")
        if stats["hits"] < len(cortex) or not stats["tokens_reused"]:
            raise AssertionError(f"phase 12: prefix cache stats {stats}")
        out["prefix_cache"] = {"prompt_tokens": n_cortex,
                               "first_burst_ms": cold * 1e3,
                               "shared_burst_ms": warm * 1e3, **stats}

        reps = 1
        while True:
            long = runner.build_prompt(SYSTEM, " ".join([CONTEXT] * reps),
                                       "Describe everything around me.")
            n_long = runner.count_tokens(long) + 1
            if n_long >= SERVE_LONG[0]:
                break
            reps += 1
        if n_long > SERVE_LONG[1]:
            raise AssertionError(f"phase 12: long prompt is {n_long} tokens")
        s, _ = server(prefill_chunk=SERVE_JOB_CHUNK)
        steps_at_chunk = []
        advance = s._advance_prefill

        def watched_advance():
            steps_at_chunk.append(s.stats["decode_steps"])
            advance()
        s._advance_prefill = watched_advance
        try:
            shorts = [s.submit(f"{SHORT_PROMPT} {i}", max_tokens=128)
                      for i in range(SERVE_SLOTS - 1)]
            deadline = time.monotonic() + SERVE_TIMEOUT
            while not s.stats["decode_steps"] and time.monotonic() < deadline:
                time.sleep(0.001)
            t0 = time.perf_counter()
            s.submit(long, max_tokens=8).result(timeout=SERVE_TIMEOUT)
            long_ms = (time.perf_counter() - t0) * 1e3
            burst_texts = [f.result(timeout=SERVE_TIMEOUT) for f in shorts]
        finally:
            close(s)
        between = [b - a for a, b in zip(steps_at_chunk, steps_at_chunk[1:])]
        log(f"  chunked prefill: {n_long}-token prompt in "
            f"{len(steps_at_chunk)} chunks, {long_ms:.2f} ms to its reply; "
            f"decode steps between its chunks {between}")
        if len(steps_at_chunk) < 3 or not all(between) or not all(
                isinstance(t, str) for t in burst_texts):
            raise AssertionError(f"phase 12: chunked prefill did not "
                                 f"interleave: {steps_at_chunk}")
        out["chunked_prefill"] = {"prompt_tokens": n_long,
                                  "chunks": len(steps_at_chunk),
                                  "steps_between": between,
                                  "reply_ms": long_ms}

        tools = [runner_mod.ToolDefinition(*t) for t in TOOLS]
        schemas = {t.name: t.schema for t in tools}
        ask = runner.build_prompt(SYSTEM, CONTEXT, "Take me to the door.",
                                  tools)
        s, w = server()
        try:
            texts = burst(s, [(ask, dict(
                max_tokens=TOOL_TOKENS, tool_names=list(schemas),
                tool_schemas={k: v for k, v in schemas.items() if v}))]
                + [(p, dict(max_tokens=16)) for p in cortex[:3]], w)
        finally:
            close(s)
        call = json.loads(texts[0])["tool_call"]
        log(f"  served tool call (waves {w.waves}): {texts[0]!r}")
        if (call["name"] not in schemas
                or not conforms(call["arguments"], schemas[call["name"]])):
            raise AssertionError(f"phase 12: tool call {texts[0]!r} does "
                                 "not conform")
        out["tool_call"] = call

        s, w = server()
        try:
            s.generate(SHORT_PROMPT, max_tokens=4, timeout=SERVE_TIMEOUT)
        finally:
            close(s)
        served_first = w.ids[SHORT_PROMPT][0]
    finally:
        n_logits = watch.close()
    out["launches"] = {name: fn.launches for name, fn in counters.items()}
    log(f"  launches: {out['launches']}; finite logit tensors: {n_logits}")

    runner.prepare_generation(SHORT_PROMPT)
    want = int(torch.argmax(runner._next_logits))
    log(f"  lone request's first token {served_first}, LLMRunner's {want}")
    if served_first != want:
        raise AssertionError("phase 12: the served first token is not "
                             "the runner's")
    out["waves"] = wave_checks(dev, llm, runner_mod, params, cfg, tok,
                               prompts[:max(WAVE_ROWS)], cortex)
    agree = {}
    for i, prompt in enumerate(prompts[:SERVE_RUNNER]):
        runner.generate(prompt)
        for label in ("per_step", "paged_per_step"):
            agree.setdefault(label, []).append(
                first_divergence(runner.generated_ids, ids[label][0][i]))
    layouts = [first_divergence(a, b) for a, b in
               zip(ids["per_step"][0], ids["paged_per_step"][0])]
    out["agreement"] = {
        "runner_share": {k: v.count(None) / len(v) for k, v in agree.items()},
        "runner_first_divergence": agree,
        "dense_paged_share": layouts.count(None) / len(layouts),
        "dense_paged_first_divergence": layouts,
        "int8_share": sum(a == b for a, b in zip(
            ids["paged_int8_chunk8"][0], ids["paged_chunk8"][0]))
        / len(layouts)}
    log(f"  agreement (reported): {out['agreement']}")
    out["profile"] = (profile() if profile is not None
                      else serve_profile(server, measure, close, counters))
    expect_routes(out["launches"], ("q4_matmul_w4a8", "quantize_activations",
                                    "flash_attention", "q4_matmul_f32a"),
                  ("q8_matmul", "fused_mlp_q4", *DIAGNOSTIC), "phase 12")
    if (out["launches"]["quantize_activations"]
            != out["launches"]["q4_matmul_w4a8"]):
        raise AssertionError("phase 12: not one activation quantization per "
                             "W4A8 matmul")
    return out


def serve_profile(server, measure, close, counters) -> dict:
    """Bursts of eight requests of measure_server's prompts on a dense
    8-step-chunk server, each one admission wave at bucket 64
    (``ServerWatch.held``), after a warm burst: a burst of the longer of
    SERVE_PROFILE's token counts on the host clock, then under the
    profiler a burst of each. Their difference is decode steps alone: the
    launches and device busy ms a step; what the short burst holds beyond
    its steps is the admission wave's. The idle share is the long
    burst's. A profile must show every launch the wrappers (``counters``)
    counted in its window; one that misses some is taken again, up to
    PROFILE_RETRIES times. A window that never shows them all keeps its
    numbers beside a ``missed`` note of what the profiler did not see."""
    s, w = server(chunk_steps=8)
    asked = measure.prompts(SEED)[:SERVE_SLOTS]

    def one(tag, tokens):  # a short tag keeps the prompts in bucket 64
        return burst(s, [(f"{p} ({tag})", dict(max_tokens=tokens))
                         for p in asked], w)
    long, short = SERVE_PROFILE
    windows, notes = {}, {}
    try:
        one("warm", long)
        t0 = time.perf_counter()
        one("wall", long)
        wall = (time.perf_counter() - t0) * 1e3
        for tokens in SERVE_PROFILE:
            for attempt in range(1 + PROFILE_RETRIES):
                steps = s.stats["decode_steps"]
                before = {k: f.launches for k, f in counters.items()}
                busy, n, by_name = device_breakdown(
                    lambda: one(f"p{tokens}-{attempt}", tokens))
                notes[tokens] = missed_launches(by_name, {
                    k: f.launches - before[k] for k, f in counters.items()})
                windows[tokens] = (busy, n, s.stats["decode_steps"] - steps,
                                   by_name)
                if notes[tokens] is None:
                    break
    finally:
        close(s)
    busy, n, steps, by_name = windows[long]
    busy_s, n_s, steps_s, _ = windows[short]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    per_step = (n - n_s) / (steps - steps_s)
    missed = {t: note for t, note in notes.items() if note is not None}
    prof = {"wall_ms": wall, "busy_ms": busy, "idle_share": 1.0 - busy / wall,
            "decode_steps": steps, "launches": n,
            "short_decode_steps": steps_s, "short_launches": n_s,
            "short_busy_ms": busy_s, "launches_per_step": per_step,
            "busy_ms_per_step": (busy - busy_s) / (steps - steps_s),
            "admission_launches": n_s - per_step * steps_s,
            "waves": list(w.waves), "tokens": SERVE_SLOTS * long,
            "top": [[k[:80], t, c] for k, (t, c) in top],
            "missed": missed}
    log(f"  profile chunk8 burst: wall {wall:.2f} ms busy {busy:.2f} ms "
        f"(idle {prof['idle_share']:.3f}), {steps} decode steps; from the "
        f"{long}- and {short}-token bursts: "
        f"{per_step:.1f} launches and {prof['busy_ms_per_step']:.3f} busy "
        f"ms a decode step, {prof['admission_launches']:.1f} launches in "
        f"the admission wave; waves {w.waves}"
        + (f"; after {PROFILE_RETRIES} retries the profiler missed "
           f"{missed}" if missed else ""))
    return prof


SERVE_PROFILE_FLAG = "--serve-profile"


def serve_profile_child() -> dict:
    """Phase 12's profile in a process of its own (this script with
    SERVE_PROFILE_FLAG): late in the smoke's process, after the earlier
    phases' profiles, ``torch.profiler`` left out some kernel records of
    every serving window. The child's log lines are passed on; its last
    line is ``serve_profile``'s result."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), SERVE_PROFILE_FLAG],
        capture_output=True, text=True, timeout=SERVE_TIMEOUT)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"phase 12: the profile's process exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    for line in lines[:-1]:
        log(line)
    return json.loads(lines[-1])


def serve_profile_main(dev) -> int:
    """The child of ``serve_profile_child``: phase 5's model from the
    seed behind a dense 8-step-chunk server, ``serve_profile`` on it."""
    from trackiellm_tpu_torch.llm import server as server_mod
    from trackiellm_tpu_torch.llm import tokenizer as tokenizer_mod
    from trackiellm_tpu_torch.models import llm
    from trackiellm_tpu_torch.ops import _build
    from trackiellm_tpu_torch.tools import measure_server
    _build.library()
    cfg = serve_config(llm)
    params = build_model(dev, llm, cfg, 4)
    tok = tokenizer_mod.ByteTokenizer(cfg.vocab_size)
    prof = serve_profile(server_factory(server_mod, params, cfg, tok),
                         measure_server, close_server, launch_counters())
    print(json.dumps(prof), flush=True)
    return 0


# Phase 13: the voice path. Whisper-tiny at its published widths from a
# whisper.cpp GGML file this script writes, Whisper large-v3's widths cut to
# 2+2 layers, Silero VAD and a Piper voice from ONNX files under the
# published names of the port's name maps, and the app's TTS; the card
# against the port's own CPU run where a tolerance is named.
VOICE_SECONDS = 5            # the transcribed signal
VOICE_RATE = 48_000          # given at the microphone's rate: resample_poly
VOICE_WINDOWS = (1500, 500)  # n_audio_ctx: 30 s, and the app's 10 s
VOICE_TOKENS = 96            # max_tokens of every transcription
VOICE_FORCED = 8             # teacher-forced decode steps of the logit check
VOICE_LOGIT_TOL = 1e-4       # rel L2, card against CPU
LARGE_V3_LAYERS = 2          # encoder and decoder layers of (b)
SILERO_SECONDS = 10          # 312 chunks of 512 samples
SILERO_TOL = 1e-5            # max abs, probabilities
TTS_REPLY = "Há uma pessoa a dois metros à frente e a porta fica ao lado."
TTS_STREAM_TOL = 1e-6        # max abs, streamed chunks against one-shot
VITS_TEXT = "ola, a porta fica a esquerda e a mesa a frente."
VITS_TOL = 1e-4              # rel L2, card against CPU, injected noise
VOICE_PROFILE_TOKENS = 32    # decode steps of the profiled window
VOICE_PROFILE_ENCODES = 5    # encoder calls of the profiled window
VOICE_PROFILE_FLAG = "--voice-profile"
# whisper.cpp's converter keeps these f32 in an f16 file.
GGML_F32_NAMES = ("encoder.conv1.bias", "encoder.conv2.bias",
                  "encoder.positional_embedding",
                  "decoder.positional_embedding")
NAME_MAPS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "trackiellm_tpu_torch", "models", "name_maps")


def voice_signal(seconds: float, rate: int, seed: int) -> np.ndarray:
    """Speech-like audio from the seed: a gliding voiced tone with five
    harmonics under a 4 Hz syllable envelope, and noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    f0 = 140.0 + 40.0 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / rate
    voiced = sum(np.sin(k * phase) / k for k in range(1, 6))
    env = 0.5 * (1.0 + np.sin(2 * np.pi * 4.0 * t))
    return (0.2 * env * voiced
            + 0.01 * rng.standard_normal(t.size)).astype(np.float32)


def whisper_state(cfg, seed: int) -> dict:
    """Random weights at ``cfg``'s widths in openai-whisper's state-dict
    layout, the names a whisper.cpp GGML file keeps."""
    rng = np.random.default_rng(seed)
    d = cfg.d_model

    def lin(cout, cin):
        return rng.uniform(-1, 1, (cout, cin)).astype(np.float32) / np.float32(
            math.sqrt(cin))

    def normal(shape, s):
        return (s * rng.standard_normal(shape)).astype(np.float32)

    st = {"encoder.conv1.weight": normal((d, cfg.n_mels, 3), 0.02),
          "encoder.conv1.bias": normal(d, 0.01),
          "encoder.conv2.weight": normal((d, d, 3), 0.02),
          "encoder.conv2.bias": normal(d, 0.01),
          "encoder.positional_embedding": np.zeros((cfg.n_audio_ctx, d),
                                                   np.float32)}

    def block(prefix, parts):
        for part in parts:
            st[f"{prefix}.{part}_ln.weight"] = np.ones(d, np.float32)
            st[f"{prefix}.{part}_ln.bias"] = np.zeros(d, np.float32)
            for w in ("query", "key", "value", "out"):
                st[f"{prefix}.{part}.{w}.weight"] = lin(d, d)
                if w != "key":
                    st[f"{prefix}.{part}.{w}.bias"] = normal(d, 0.01)
        st[f"{prefix}.mlp_ln.weight"] = np.ones(d, np.float32)
        st[f"{prefix}.mlp_ln.bias"] = np.zeros(d, np.float32)
        st[f"{prefix}.mlp.0.weight"] = lin(4 * d, d)
        st[f"{prefix}.mlp.0.bias"] = normal(4 * d, 0.01)
        st[f"{prefix}.mlp.2.weight"] = lin(d, 4 * d)
        st[f"{prefix}.mlp.2.bias"] = normal(d, 0.01)
    for i in range(cfg.n_audio_layers):
        block(f"encoder.blocks.{i}", ("attn",))
    st["encoder.ln_post.weight"] = np.ones(d, np.float32)
    st["encoder.ln_post.bias"] = np.zeros(d, np.float32)
    # Byte tokens' rows are the longest, so greedy ids often fall on them
    # and a byte tokenizer's transcript is not empty.
    st["decoder.token_embedding.weight"] = normal((cfg.vocab_size, d), 0.02)
    st["decoder.token_embedding.weight"][:256] *= 4.0
    st["decoder.positional_embedding"] = normal((cfg.n_text_ctx, d), 0.01)
    for i in range(cfg.n_text_layers):
        block(f"decoder.blocks.{i}", ("attn", "cross_attn"))
    st["decoder.ln.weight"] = np.ones(d, np.float32)
    st["decoder.ln.bias"] = np.zeros(d, np.float32)
    return st


def write_ggml_whisper(path: str, state: dict, cfg, filters,
                       vocab) -> int:
    """A whisper.cpp GGML file as its convert-pt-to-ggml.py writes one:
    hparams, mel filters, byte vocab, then each tensor squeezed (conv
    biases (n, 1)), dims reversed, f16 for matrices but the converter's f32
    names. Returns its size in bytes."""
    hp = (cfg.vocab_size, cfg.n_audio_ctx, cfg.d_model, cfg.n_heads,
          cfg.n_audio_layers, cfg.n_text_ctx, cfg.d_model, cfg.n_heads,
          cfg.n_text_layers, cfg.n_mels, 1)
    with open(path, "wb") as f:
        f.write(struct.pack("<i", 0x67676D6C))
        f.write(struct.pack("<11i", *hp))
        f.write(struct.pack("<2i", *filters.shape))
        f.write(np.asarray(filters, "<f4").tobytes())
        f.write(struct.pack("<i", len(vocab)))
        for tok in vocab:
            f.write(struct.pack("<i", len(tok)) + tok)
        for name, arr in state.items():
            data = np.asarray(arr, np.float32).squeeze()
            if name in GGML_F32_NAMES[:2]:
                data = data.reshape(data.shape[0], 1)
            if data.ndim < 2 or name in GGML_F32_NAMES:
                ftype, payload = 0, data.astype("<f4").tobytes()
            else:
                ftype, payload = 1, data.astype("<f2").tobytes()
            nm = name.encode()
            f.write(struct.pack("<3i", data.ndim, len(nm), ftype))
            for i in range(data.ndim):
                f.write(struct.pack("<i", data.shape[data.ndim - 1 - i]))
            f.write(nm + payload)
        return f.tell()


def whisper_vocab(n: int):
    """A byte-level vocabulary of ``n`` entries: the 256 bytes, then
    word pieces."""
    return [bytes([i]) for i in range(256)] + [
        f" w{i}".encode() for i in range(256, n)]


def wall_ms(fn):
    """(result, host ms) of ``fn`` between two card synchronizations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def agreement(a, b) -> dict:
    """How far two id lists agree: equal positions and the first
    divergence."""
    first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
    return {"equal": sum(x == y for x, y in zip(a, b)), "first_diff": first,
            "card": len(a), "cpu": len(b)}


def forced_logits(whisper, params, cfg, mel, ids, n_steps: int):
    """The logits of the first ``n_steps`` decode steps after the prompt,
    each step fed ``ids`` (teacher forcing), as one (n_steps, V) tensor."""
    feats = whisper.encode(params, cfg, mel)
    cache = whisper.make_decoder_cache(params, cfg, feats)
    for t in whisper._prompt(cfg, 0):
        logits, cache = whisper.decode_step(params, cfg, t, cache)
    out = [logits]
    for t in ids[:n_steps - 1]:
        logits, cache = whisper.decode_step(params, cfg, t, cache)
        out.append(logits)
    return torch.stack(out)


def decode_window(whisper, params, cfg, mel, steps: int):
    """A function that decodes ``steps`` greedy tokens from the prompt's
    cache (set up outside it) as ``transcribe_tokens`` does: one argmax
    fetch a token."""
    feats = whisper.encode(params, cfg, mel)

    def setup():
        cache = whisper.make_decoder_cache(params, cfg, feats)
        for t in whisper._prompt(cfg, 0):
            logits, cache = whisper.decode_step(params, cfg, t, cache)
        return logits, cache

    def run(state):
        logits, cache = state
        for _ in range(steps):
            tok = int(torch.argmax(logits))
            logits, cache = whisper.decode_step(params, cfg, tok, cache)
        return logits
    return setup, run


def whisper_window(whisper, asr_mod, params, cpu_params, cfg, tok,
                   signal) -> dict:
    """(a) at one window: transcription ids on the card and the CPU, the
    teacher-forced logits, encode and decode times, RTF."""
    asr = asr_mod.WhisperASR(params, cfg, tok, max_tokens=VOICE_TOKENS)
    cpu = asr_mod.WhisperASR(cpu_params, cfg, tok, max_tokens=VOICE_TOKENS)
    asr.transcribe_ids(signal, VOICE_RATE)  # warm
    ids, wall = wall_ms(lambda: asr.transcribe_ids(signal, VOICE_RATE))
    ref = cpu.transcribe_ids(signal, VOICE_RATE)
    mel = asr.mel(signal, VOICE_RATE)
    steps = min(VOICE_FORCED, len(ref) + 1)
    lg = forced_logits(whisper, params, cfg, mel, ref, steps)
    lc = forced_logits(whisper, cpu_params, cfg, cpu.mel(signal, VOICE_RATE),
                       ref, steps)
    if not torch.isfinite(lg).all():
        raise AssertionError(f"phase 13: whisper-tiny n_audio_ctx "
                             f"{cfg.n_audio_ctx}: non-finite logits")
    errs = [rel_l2(lg[i].cpu(), lc[i]) for i in range(steps)]
    encode = time_ms(lambda: whisper.encode(params, cfg, mel), iters=5,
                     warmup=1)
    setup, run = decode_window(whisper, params, cfg, mel, len(ids))
    state = setup()
    _, dec_wall = wall_ms(lambda: run(state))
    out = {"ids": agreement(ids, ref), "logits_rel_l2": max(errs),
           "logits_rel_l2_by_step": errs, "tol": VOICE_LOGIT_TOL,
           "encode_ms": encode,
           "decode_ms_per_token": dec_wall / max(len(ids), 1),
           "transcribe_ms": wall, "rtf": wall / 1e3 / VOICE_SECONDS}
    log(f"  whisper-tiny n_audio_ctx {cfg.n_audio_ctx}: {len(ids)} ids on "
        f"the card, {len(ref)} on the CPU, {out['ids']['equal']} equal "
        f"(first difference at {out['ids']['first_diff']}); teacher-forced "
        f"logits over {steps} steps: rel_l2 {max(errs):.3e} (tol "
        f"{VOICE_LOGIT_TOL:.0e}); encode {encode:.3f} ms, decode "
        f"{out['decode_ms_per_token']:.3f} ms a token, transcribe "
        f"{wall:.1f} ms, RTF {out['rtf']:.4f}")
    if max(errs) > VOICE_LOGIT_TOL:
        raise AssertionError(f"phase 13: whisper-tiny n_audio_ctx "
                             f"{cfg.n_audio_ctx}: logits rel_l2 {max(errs)}")
    return out


def voice_configs() -> dict:
    """Phase 13's configurations: Whisper-tiny, large-v3's widths cut to
    LARGE_V3_LAYERS + LARGE_V3_LAYERS, the app's TTS and the widths
    (d_model, n_layers, up_init_ch, upsample_rates, sample_rate) the Piper
    voice must come out with."""
    from trackiellm_tpu_torch.models import tts, whisper
    return {"tiny": whisper.WhisperConfig.tiny(),
            "large": whisper.WhisperConfig.large_v3()._replace(
                n_audio_layers=LARGE_V3_LAYERS,
                n_text_layers=LARGE_V3_LAYERS),
            "tts": tts.TTSConfig.default(),
            "vits": (192, 6, 512, (8, 8, 2, 2), 22050)}


def phase_whisper(dev, cli, tmp: str, sizes: dict) -> dict:
    """(a) Whisper-tiny from a GGML file at both windows and through the
    ``transcribe`` CLI; (b) large-v3's widths cut to 2+2 layers."""
    import wave

    from trackiellm_tpu_torch.audio import asr as asr_mod
    from trackiellm_tpu_torch.llm.tokenizer import ByteTokenizer
    from trackiellm_tpu_torch.models import checkpoint, convert, whisper
    from trackiellm_tpu_torch.ops.mel import mel_filterbank
    cfg = sizes["tiny"]
    path = os.path.join(tmp, "ggml-tiny.bin")
    t0 = time.perf_counter()
    size = write_ggml_whisper(path, whisper_state(cfg, SEED), cfg,
                              mel_filterbank(cfg.n_mels).T,
                              whisper_vocab(min(cfg.vocab_size, 50257)))
    params, got, ggml_tok, _ = convert.whisper_from_ggml(path, device=dev)
    cpu_params, _, _, _ = convert.whisper_from_ggml(path, device="cpu")
    if got != cfg or params["tok_emb"].device.type != dev.type:
        raise AssertionError(f"phase 13: whisper_from_ggml gave {got} on "
                             f"{params['tok_emb'].device}")
    log(f"  whisper-tiny GGML: {size} bytes written and loaded on the card "
        f"and the CPU in {time.perf_counter() - t0:.1f} s")
    signal = voice_signal(VOICE_SECONDS, VOICE_RATE, SEED)
    out = {"ggml_bytes": size, "windows": {}}
    for ctx in VOICE_WINDOWS:
        out["windows"][str(ctx)] = whisper_window(
            whisper, asr_mod, params, cpu_params,
            cfg._replace(n_audio_ctx=min(ctx, cfg.n_audio_ctx)), ggml_tok,
            signal)

    # The transcribe CLI on a checkpoint and a WAV written here (the app's
    # 10-s window, the byte tokenizer, as the JAX command reads it).
    app = cfg._replace(n_audio_ctx=min(VOICE_WINDOWS[-1], cfg.n_audio_ctx))
    ckpt = os.path.join(tmp, "whisper-ckpt")
    checkpoint.save_checkpoint(ckpt, cpu_params, metadata={
        "whisper_config": dict(app._asdict())})
    wav = os.path.join(tmp, "speech.wav")
    pcm = (np.clip(signal, -1, 1) * 32767).astype(np.int16)
    with wave.open(wav, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(VOICE_RATE)
        f.writeframes(pcm.tobytes())
    rc, text, secs = run_cli(cli, ["transcribe", wav, "--checkpoint", ckpt])
    ref = asr_mod.WhisperASR(params, app, ByteTokenizer(app.vocab_size)
                             ).transcribe(pcm.astype(np.float32) / 32768.0,
                                          VOICE_RATE)
    if rc != 0 or text.strip() != ref:
        raise AssertionError(f"phase 13: transcribe exited {rc} and printed "
                             f"{text[-200:]!r}, not {ref[-200:]!r}")
    out["cli"] = {"rc": rc, "seconds": secs, "chars": len(text.strip())}
    log(f"  transcribe CLI (checkpoint, 48 kHz WAV): exit {rc} in "
        f"{secs:.1f} s, the engine's text ({len(ref)} chars)")
    del params, cpu_params

    # (b) large-v3's widths cut to LARGE_V3_LAYERS + LARGE_V3_LAYERS.
    lcfg = sizes["large"]
    lparams = whisper.init_whisper(
        torch.Generator(device=dev).manual_seed(SEED), lcfg)
    asr = asr_mod.WhisperASR(lparams, lcfg, max_tokens=VOICE_TOKENS)
    ids, wall = wall_ms(lambda: asr.transcribe_ids(signal, VOICE_RATE))
    mel = asr.mel(signal, VOICE_RATE)
    feats = whisper.encode(lparams, lcfg, mel)
    if (mel.shape != (128, 2 * lcfg.n_audio_ctx)
            or not torch.isfinite(feats).all()
            or not all(0 <= i < lcfg.vocab_size for i in ids)):
        raise AssertionError(f"phase 13: large-v3 widths: mel {mel.shape}, "
                             f"ids {ids[:8]}")
    encode = time_ms(lambda: whisper.encode(lparams, lcfg, mel), iters=3,
                     warmup=1)
    out["large_v3"] = {"layers": LARGE_V3_LAYERS, "ids": len(ids),
                       "transcribe_ms": wall, "encode_ms": encode,
                       "rtf": wall / 1e3 / VOICE_SECONDS,
                       "cut": f"32+32 layers to {LARGE_V3_LAYERS}+"
                              f"{LARGE_V3_LAYERS}"}
    log(f"  whisper large-v3 widths ({LARGE_V3_LAYERS}+{LARGE_V3_LAYERS} "
        f"layers, 128 mels, d 1280, 20 heads, vocab 51866): {len(ids)} ids "
        f"in {wall:.1f} ms (first call), encode {encode:.3f} ms")
    return out


def map_shapes(name: str) -> dict:
    """The published shapes a bundled name map records (``_shape:``)."""
    with open(os.path.join(NAME_MAPS, f"{name}.json"),
              encoding="utf-8") as f:
        data = json.load(f)
    return {k[len("_shape:"):]: tuple(v) for k, v in data.items()
            if k.startswith("_shape:")}


def silero_state(seed: int) -> dict:
    """Random Silero v5 initializers under the ``silero_v5`` map's
    published names, at its shapes; the STFT basis is the real windowed
    DFT."""
    from trackiellm_tpu_torch.models.convert import load_name_map
    from trackiellm_tpu_torch.models.vad import _dft_power_bases
    rng = np.random.default_rng(seed)
    published = {v: k for k, v in load_name_map("silero_v5").items()}
    st = {}
    for name, shape in map_shapes("silero_v5").items():
        if name.endswith("forward_basis_buffer"):
            cos_b, sin_b = _dft_power_bases(shape[2])
            a = np.concatenate([cos_b.T, sin_b.T])[:, None, :]
        elif name.endswith("bias") or len(shape) == 1:
            a = 0.01 * rng.standard_normal(shape)
        else:
            a = rng.uniform(-1, 1, shape) / math.sqrt(np.prod(shape[1:]))
        st[published.get(name, name)] = a.astype(np.float32)
    return st


def phase_silero(dev, tmp: str) -> dict:
    """(c) Silero from an ONNX file, 10 s of audio chunk by chunk with the
    state carried, the card against the CPU."""
    from trackiellm_tpu_torch.models import convert, vad
    from trackiellm_tpu_torch.models.onnx_reader import (
        read_onnx_initializers, write_onnx_initializers)
    path = os.path.join(tmp, "silero_vad.onnx")
    write_onnx_initializers(path, silero_state(SEED))
    state = convert.apply_name_map(read_onnx_initializers(path),
                                   convert.load_name_map("silero_v5"))
    params, cfg = convert.silero_from_onnx(state, device=dev)
    cpu, _ = convert.silero_from_onnx(state, device="cpu")
    if cfg != vad.SileroConfig():
        raise AssertionError(f"phase 13: silero_from_onnx gave {cfg}")
    audio = voice_signal(SILERO_SECONDS, 16_000, SEED + 1)
    n = len(audio) // vad.CHUNK_SAMPLES
    chunks = torch.from_numpy(audio[:n * vad.CHUNK_SAMPLES]).reshape(n, -1)

    def run(p, device):
        state = vad.silero_init_state(cfg, device)
        probs = []
        x = chunks.to(device)
        for i in range(n):
            prob, state = vad.silero_step(p, cfg, x[i], state)
            probs.append(prob)
        return torch.stack(probs)
    got, _ = wall_ms(lambda: run(params, dev))
    ref = run(cpu, torch.device("cpu"))
    err = (got.cpu() - ref).abs().max().item()
    wrapper = vad.SileroVAD(params, cfg)
    _, wall = wall_ms(lambda: [wrapper(audio[i:i + 1600])
                               for i in range(0, len(audio), 1600)])
    out = {"chunks": n, "max_abs_err": err, "tol": SILERO_TOL,
           "ms_per_chunk": wall / n, "speech_share": float(
               (got > 0.5).float().mean())}
    log(f"  silero (ONNX, silero_v5 names): {n} chunks, probabilities card "
        f"vs cpu max abs {err:.3e} (tol {SILERO_TOL:.0e}); "
        f"{out['ms_per_chunk']:.3f} ms a 32-ms chunk through SileroVAD")
    if not (torch.isfinite(got).all() and err <= SILERO_TOL):
        raise AssertionError(f"phase 13: silero max abs {err}")
    return out


def phase_tts(dev, llm, cfg) -> dict:
    """(d) The app's TTS at TTSConfig.default(): a 60-character reply
    through TTSEngine.stream and synthesize; the joined chunks against the
    one-shot waveform, the card against the CPU."""
    from trackiellm_tpu_torch.audio.tts_engine import TTSEngine
    from trackiellm_tpu_torch.models import tts
    params = tts.init_tts(torch.Generator(device=dev).manual_seed(SEED), cfg)
    engine = TTSEngine(params, cfg)
    cpu = TTSEngine(llm.params_to(params, torch.device("cpu")), cfg)
    for _ in engine.stream(TTS_REPLY):  # warm
        pass
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunks, first = [], None
    for c in engine.stream(TTS_REPLY):
        first = first or (time.perf_counter() - t0) * 1e3
        chunks.append(c)
    total = (time.perf_counter() - t0) * 1e3
    one, one_ms = wall_ms(lambda: engine.synthesize(TTS_REPLY))
    ref = cpu.synthesize(TTS_REPLY)
    joined = np.concatenate(chunks)
    same = len(joined) == len(one) and np.array_equal(joined, one)
    diff = (float(np.abs(joined - one).max())
            if len(joined) == len(one) else float("inf"))
    frames_card, frames_cpu = len(one) // cfg.hop, len(ref) // cfg.hop
    out = {"chars": len(TTS_REPLY), "chunks": len(chunks),
           "samples": len(one), "first_chunk_ms": first,
           "stream_ms": total, "synthesize_ms": one_ms,
           "streamed_bit_identical": same, "streamed_max_abs": diff,
           "tol": TTS_STREAM_TOL, "frames_card": frames_card,
           "frames_cpu": frames_cpu,
           "rel_l2_vs_cpu": (rel_l2(torch.from_numpy(one),
                                    torch.from_numpy(ref))
                             if len(one) == len(ref) else None)}
    log(f"  TTS default ({len(TTS_REPLY)} chars): {len(chunks)} chunks, "
        f"first at {first:.2f} ms, all {total:.2f} ms (one-shot "
        f"{one_ms:.2f} ms); streamed "
        + ("bit-identical to" if same else f"max abs {diff:.3e} from")
        + f" the one-shot waveform; frames card {frames_card} cpu "
        f"{frames_cpu}" + ("" if frames_card == frames_cpu else
                           " (a duration boundary flipped)")
        + (f", rel_l2 vs cpu {out['rel_l2_vs_cpu']:.3e}"
           if out["rel_l2_vs_cpu"] is not None else ""))
    if not (np.isfinite(one).all() and diff <= TTS_STREAM_TOL):
        raise AssertionError(f"phase 13: streamed TTS max abs {diff}")
    return out


def piper_state(seed: int) -> dict:
    """Random VITS weights at VITSConfig()'s widths under the
    ``piper_vits`` map's published names and shapes: weight-normed convs
    as (g, v) with g = |v|, norms at one, the duration flows' projections
    small."""
    rng = np.random.default_rng(seed)
    shapes = map_shapes("piper_vits")
    st = {}
    for name, shape in shapes.items():
        fan_in = float(np.prod(shape[1:])) if len(shape) > 1 else 1.0
        if name.endswith("weight_g"):
            continue
        if name.endswith("gamma"):
            a = 1.0 + 0.01 * rng.standard_normal(shape)
        elif name.endswith(("beta", "bias")):
            a = 0.01 * rng.standard_normal(shape)
        elif name.endswith(("emb_rel_k", "emb_rel_v")):
            a = rng.standard_normal(shape) / math.sqrt(shape[-1])
        elif name == "enc_p.emb.weight":
            a = rng.standard_normal(shape) / math.sqrt(shape[1])
        elif name.endswith((".m", ".logs")):
            a = 0.1 * rng.standard_normal(shape)
        elif ".flows." in name and name.endswith(("post.weight",
                                                  "proj.weight")):
            a = 0.02 * rng.standard_normal(shape)
        else:
            a = rng.standard_normal(shape) / math.sqrt(fan_in)
        st[name] = a.astype(np.float32)
    for name, shape in shapes.items():
        if name.endswith("weight_g"):
            v = st[name[:-1] + "v"]
            st[name] = np.sqrt((v.reshape(v.shape[0], -1) ** 2).sum(-1)
                               ).reshape(shape).astype(np.float32)
    return st


def phase_vits(dev, cli, tmp: str, widths) -> dict:
    """(e) A Piper voice at VITSConfig()'s widths from an ONNX file and its
    JSON: from_piper on the card and the CPU, the waveform from injected
    noise compared, RTF, and the ``synth`` CLI."""
    import wave

    from trackiellm_tpu_torch.models import vits
    from trackiellm_tpu_torch.models.onnx_reader import (
        write_onnx_initializers)
    onnx = os.path.join(tmp, "pt_BR-voice.onnx")
    write_onnx_initializers(onnx, piper_state(SEED))
    letters = "abcdefghijklmnopqrstuvwxyz"
    conf = {"audio": {"sample_rate": widths[-1]},
            "phoneme_id_map": {"_": [0], "^": [1], "$": [2], " ": [3],
                               ",": [4], ".": [5],
                               **{c: [10 + i] for i, c in
                                  enumerate(letters)}}}
    conf_path = onnx + ".json"
    with open(conf_path, "w", encoding="utf-8") as f:
        json.dump(conf, f)
    voice = vits.VITSVoice.from_piper(onnx, conf_path, device=dev)
    cpu = vits.VITSVoice.from_piper(onnx, conf_path, device="cpu")
    cfg = voice.cfg
    if (cfg.d_model, cfg.n_layers, cfg.up_init_ch, cfg.upsample_rates,
            cfg.sample_rate) != widths:
        raise AssertionError(f"phase 13: the Piper voice's config {cfg}")
    ph, n = voice.phonemes(VITS_TEXT)
    g = torch.Generator().manual_seed(SEED)
    nw = torch.randn((2, cfg.max_phonemes), generator=g)
    nz = torch.randn((cfg.d_model, cfg.max_frames), generator=g)
    wg, fg = vits.vits_infer(voice.params, cfg, ph, n, nw.to(dev),
                             nz.to(dev))
    wc, fc = vits.vits_infer(cpu.params, cfg, ph.cpu(), n, nw, nz)
    frames_card, frames_cpu = int(fg), int(fc)
    err = (rel_l2(wg.cpu(), wc) if frames_card == frames_cpu
           else float("inf"))
    voice.synthesize(VITS_TEXT)  # warm
    wav, ms = wall_ms(lambda: voice.synthesize(VITS_TEXT))
    seconds = len(wav) / cfg.sample_rate
    out_wav = os.path.join(tmp, "synth.wav")
    rc, text, secs = run_cli(cli, ["synth", "-t", VITS_TEXT, "--voice", onnx,
                                   "--voice-config", conf_path,
                                   "-o", out_wav])
    with wave.open(out_wav, "rb") as f:
        cli_rate, cli_frames = f.getframerate(), f.getnframes()
    out = {"phonemes": n, "frames_card": frames_card,
           "frames_cpu": frames_cpu, "rel_l2_vs_cpu": err, "tol": VITS_TOL,
           "synthesize_ms": ms, "audio_s": seconds,
           "rtf": ms / 1e3 / seconds if seconds else None,
           "cli": {"rc": rc, "seconds": secs, "samples": cli_frames}}
    log(f"  VITS (Piper ONNX at VITSConfig() widths, {n} phonemes): frames "
        f"card {frames_card} cpu {frames_cpu}, injected-noise waveform "
        f"rel_l2 {err:.3e} (tol {VITS_TOL:.0e}); synthesize {ms:.1f} ms "
        f"for {seconds:.2f} s of audio (RTF "
        f"{out['rtf'] if out['rtf'] is not None else float('nan'):.4f}); "
        f"synth CLI exit {rc}, {cli_frames} samples at {cli_rate} Hz in "
        f"{secs:.1f} s")
    if frames_card != frames_cpu:
        raise AssertionError(f"phase 13: VITS frames card {frames_card} cpu "
                             f"{frames_cpu}: a duration boundary flipped")
    if not (torch.isfinite(wg).all() and err <= VITS_TOL):
        raise AssertionError(f"phase 13: VITS rel_l2 {err}")
    if (rc != 0 or cli_rate != cfg.sample_rate or cli_frames == 0
            or cli_frames % cfg.hop):
        raise AssertionError(f"phase 13: synth exited {rc}: {text[-300:]}")
    return out


def phase_voice(dev, llm, cli, counters, profile) -> dict:
    """Phase 13: the voice path (module comment above). None of the port's
    hand-written kernels is on it: every counter must stay at 0."""
    t0 = time.perf_counter()
    for f in counters.values():
        f.launches = 0
    sizes = voice_configs()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_voice_") as tmp:
        out = {"whisper_tiny": phase_whisper(dev, cli, tmp, sizes),
               "silero": phase_silero(dev, tmp),
               "tts": phase_tts(dev, llm, sizes["tts"]),
               "vits": phase_vits(dev, cli, tmp, sizes["vits"])}
    launches = {k: f.launches for k, f in counters.items()}
    expect_routes(launches, (), tuple(launches), "phase 13")
    out["whisper_tiny"]["profile"] = profile()
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 13 took {out['seconds']:.1f} s")
    return out


def voice_profile(dev) -> dict:
    """Whisper-tiny (random weights from the seed) at each window under the
    profiler: the decode window, VOICE_PROFILE_TOKENS greedy steps from the
    prompt's cache, and the encoder, VOICE_PROFILE_ENCODES calls; each on
    the host clock, then profiled: busy ms and launches a token (a call),
    the idle share 1 - busy / wall, the largest kernels."""
    from trackiellm_tpu_torch.audio import asr as asr_mod
    from trackiellm_tpu_torch.models import whisper
    cfg = whisper.WhisperConfig.tiny()
    params = whisper.init_whisper(
        torch.Generator(device=dev).manual_seed(SEED), cfg)
    signal = voice_signal(VOICE_SECONDS, VOICE_RATE, SEED)
    out = {}
    for ctx in VOICE_WINDOWS:
        c = cfg._replace(n_audio_ctx=ctx)
        asr = asr_mod.WhisperASR(params, c, max_tokens=VOICE_PROFILE_TOKENS)
        asr.transcribe_ids(signal, VOICE_RATE)  # warm
        setup, run = decode_window(whisper, params, c,
                                   asr.mel(signal, VOICE_RATE),
                                   VOICE_PROFILE_TOKENS)
        state = setup()
        _, wall = wall_ms(lambda: run(state))
        state = setup()
        busy, n, by_name = device_breakdown(lambda: run(state))
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
        per = VOICE_PROFILE_TOKENS
        out[str(ctx)] = {"wall_ms_per_token": wall / per,
                         "busy_ms_per_token": busy / per,
                         "launches_per_token": n / per,
                         "idle_share": 1.0 - busy / wall,
                         "top": [[k[:60], t / per, m / per]
                                 for k, (t, m) in top]}
        log(f"  profile whisper-tiny decode (n_audio_ctx {ctx}): "
            f"{wall / per:.3f} ms wall, {busy / per:.3f} ms busy, "
            f"{n / per:.1f} launches a token (idle "
            f"{out[str(ctx)]['idle_share']:.3f})")
        mel = asr.mel(signal, VOICE_RATE)

        def encodes():
            for _ in range(VOICE_PROFILE_ENCODES):
                whisper.encode(params, c, mel)
        _, wall = wall_ms(encodes)
        busy, n, by_name = device_breakdown(encodes)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
        per = VOICE_PROFILE_ENCODES
        enc = {"wall_ms": wall / per, "busy_ms": busy / per,
               "launches": n / per, "idle_share": 1.0 - busy / wall,
               "top": [[k[:60], t / per, m / per] for k, (t, m) in top]}
        out[str(ctx)]["encode"] = enc
        log(f"  profile whisper-tiny encode (n_audio_ctx {ctx}): "
            f"{enc['wall_ms']:.3f} ms wall, {enc['busy_ms']:.3f} ms busy, "
            f"{enc['launches']:.1f} launches a call (idle "
            f"{enc['idle_share']:.3f})")
    return out


def voice_profile_child() -> dict:
    """``voice_profile`` in a process of its own (this script with
    VOICE_PROFILE_FLAG), as phase 12 profiles: late in the smoke's process
    the profiler has lost kernel records. The child's log lines are passed
    on; its last line is the result."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), VOICE_PROFILE_FLAG],
        capture_output=True, text=True, timeout=SERVE_TIMEOUT)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"phase 13: the profile's process exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    for line in lines[:-1]:
        log(line)
    return json.loads(lines[-1])


# Phase 14: the vision path. YOLOv8n and YOLOv5nu at 640, MiDaS v2.1-small at
# the pipeline's 384, DPT-SwinV2 tiny_256 and the CRNN OCR at their published
# widths (random weights from the seed) behind VisionPipeline on a seeded
# 480x640 floor-and-obstacle frame; the card against the port's own CPU run
# where a tolerance is named.
VISION_FRAMES = 20            # timed frames of each pipeline (p50)
VISION_WARM = 3               # frames before them
VISION_STAGE_ITERS = 10       # timed calls of each stage (p50)
VISION_DET_TOL = 1e-5         # rel L2, raw boxes and class probabilities
VISION_MIDAS_TOL = 1e-5       # rel L2, relative inverse depth
VISION_DPT_TOL = 1e-4         # rel L2, relative inverse depth
VISION_OCR_TOL = 1e-5         # max abs, logits
VISION_BITS = ("DETECTION", "DEPTH", "OCR", "ATTRIBUTES", "SCENE_GRAPH",
               "NAVIGATION")
VISION_PROFILE_FRAMES = 5     # frames of each profiled window
VISION_PROFILE_FLAG = "--vision-profile"


def vision_configs() -> dict:
    """Phase 14's configurations: the two detectors, MiDaS-small at the
    pipeline's input, DPT-SwinV2 tiny_256, the CRNN and the frame."""
    from trackiellm_tpu_torch.models import depth, detector, dpt, ocr
    return {"v8n": detector.DetectorConfig.v8n(),
            "v5nu": detector.DetectorConfig.v5nu(),
            "midas": depth.DepthConfig.small()._replace(img_size=384),
            "dpt": dpt.DPTSwinConfig.tiny_256(),
            "ocr": ocr.OCRConfig(), "frame": (480, 640)}


def vision_frame(hw, seed: int) -> np.ndarray:
    """A synthetic camera frame from the seed: a wall above the horizon and
    a floor brightening toward the camera (a depth-friendly gradient),
    three blocks standing on the floor, a sign of dark strokes on a light
    board, and sensor noise."""
    rng = np.random.default_rng(seed)
    h, w = hw
    y = np.arange(h, dtype=np.float32)[:, None]
    x = np.arange(w, dtype=np.float32)[None, :]
    horizon = int(h * 0.4)
    wall = 150 + 30 * np.sin(x / (w / 7.0)) + 0 * y
    floor = 60 + 150 * (y - horizon) / (h - horizon) + 0 * x
    gray = np.where(y < horizon, wall, floor)
    frame = gray[..., None] * np.asarray([1.0, 0.95, 0.85], np.float32)
    for (x0, x1, y0, y1), rgb in (((0.40, 0.58, 0.45, 0.80), (200, 40, 35)),
                                  ((0.08, 0.22, 0.30, 0.95), (40, 60, 170)),
                                  ((0.72, 0.90, 0.55, 0.70), (90, 160, 70))):
        frame[int(y0 * h):int(y1 * h), int(x0 * w):int(x1 * w)] = rgb
    sy, sx = int(0.08 * h), int(0.62 * w)
    frame[sy:sy + h // 8, sx:sx + w // 4] = 235
    for k in range(6):  # glyph strokes
        c = sx + 8 + k * (w // 4 - 16) // 6
        frame[sy + 6:sy + h // 8 - 6, c:c + 4] = 20
    frame += rng.normal(0.0, 3.0, frame.shape)
    return np.clip(frame, 0, 255).astype(np.uint8)


def p50_ms(fn, iters: int = VISION_STAGE_ITERS, warm: int = 1) -> float:
    """Median host ms of ``fn`` between two card synchronizations."""
    for _ in range(warm):
        fn()
    return float(np.median([wall_ms(fn)[1] for _ in range(iters)]))


def vision_models(dev, sizes: dict) -> dict:
    """Every phase-14 model's random params from the seed on the card, and
    a CPU copy of each."""
    from trackiellm_tpu_torch.models import depth, detector, dpt, llm, ocr
    inits = {"v8n": detector.init_detector, "v5nu": detector.init_detector,
             "midas": depth.init_depth, "dpt": dpt.init_dpt,
             "ocr": ocr.init_ocr}
    out = {}
    for k, (name, init) in enumerate(inits.items()):
        p = init(torch.Generator(device=dev).manual_seed(SEED + 140 + k),
                 sizes[name])
        out[name] = (p, llm.params_to(p, torch.device("cpu")))
    return out


def vision_fns(params: dict, sizes: dict, depth_kind: str):
    """The pipeline's backends over one side's params: the v8n detector,
    the depth model of ``depth_kind`` and the OCR (crops to strings)."""
    from trackiellm_tpu_torch.models import depth, detector, dpt, ocr
    det = lambda chw: detector.detector_forward(  # noqa: E731
        params["v8n"], sizes["v8n"], chw)
    if depth_kind == "dpt":
        dep = lambda chw: dpt.dpt_forward(  # noqa: E731
            params["dpt"], sizes["dpt"], chw)
    else:
        dep = lambda chw: depth.depth_forward(  # noqa: E731
            params["midas"], sizes["midas"], chw)
    dev = params["ocr"]["out_w"].device

    def read(crops):
        return ocr.ctc_greedy_decode(ocr.ocr_forward(
            params["ocr"], sizes["ocr"], torch.from_numpy(crops).to(dev)))
    return det, dep, read


def vision_pipeline(dev, params: dict, sizes: dict, depth_kind: str,
                    seed: int = 0):
    """VisionPipeline with the v8n detector, MiDaS or DPT, the OCR and a
    NavigationEngine, on ``dev``."""
    from trackiellm_tpu_torch.navigation import NavigationEngine
    from trackiellm_tpu_torch.vision import VisionConfig, VisionPipeline
    det, dep, read = vision_fns(params, sizes, depth_kind)
    conf = (VisionConfig(depth_preproc="dpt",
                         depth_input=sizes["dpt"].image_size)
            if depth_kind == "dpt" else
            VisionConfig(depth_input=sizes["midas"].img_size))
    conf.detector_input = sizes["v8n"].img_size
    return VisionPipeline(det, dep, read, config=conf,
                          navigation_engine=NavigationEngine(seed=seed,
                                                             device=dev),
                          device=dev)


def check_valid(res, tag: str) -> list:
    """The requested analyses a frame's ``valid_analyses`` must hold: a
    stage that degraded on the card fails the phase."""
    from trackiellm_tpu_torch.vision import AnalysisFlags
    missing = [b for b in VISION_BITS
               if not res.valid_analyses & AnalysisFlags[b]]
    if missing:
        raise AssertionError(f"phase 14: {tag}: the frame lacks "
                             f"{missing} of valid_analyses")
    return [b for b in VISION_BITS]


def objects_agree(a, b, px: float = 0.5) -> int:
    """Objects of ``a`` that ``b`` also has: the same class, each box
    corner within ``px`` (in any order: random weights put many scores
    within an ulp of each other, and a swap in the score order moves every
    later object)."""
    left = list(b)
    hits = 0
    for x in a:
        for y in left:
            if x.class_id == y.class_id and max(
                    abs(u - v) for u, v in zip(x.box, y.box)) <= px:
                left.remove(y)
                hits += 1
                break
    return hits


def vision_detectors(dev, models, sizes, frame) -> dict:
    """Each detector's raw outputs, card against CPU on the CPU's
    letterbox; decode_and_nms on the card given the CPU's raw outputs
    against the CPU's, bit for bit; the detect stage's time."""
    from trackiellm_tpu_torch.models import detector
    from trackiellm_tpu_torch.ops import nms, preprocess
    out = {}
    size = sizes["v8n"].img_size
    chw, _ = preprocess.letterbox_preprocess(torch.from_numpy(frame), size,
                                             size)
    for name in ("v8n", "v5nu"):
        card, cpu = models[name]
        cfg = sizes[name]
        bg, pg = detector.detector_forward(card, cfg, chw.to(dev))
        bc, pc = detector.detector_forward(cpu, cfg, chw)
        errs = {"boxes": rel_l2(bg.cpu(), bc), "probs": rel_l2(pg.cpu(), pc)}
        dc = nms.decode_and_nms(bc, pc, max_out=20)
        dg = nms.decode_and_nms(bc.to(dev), pc.to(dev), max_out=20)
        same = all(torch.equal(g.cpu(), c) for g, c in zip(dg, dc))
        fdev = torch.from_numpy(frame).to(dev)

        def detect(card=card, cfg=cfg):
            x, m = preprocess.letterbox_preprocess(fdev, size, size)
            d = nms.decode_and_nms(*detector.detector_forward(card, cfg, x),
                                   max_out=20)
            return nms.boxes_to_original(d.boxes, m)
        out[name] = {"raw_rel_l2": errs, "tol": VISION_DET_TOL,
                     "nms_bit_equal": same,
                     "detections": int(dc.valid.sum()),
                     "detect_ms": p50_ms(detect)}
        log(f"  {name} at {size}: raw boxes rel_l2 {errs['boxes']:.3e}, probs "
            f"{errs['probs']:.3e} (tol {VISION_DET_TOL:.0e}); decode_and_nms "
            f"on the card given the CPU's raw outputs "
            + ("bit-equal" if same else "DIFFERS")
            + f" ({out[name]['detections']} detections); letterbox + "
            f"detector + NMS {out[name]['detect_ms']:.3f} ms")
        if not (max(errs.values()) <= VISION_DET_TOL and same
                and torch.isfinite(bg).all() and torch.isfinite(pg).all()):
            raise AssertionError(f"phase 14: {name}: {errs}, nms equal "
                                 f"{same}")
        if name == "v8n":
            raw = (bg, pg)
    return out, raw


def sweep_candidates(boxes, probs):
    """What ``decode_and_nms`` hands its sweep at the default thresholds
    (class-agnostic): who knocks out whom among the top 256."""
    from trackiellm_tpu_torch.ops import nms
    best = probs.max(-1).values
    top, idx = nms.top_k_first_index(torch.where(best >= 0.5, best, 0.0),
                                     min(256, boxes.shape[0]))
    iou = nms.pairwise_iou(boxes[idx], boxes[idx])
    order = torch.arange(len(idx), device=boxes.device)
    return (order[None] > order[:, None]) & (iou > 0.45) & (top > 0)[:, None]


def vision_nms(boxes, probs) -> dict:
    """decode_and_nms alone on the card, and its K-step sweep alone."""
    from trackiellm_tpu_torch.ops import nms
    cand = sweep_candidates(boxes, probs)
    out = {"decode_and_nms_ms": p50_ms(
               lambda: nms.decode_and_nms(boxes, probs, max_out=20)),
           "sweep_ms": p50_ms(lambda: nms.greedy_sweep(cand)),
           "sweep_steps": cand.shape[0]}
    log(f"  NMS on the card: decode_and_nms {out['decode_and_nms_ms']:.3f} "
        f"ms, its {cand.shape[0]}-step sweep alone {out['sweep_ms']:.3f} ms")
    return out


def vision_depths(dev, models, sizes, frame) -> dict:
    """MiDaS and DPT maps, card against CPU on the CPU's normalized input;
    the depth + fusion stage's time."""
    from trackiellm_tpu_torch.models import depth, dpt
    from trackiellm_tpu_torch.ops import preprocess
    from trackiellm_tpu_torch.vision import object_analysis as oa
    out = {}
    f = torch.from_numpy(frame)
    fdev = f.to(dev)
    boxes = torch.tensor([[100.0, 150.0, 300.0, 400.0]] * 20, device=dev)
    ok = torch.ones((20,), dtype=torch.bool, device=dev)
    for name, norm, fwd, tol in (
            ("midas", preprocess.imagenet_normalize_chw, depth.depth_forward,
             VISION_MIDAS_TOL),
            ("dpt", preprocess.dpt_normalize_chw, dpt.dpt_forward,
             VISION_DPT_TOL)):
        card, cpu = models[name]
        cfg = sizes[name]
        s = cfg.img_size if name == "midas" else cfg.image_size
        x = norm(f, s, s)
        got = fwd(card, cfg, x.to(dev))
        ref = fwd(cpu, cfg, x)
        err = rel_l2(got.cpu(), ref)

        def stage(card=card, cfg=cfg, norm=norm, fwd=fwd, s=s):
            m = depth.relative_to_metric(fwd(card, cfg, norm(fdev, s, s)))
            return oa.fuse_boxes_with_depth(boxes, ok, m)
        out[name] = {"rel_l2": err, "tol": tol, "size": s,
                     "depth_fusion_ms": p50_ms(stage)}
        log(f"  {name} at {s}: relative depth rel_l2 {err:.3e} (tol "
            f"{tol:.0e}); normalize + depth + metric + fusion "
            f"{out[name]['depth_fusion_ms']:.3f} ms")
        if not (torch.isfinite(got).all() and err <= tol):
            raise AssertionError(f"phase 14: {name} rel_l2 {err}")
    return out


def vision_ocr(dev, models, sizes, frame) -> dict:
    """The CRNN on the page grid's crops of the frame: logits card against
    CPU, the decoded strings equal; the OCR stage's time."""
    from trackiellm_tpu_torch.models import ocr
    from trackiellm_tpu_torch.vision.pipeline import _host_resize_gray
    gray = frame.astype(np.float32).mean(-1) / 255.0
    h, w = gray.shape
    crops = np.stack([_host_resize_gray(gray[r * h // 4:(r + 1) * h // 4,
                                             c * w // 2:(c + 1) * w // 2],
                                        32, 128)
                      for r in range(4) for c in range(2)])
    card, cpu = models["ocr"]
    cfg = sizes["ocr"]
    lg = ocr.ocr_forward(card, cfg, torch.from_numpy(crops).to(dev))
    lc = ocr.ocr_forward(cpu, cfg, torch.from_numpy(crops))
    err = (lg.cpu() - lc).abs().max().item()
    sg, sc = ocr.ctc_greedy_decode(lg), ocr.ctc_greedy_decode(lc)
    ms = p50_ms(lambda: ocr.ctc_greedy_decode(ocr.ocr_forward(
        card, cfg, torch.from_numpy(crops).to(dev))))
    out = {"crops": len(crops), "max_abs_err": err, "tol": VISION_OCR_TOL,
           "strings_equal": sg == sc, "chars": sum(map(len, sg)),
           "ocr_ms": ms}
    log(f"  OCR (CRNN, {len(crops)} page crops): logits max abs {err:.3e} "
        f"(tol {VISION_OCR_TOL:.0e}), strings "
        + ("equal" if sg == sc else "DIFFER") + f"; crops to strings {ms:.3f}"
        " ms")
    if not (torch.isfinite(lg).all() and err <= VISION_OCR_TOL
            and sg == sc):
        raise AssertionError(f"phase 14: OCR max abs {err}, strings "
                             f"{sg[:2]} / {sc[:2]}")
    return out


def vision_navigation(dev, depth_m: np.ndarray) -> dict:
    """The navigation engine on the card and the CPU given one metric depth
    map and the same RANSAC indices: the grids must be equal."""
    from trackiellm_tpu_torch.navigation import NavigationEngine
    from trackiellm_tpu_torch.navigation.path_planner import (
        draw_ransac_indices)
    idx = draw_ransac_indices(torch.Generator().manual_seed(SEED),
                              depth_m.size)
    card = NavigationEngine(device=dev)
    cpu = NavigationEngine(device="cpu")
    gg = card.update(depth_m, indices=idx)
    gc = cpu.update(depth_m, indices=idx)
    same = bool(np.array_equal(gg, gc))
    ms = p50_ms(lambda: (card.update(depth_m), card.current_hazards()))
    out = {"grid_equal": same, "cells": np.bincount(
               gc.ravel(), minlength=6).tolist(),
           "inlier_frac": cpu.inlier_frac, "cues": cpu.current_hazards(),
           "navigation_ms": ms}
    log(f"  navigation ({depth_m.shape[0]}x{depth_m.shape[1]} depth, same "
        f"RANSAC indices): grid card "
        + ("equal to" if same else "DIFFERS from")
        + f" cpu, cells by class {out['cells']}, cues {out['cues']}; update "
        f"+ hazards {ms:.3f} ms")
    if not same:
        raise AssertionError("phase 14: the navigation grids differ")
    return out


def vision_pipelines(dev, models, sizes, frames) -> tuple:
    """process_frame with AnalysisFlags.ALL, with MiDaS and with DPT: every
    bit must be valid; the card's objects against the CPU's; the frame's
    wall p50. Returns (results, the CPU's MiDaS metric depth map)."""
    from trackiellm_tpu_torch.vision import AnalysisFlags
    out, depth_m = {}, None
    cards = {k: v[0] for k, v in models.items()}
    cpus = {k: v[1] for k, v in models.items()}
    for kind in ("midas", "dpt"):
        card = vision_pipeline(dev, cards, sizes, kind)
        cpu = vision_pipeline(torch.device("cpu"), cpus, sizes, kind)
        rg = card.process_frame(frames[0], AnalysisFlags.ALL)
        rc = cpu.process_frame(frames[0], AnalysisFlags.ALL)
        bits = check_valid(rg, f"{kind} on the card")
        check_valid(rc, f"{kind} on the CPU")
        if kind == "midas":
            depth_m = rc.depth_map_m
        for f in frames[1:1 + VISION_WARM]:
            card.process_frame(f, AnalysisFlags.ALL)
        walls = []
        for f in frames[1 + VISION_WARM:]:
            res, ms = wall_ms(lambda f=f: card.process_frame(
                f, AnalysisFlags.ALL))
            check_valid(res, f"{kind} on the card")
            walls.append(ms)
        stages = res.timings_ms
        agree = objects_agree(rg.objects, rc.objects)
        out[kind] = {
            "valid": bits, "objects": len(rg.objects),
            "cpu_objects": len(rc.objects), "objects_agree": agree,
            "edges": len(rg.scene_graph["edges"]),
            "text_regions": len(rg.text_regions),
            "cues": rg.navigation_cues,
            "depth_rel_l2_vs_cpu": rel_l2(torch.from_numpy(rg.depth_map_m),
                                          torch.from_numpy(rc.depth_map_m)),
            "frames": len(walls), "frame_ms_p50": float(np.median(walls)),
            "frame_ms_min": float(np.min(walls)),
            "timings_ms_last_frame": stages}
        log(f"  process_frame ALL with {kind} ({frames[0].shape[0]}x"
            f"{frames[0].shape[1]} frame): valid {'|'.join(bits)}; "
            f"{len(rg.objects)} objects ({agree} agree with the CPU's "
            f"{len(rc.objects)}), {out[kind]['edges']} edges, "
            f"{out[kind]['text_regions']} text regions, cues "
            f"{rg.navigation_cues}; frame wall p50 "
            f"{out[kind]['frame_ms_p50']:.2f} ms over {len(walls)} frames")
    return out, depth_m


def phase_vision(dev, counters, profile) -> dict:
    """Phase 14: the vision path (module comment above). None of the port's
    hand-written kernels is on it: every counter must stay at 0."""
    t0 = time.perf_counter()
    for f in counters.values():
        f.launches = 0
    sizes = vision_configs()
    frames = [vision_frame(sizes["frame"], SEED + i)
              for i in range(1 + VISION_WARM + VISION_FRAMES)]
    models = vision_models(dev, sizes)
    out = {"frame": list(sizes["frame"]),
           "models": {"v8n": sizes["v8n"].img_size,
                      "v5nu": sizes["v5nu"].img_size,
                      "midas": sizes["midas"].img_size,
                      "dpt": sizes["dpt"].image_size, "ocr": [32, 128]}}
    out["detector"], raw = vision_detectors(dev, models, sizes, frames[0])
    out["nms"] = vision_nms(*raw)
    out["depth"] = vision_depths(dev, models, sizes, frames[0])
    out["ocr"] = vision_ocr(dev, models, sizes, frames[0])
    out["pipeline"], depth_m = vision_pipelines(dev, models, sizes, frames)
    out["navigation"] = vision_navigation(dev, depth_m)
    launches = {k: f.launches for k, f in counters.items()}
    expect_routes(launches, (), tuple(launches), "phase 14")
    out["launches"] = launches
    out["profile"] = profile()
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 14 took {out['seconds']:.1f} s")
    return out


def vision_profile(dev) -> dict:
    """process_frame (AnalysisFlags.ALL) with MiDaS and with DPT under the
    profiler, VISION_PROFILE_FRAMES frames each after a warm-up, and the
    NMS sweep alone: on the host clock, then profiled: busy ms and launches
    a frame (a sweep), the idle share 1 - busy / wall, the largest
    kernels."""
    from trackiellm_tpu_torch.models import detector
    from trackiellm_tpu_torch.ops import nms
    from trackiellm_tpu_torch.vision import AnalysisFlags
    sizes = vision_configs()
    frames = [vision_frame(sizes["frame"], SEED + 100 + i)
              for i in range(2 + 2 * VISION_PROFILE_FRAMES)]
    models = {k: v[0] for k, v in vision_models(dev, sizes).items()}
    out = {}
    for kind in ("midas", "dpt"):
        pipe = vision_pipeline(dev, models, sizes, kind)
        for f in frames[:2]:
            pipe.process_frame(f, AnalysisFlags.ALL)
        n = VISION_PROFILE_FRAMES

        def run(part):
            for f in frames[2 + part * n:2 + (part + 1) * n]:
                pipe.process_frame(f, AnalysisFlags.ALL)
        _, wall = wall_ms(lambda: run(0))
        busy, launches, by_name = device_breakdown(lambda: run(1))
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
        out[kind] = {"wall_ms_per_frame": wall / n,
                     "busy_ms_per_frame": busy / n,
                     "launches_per_frame": launches / n,
                     "idle_share": 1.0 - busy / wall,
                     "top": [[k[:60], t / n, c / n] for k, (t, c) in top]}
        log(f"  profile process_frame ALL with {kind}: "
            f"{wall / n:.2f} ms wall, {busy / n:.2f} ms busy, "
            f"{launches / n:.0f} launches a frame (idle "
            f"{out[kind]['idle_share']:.3f})")
    size = sizes["v8n"].img_size
    chw = torch.rand((3, size, size), generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev)
    cand = sweep_candidates(*detector.detector_forward(models["v8n"],
                                                       sizes["v8n"], chw))
    nms.greedy_sweep(cand)
    _, wall = wall_ms(lambda: nms.greedy_sweep(cand))
    busy, launches, _ = device_breakdown(lambda: nms.greedy_sweep(cand))
    out["nms_sweep"] = {"steps": cand.shape[0], "wall_ms": wall,
                        "busy_ms": busy, "launches": launches,
                        "idle_share": 1.0 - busy / wall}
    log(f"  profile NMS sweep ({cand.shape[0]} steps): {wall:.3f} ms wall, "
        f"{busy:.3f} ms busy, {launches} launches")
    return out


def vision_profile_child() -> dict:
    """``vision_profile`` in a process of its own (this script with
    VISION_PROFILE_FLAG), as phases 12 and 13 profile. The child's log
    lines are passed on; its last line is the result."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), VISION_PROFILE_FLAG],
        capture_output=True, text=True, timeout=SERVE_TIMEOUT)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"phase 14: the profile's process exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    for line in lines[:-1]:
        log(line)
    return json.loads(lines[-1])


def serve_config(llm):
    """Phases 5-7 and 12's configuration: Mistral-7B cut to max_seq 512."""
    return llm.LLMConfig.mistral_7b()._replace(max_seq=512,
                                              sliding_window=512)


def result_line(kind: str) -> str:
    """The last line of the run: it used one card, of this kind."""
    return json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": 1}})


# name: (source, TPU kernel it replaces, the cases whose times the JSON line
# carries (the first at its top level), the phase whose path counts its
# launches). quantize_activations is the W4A8 wrapper's first launch: it
# replaces the pre-pass that runs before the Pallas W4A8 call.
KERNELS = {
    "q4_matmul_w4a8": ("trackiellm_tpu_torch/csrc/q4_w4a8.cu",
                       "trackiellm_tpu/ops/quant.py:662",
                       ("w_gu M=1", "w_gu M=512"), 5),
    "quantize_activations": ("trackiellm_tpu_torch/csrc/q4_w4a8.cu",
                             "trackiellm_tpu/ops/quant.py:595",
                             ("M=1 K=4096", "M=512 K=4096"), 5),
    "flash_attention": ("trackiellm_tpu_torch/csrc/flash_attn.cu",
                        "trackiellm_tpu/ops/attention.py:176",
                        ("causal S=512 bfloat16", "causal S=256 bfloat16"),
                        5),
    "q8_matmul": ("trackiellm_tpu_torch/csrc/q8_matmul.cu",
                  "trackiellm_tpu/ops/quant.py:184",
                  ("w_gu M=1", "w_gu M=512"), 6),
    "q4_matmul_f32a": ("trackiellm_tpu_torch/csrc/q4_f32a.cu",
                       "trackiellm_tpu/ops/quant.py:272",
                       ("w_gu M=1", "w_gu M=512"), 7),
    "fused_mlp_q4": ("trackiellm_tpu_torch/csrc/fused_mlp_q4.cu",
                     "trackiellm_tpu/ops/fused.py:144", ("M=1 bfloat16",), 7),
    "q4_matmul_stream": ("trackiellm_tpu_torch/csrc/q4_stream.cu",
                         "trackiellm_tpu/ops/quant.py:389", ("w_gu M=1",), 9),
    "stream": ("trackiellm_tpu_torch/csrc/diag_probes.cu",
               "tools/diag_envelope.py:60", ("512 MiB",), 9),
    "grid64": ("trackiellm_tpu_torch/csrc/diag_probes.cu",
               "tools/diag_scan_overhead.py:70", ("(8, 128)",), 9),
    "chain_tiny": ("trackiellm_tpu_torch/csrc/diag_probes.cu",
                   "tools/diag_overhead.py:101", ("64 calls (8, 128)",), 9),
}


# Keys a kernel's cases carry where its rows have them: the fused block's
# unfused yardstick, the chain's CUDA-event spans, why a case has no
# device-only time.
EXTRA_KEYS = {"unfused_ms": "unfused", "unfused_device_ms": "unfused_device",
              "event_ms": "event_ms", "library_event_ms": "library_event_ms",
              "device_note": "device_note"}


def kernels_line(rows, launches) -> str:
    """The ``{"kernels": [...]}`` line: per kernel, the main path's
    launches and its headline cases' times, bound and library time."""
    kernels = []
    for name, (src, replaces, headlines, phase) in KERNELS.items():
        cases = []
        for case in headlines:
            r = next(r for r in rows[name] if r["case"] == case)
            device = r.get("device")
            cases.append({
                "case": case, "ms": r["ms"], "plain_ms": r["plain"],
                "bound_ms": r["bound"], "bound_by": r["bound_by"],
                "library_ms": r.get("library"),
                "device_ms": device["total"] if device else None,
                "library_device_ms": r.get("library_device"),
                **{key: r[field] for key, field in EXTRA_KEYS.items()
                   if field in r}})
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[phase][name],
            "max_abs_err": max(r["err"] for r in rows[name]),
            **{k: v for k, v in cases[0].items() if k != "case"},
            "timed_case": headlines[0], "launches_phase": phase,
            "launches_by_phase": {str(p): n[name]
                                  for p, n in sorted(launches.items())},
            "cases": cases})
    return json.dumps({"kernels": kernels})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        print(f"chip_smoke: needs an sm_90 card, found {cap}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    for name in LEVERS:  # phases 3-6 and 8 run the default routes
        os.environ.pop(name, None)
    if sys.argv[1:] == [SERVE_PROFILE_FLAG]:
        return serve_profile_main(dev)
    if sys.argv[1:] == [VOICE_PROFILE_FLAG]:
        print(json.dumps(voice_profile(dev)), flush=True)
        return 0
    if sys.argv[1:] == [VISION_PROFILE_FLAG]:
        print(json.dumps(vision_profile(dev)), flush=True)
        return 0
    smi = nvidia_smi()
    log(f"phase 1 device: torch {torch.__version__} cuda {torch.version.cuda}"
        f" capability {cap} | {smi}")

    from trackiellm_tpu_torch import __main__ as cli
    from trackiellm_tpu_torch.llm import paging
    from trackiellm_tpu_torch.llm import runner as runner_mod
    from trackiellm_tpu_torch.llm import server as server_mod
    from trackiellm_tpu_torch.llm import tokenizer as tokenizer_mod
    from trackiellm_tpu_torch.models import checkpoint, convert, llm
    from trackiellm_tpu_torch.ops import _build, attention, diag, fused, quant
    from trackiellm_tpu_torch.tools import measure_server

    counters = launch_counters()
    t0 = time.perf_counter()

    def banner(msg: str) -> None:
        """A phase's first line, with the seconds since the build began."""
        log(f"{msg} [{time.perf_counter() - t0:.1f} s]")
    path = _build.build()
    _build.library()
    log(f"phase 2 build: nvcc and load {time.perf_counter() - t0:.1f} s -> "
        f"{path.relative_to(_build.BUILD_ROOT.parent.parent)}")

    banner("phase 3 kernels vs plain versions (card, L2 flushed per call):")
    cfg = serve_config(llm)
    rows = phase_kernels(dev, quant, attention, fused, llm, diag,
                         serve_shapes(runner_mod, quant.KERNEL_MAX_M,
                                      cfg.max_seq, SERVE_SLOTS))
    banner("phase 4 width check (Mistral-7B width, 2 layers):")
    phase_width(dev, llm, quant, fused)
    slice_args = (dev, llm, runner_mod, tokenizer_mod)
    launches = {}
    banner("phase 5 slice (Mistral-7B, 32 layers, Q4, max_seq 512):")
    params4 = build_model(dev, llm, cfg, 4)
    launches[5] = drive(*slice_args, params4, cfg, counters, "abcd")
    expect_routes(launches[5], ("q4_matmul_w4a8", "quantize_activations",
                                "flash_attention"),
                  ("q8_matmul", "q4_matmul_f32a", "fused_mlp_q4",
                   *DIAGNOSTIC), "phase 5")
    if launches[5]["quantize_activations"] != launches[5]["q4_matmul_w4a8"]:
        raise AssertionError("phase 5: not one activation quantization per "
                             "W4A8 matmul")
    log(json.dumps({"profile": profile_path(dev, runner_mod, tokenizer_mod,
                                            params4, cfg), "phase": 5}))
    banner("phase 6 Q8 slice (Mistral-7B, 32 layers, Q8, max_seq 512):")
    params8 = build_model(dev, llm, cfg, 8)
    launches[6] = drive(*slice_args, params8, cfg, counters, "abc")
    expect_routes(launches[6], ("q8_matmul", "flash_attention"),
                  ("q4_matmul_w4a8", "quantize_activations", "q4_matmul_f32a",
                   "fused_mlp_q4", *DIAGNOSTIC), "phase 6")
    log(json.dumps({"profile": profile_path(dev, runner_mod, tokenizer_mod,
                                            params8, cfg), "phase": 6}))
    del params8
    banner("phase 7 opt-in Q4 routes (phase 5's model, TRACKIE_Q4_F32A=1, "
        "TRACKIE_FUSED_MLP=1):")
    with levers_on():
        launches[7] = drive(*slice_args, params4, cfg, counters, "ab")
        expect_routes(launches[7],
                      ("q4_matmul_f32a", "fused_mlp_q4", "flash_attention"),
                      ("q4_matmul_w4a8", "quantize_activations", "q8_matmul",
                       *DIAGNOSTIC), "phase 7")
        log(json.dumps({"profile": profile_path(
            dev, runner_mod, tokenizer_mod, params4, cfg), "phase": 7}))
    banner("phase 8 entry point (2-layer Q8 checkpoint, generate):")
    phase_entry(dev, llm, checkpoint, cli, counters)
    banner("phase 9 diagnostics (the three tools; phase 5's model cut to "
        "32/16/8 layers):")
    launches[9] = phase_diagnostics(dev, params4, cfg, counters)
    banner(f"phase 10 tool calls and speculation (phase 5's model, max_seq "
        f"{SLICE10_MAX_SEQ}):")
    slice10 = phase_slice10(
        dev, llm, runner_mod, tokenizer_mod, quant, params4,
        llm.LLMConfig.mistral_7b()._replace(max_seq=SLICE10_MAX_SEQ),
        counters)
    launches[10] = slice10["launches"]
    expect_routes(launches[10], ("q4_matmul_w4a8", "quantize_activations",
                                 "flash_attention", "q4_matmul_f32a"),
                  ("q8_matmul", "fused_mlp_q4", *DIAGNOSTIC), "phase 10")
    banner(f"phase 11 GGUF to reply (Mistral-7B width, {GGUF_LAYERS} layers, "
        "Q4_K_M file, convert --bits 4, generate):")
    gguf = phase_gguf(
        dev, llm.LLMConfig.mistral_7b()._replace(n_layers=GGUF_LAYERS), llm,
        convert, checkpoint, quant, tokenizer_mod, cli, counters)
    launches[11] = gguf.pop("launches")
    log(json.dumps({"gguf": gguf}))
    banner(f"phase 12 serving (phase 5's model, {SERVE_SLOTS} slots, max_seq "
        f"{cfg.max_seq}):")
    serve = phase_serve(dev, llm, runner_mod, tokenizer_mod, server_mod,
                        paging, measure_server, params4, cfg, counters,
                        profile=serve_profile_child)
    launches[12] = serve.pop("launches")
    del params4
    banner("phase 13 voice (Whisper-tiny GGML at 30-s and 10-s windows, "
        "large-v3 widths at 2+2 layers, Silero ONNX, TTS default, Piper "
        "VITS):")
    voice = phase_voice(dev, llm, cli, counters, voice_profile_child)
    banner("phase 14 vision (480x640 frame; YOLOv8n and YOLOv5nu at 640, "
           "MiDaS-small at 384, DPT-SwinV2 tiny_256, CRNN OCR, navigation):")
    vision = phase_vision(dev, counters, vision_profile_child)

    smi = nvidia_smi()
    print(json.dumps({"vision": vision, "card": smi}), flush=True)
    print(json.dumps({"voice": voice, "card": smi}), flush=True)
    print(json.dumps({"serve": serve, "card": smi}), flush=True)
    print(json.dumps({"slice10": slice10, "card": smi}), flush=True)
    print(smi, flush=True)
    print(kernels_line(rows, launches), flush=True)
    print(result_line(torch.cuda.get_device_name(0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
