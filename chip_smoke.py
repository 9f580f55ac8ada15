#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on an NVIDIA H100.

    python3 chip_smoke.py

Phases, one line each (any failure is an uncaught exception and a non-zero
exit):
  1. device: torch, capability (must be (9, 0)), nvidia-smi name and power
     limit;
  2. build: nvcc builds the CUDA kernels from ``trackiellm_tpu_torch/csrc``;
  3. kernels: each CUDA kernel against its plain PyTorch version at the
     main path's shapes (W4A8 at M in {1, 8, 64, 256, 512} on the five
     Mistral-7B projections; flash attention in five variants at H=32,
     Hk=8, D=128, S in {256, 512}, bf16 and f32), with error, tolerance and
     both times;
  4. width: Mistral-7B width cut to 2 layers, random Q4 weights from a
     seed: prefill logits on the card against the port's CPU path;
  5. slice: Mistral-7B (32 layers, max_seq 512, random Q4 weights) behind
     ``LLMRunner`` answers four requests; both kernels must have launched,
     greedy text must not depend on the lookahead depth, and every logit
     vector must be finite.
The last two lines are the kernels' JSON summary and the result line.
"""

import json
import math
import subprocess
import sys
import time

import torch

SEED = 1234
MISTRAL_SHAPES = {  # (K, N) of the Q4 projections, group 256
    "wqkv": (4096, 6144), "wo": (4096, 4096), "w_gu": (4096, 28672),
    "w_down": (14336, 4096), "lm_head": (4096, 32000),
}
W4A8_MS = (1, 8, 64, 256, 512)
W4A8_TOL = 1e-5      # rel L2: identical int dots, f32 folds summed in another order
FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}  # rel L2; bf16 output rounding
WIDTH_TOL = 5e-2     # rel L2: W4A8 activation quantization, ~0.5% per matmul
SYSTEM = ("You are Trackie, an assistant for a blind user. Answer in one "
          "or two short sentences and warn about hazards first.")
CONTEXT = ("Objects: person 2.1 m ahead, bicycle 3.4 m left, door 5 m "
           "right. Depth: clear path 4 m. Text: EXIT. Sound: traffic.")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=30)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` per call, with L2 flushed before each
    call (the main path finds weights cold: a 7B model is 70x L2)."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
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


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def phase_kernels(dev, quant, attention):
    """Phase 3: every kernel against its plain version, times beside."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = {"q4_matmul_w4a8": [], "flash_attention": []}
    for name, (k, n) in MISTRAL_SHAPES.items():
        w = quant.quantize_q4(torch.randn((k, n), generator=gen, device=dev)
                              / math.sqrt(k))
        for m in W4A8_MS:
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            got = quant.q4_matmul_w4a8(x, w.values, w.scales)
            ref = quant.q4_matmul_w4a8_ref(x, w.values, w.scales)
            torch.cuda.synchronize()
            err = rel_l2(got, ref)
            abs_err = (got - ref).abs().max().item()
            ms = time_ms(lambda: quant.q4_matmul_w4a8(x, w.values, w.scales))
            plain = time_ms(
                lambda: quant.q4_matmul_w4a8_ref(x, w.values, w.scales))
            log(f"  w4a8 {name:7s} M={m:3d} K={k} N={n}: rel_l2={err:.3e} "
                f"(tol {W4A8_TOL:.0e}) max_abs={abs_err:.3e} "
                f"kernel_ms={ms:.4f} plain_ms={plain:.4f}")
            if not err < W4A8_TOL:
                raise AssertionError(f"W4A8 {name} M={m}: rel L2 {err}")
            rows["q4_matmul_w4a8"].append(
                dict(case=f"{name} M={m}", err=abs_err, ms=ms, plain=plain))
            del got, ref
    h, hk, d = 32, 8, 128
    variants = {"causal": {}, "window128": {"window": 128},
                "softcap50": {"softcap": 50.0},
                "sinks": {"sinks": True}, "scale0.05": {"scale": 0.05}}
    for s in (256, 512):
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((h, s, d), generator=gen, device=dev).to(dtype)
            kk = torch.randn((hk, s, d), generator=gen, device=dev).to(dtype)
            v = torch.randn((hk, s, d), generator=gen, device=dev).to(dtype)
            for vname, kw in variants.items():
                kw = dict(kw)
                if kw.pop("sinks", False):
                    kw["sinks"] = torch.randn((h,), generator=gen, device=dev)
                got = attention.flash_attention(q, kk, v, **kw)
                ref = attention.attention_ref(q, kk, v, **kw)
                torch.cuda.synchronize()
                err = rel_l2(got, ref)
                abs_err = (got.float() - ref.float()).abs().max().item()
                ms = time_ms(lambda: attention.flash_attention(q, kk, v, **kw))
                plain = time_ms(
                    lambda: attention.attention_ref(q, kk, v, **kw))
                tol = FLASH_TOL[dtype]
                log(f"  flash {vname:9s} S={s} {str(dtype)[6:]:8s}: "
                    f"rel_l2={err:.3e} (tol {tol:.0e}) max_abs={abs_err:.3e} "
                    f"kernel_ms={ms:.4f} plain_ms={plain:.4f}")
                if not err < tol:
                    raise AssertionError(f"flash {vname} S={s} {dtype}: {err}")
                rows["flash_attention"].append(dict(
                    case=f"{vname} S={s} {str(dtype)[6:]}", err=abs_err,
                    ms=ms, plain=plain))
    return rows


def phase_width(dev, llm):
    """Phase 4: Mistral width, 2 layers: card prefill vs the CPU path."""
    cfg = llm.LLMConfig.mistral_7b()._replace(n_layers=2, max_seq=512,
                                              sliding_window=512)
    params = llm.init_params_quantized(
        torch.Generator(device=dev).manual_seed(SEED), cfg, bits=4,
        device=dev)
    cpu = llm.params_to(params, torch.device("cpu"))
    toks = torch.randint(0, 256, (256,),
                         generator=torch.Generator().manual_seed(SEED))
    for bucket, length in ((64, 50), (256, 200)):
        lg, _ = llm.prefill(params, cfg, toks[:bucket].to(dev), length,
                            llm.KVCache.create(cfg, device=dev))
        lc, _ = llm.prefill(cpu, cfg, toks[:bucket], length,
                            llm.KVCache.create(cfg))
        err = rel_l2(lg.cpu(), lc)
        log(f"  width prefill bucket={bucket}: rel_l2 card vs cpu = "
            f"{err:.3e} (tol {WIDTH_TOL:.0e})")
        if not (torch.isfinite(lg).all() and err < WIDTH_TOL):
            raise AssertionError(f"width check bucket {bucket}: {err}")


class LogitWatch:
    """Wraps the model's forward entry points to record, without a host
    sync, whether each logit vector they return is finite."""

    NAMES = ("prefill", "extend", "decode_step")

    def __init__(self, llm):
        self.llm = llm
        self.flags = []
        self.orig = {n: getattr(llm, n) for n in self.NAMES}
        for n in self.NAMES:
            setattr(llm, n, self._wrap(self.orig[n]))

    def _wrap(self, fn):
        def watched(*args, **kwargs):
            logits, cache = fn(*args, **kwargs)
            self.flags.append(torch.isfinite(logits).all())
            return logits, cache
        return watched

    def close(self) -> int:
        for n, fn in self.orig.items():
            setattr(self.llm, n, fn)
        if not all(bool(f) for f in self.flags):
            raise AssertionError("a logit vector was not finite")
        return len(self.flags)


def request(runner, prompt: str, tag: str) -> str:
    """One request through the streaming session API, timed in two parts:
    prompt ingestion (prefill) and decode."""
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
    return text


def phase_slice(dev, llm, runner_mod, tokenizer_mod, quant, attention):
    """Phase 5: the port's main path at Mistral-7B width."""
    cfg = llm.LLMConfig.mistral_7b()._replace(max_seq=512,
                                              sliding_window=512)
    t0 = time.perf_counter()
    params = llm.init_params_quantized(
        torch.Generator(device=dev).manual_seed(SEED), cfg, bits=4,
        device=dev)
    torch.cuda.synchronize()
    log(f"  params: 32 layers Q4 in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB on the card")
    tok = tokenizer_mod.ByteTokenizer(cfg.vocab_size)
    gen = runner_mod.GenerationConfig(max_tokens=96, temperature=0.0,
                                      speculative=False)
    runner = runner_mod.LLMRunner(params, cfg, tok, gen, device=dev)
    prompt_a = f"descreva a cena a sua frente com detalhes ({SEED})"
    prompt_b = runner.build_prompt(SYSTEM, CONTEXT,
                                   "What is in front of me right now?")
    prompt_d = runner.build_prompt(SYSTEM, CONTEXT,
                                   "Can I walk to the door safely?")
    n_b = runner.count_tokens(prompt_b) + 1
    if not 200 <= n_b <= 400:
        raise AssertionError(f"cortex prompt is {n_b} tokens, not 200-400")
    runner.generate(prompt_a)  # warm-up: allocator, cuBLAS, first launches

    quant.q4_matmul_w4a8.launches = 0
    attention.flash_attention.launches = 0
    watch = LogitWatch(llm)
    try:
        request(runner, prompt_a, "a (short, bucket 64)")
        request(runner, prompt_b, f"b (cortex, {n_b} tokens, bucket "
                f"{runner_mod._bucket_for(n_b, runner_mod.PREFILL_BUCKETS)})")
        t0 = time.perf_counter()
        reply = runner.chat("And what about the bicycle?")
        torch.cuda.synchronize()
        n_c = len(runner.generated_ids)
        log(f"  request c (chat follow-up, extend): reply_ms="
            f"{(time.perf_counter() - t0) * 1e3:.2f} generated_tokens={n_c}"
            f" text_bytes={len(reply.encode())}")
        if n_c == 0:
            raise AssertionError("the chat follow-up generated nothing")
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
    launches = {"q4_matmul_w4a8": quant.q4_matmul_w4a8.launches,
                "flash_attention": attention.flash_attention.launches}
    log(f"  launches during the slice: {launches}; finite logit vectors: "
        f"{n_logits}")
    # Random weights over a 32000-id vocab rarely pick a byte id (< 256),
    # so the text can be short: the token ids are compared as well.
    if text_k4.encode() != text_k1.encode() or ids_k4 != ids_k1:
        raise AssertionError("lookahead 4 and 1 gave different replies")
    if not ids_k4:
        raise AssertionError("request a generated nothing")
    log(f"  lookahead 4 == lookahead 1: {len(ids_k4)} token ids and "
        f"{len(text_k4.encode())} text bytes identical")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"{name} never launched on the main path")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi()
    log(f"phase 1 device: torch {torch.__version__} cuda {torch.version.cuda}"
        f" capability {cap} | {smi}")
    if cap != (9, 0):
        print(f"chip_smoke: needs an sm_90 card, found {cap}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    from trackiellm_tpu_torch.llm import runner as runner_mod
    from trackiellm_tpu_torch.llm import tokenizer as tokenizer_mod
    from trackiellm_tpu_torch.models import llm
    from trackiellm_tpu_torch.ops import _build, attention, quant

    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    log(f"phase 2 build: nvcc and load {time.perf_counter() - t0:.1f} s -> "
        f"{path.relative_to(_build.BUILD_ROOT.parent.parent)}")

    log("phase 3 kernels vs plain versions (card, L2 flushed per call):")
    rows = phase_kernels(dev, quant, attention)
    log("phase 4 width check (Mistral-7B width, 2 layers):")
    phase_width(dev, llm)
    log("phase 5 slice (Mistral-7B, 32 layers, Q4, max_seq 512):")
    launches = phase_slice(dev, llm, runner_mod, tokenizer_mod, quant,
                           attention)

    sources = {"q4_matmul_w4a8": ("trackiellm_tpu_torch/csrc/q4_w4a8.cu",
                                  "trackiellm_tpu/ops/quant.py:662",
                                  "w_gu M=1"),
               "flash_attention": ("trackiellm_tpu_torch/csrc/flash_attn.cu",
                                   "trackiellm_tpu/ops/attention.py:176",
                                   "causal S=512 bfloat16")}
    kernels = []
    for name, (src, replaces, headline) in sources.items():
        head = next(r for r in rows[name] if r["case"] == headline)
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["err"] for r in rows[name]),
            "ms": head["ms"], "plain_ms": head["plain"],
            "timed_case": headline})
    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
