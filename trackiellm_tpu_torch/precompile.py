"""``precompile``: build what a later process would otherwise build at its
first request, and check every stage's first call on this device.

Port of the JAX package's ``precompile`` command
(``trackiellm_tpu/__main__.py:_cmd_precompile``). There, the cold start is
XLA compiling each production program, and the command fills the persistent
compile cache. In the port nothing is compiled per shape: the cold start is
the nvcc build of the kernel library (``ops/_build.py``) and the g++ build
of the native runtime (``ffi/native.py``), both kept under a hash of their
sources, and then each stage's first call loading CUDA modules, creating
cuBLAS and cuDNN handles and growing the allocator's pools. So the command
builds (or finds) both libraries, then drives each stage's entry points
once at the shapes the JAX command warms, on random weights from a seed
(or ``--llm``'s checkpoint), and prints ``[   t s] <stage> warm`` lines.
Only the libraries outlive the command: a later process with the same
build directory loads them with no compiler run
(``tools/cache_artifact.py`` carries them to another host), and pays each
stage's first call itself; the warm lines say what that call costs.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

STAGES = ("llm", "server", "asr", "tts", "vision", "dpt", "vlm")
SEED = 0


class Marks:
    """The stages' warm times, printed as the JAX command prints them."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.done: List[Tuple[str, float]] = []

    def __call__(self, name: str) -> None:
        t = time.perf_counter() - self.t0
        self.done.append((name, round(t, 1)))
        print(f"[{t:7.1f}s] {name} warm", flush=True)


def _gen(device: torch.device, k: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(SEED + k)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_libraries(device: torch.device) -> Dict[str, Optional[dict]]:
    """Build or find the kernel library (on the card only) and the native
    runtime; the seconds of each and whether a compiler ran."""
    from trackiellm_tpu_torch.ffi import native
    from trackiellm_tpu_torch.ops import _build

    out: Dict[str, Optional[dict]] = {"kernels": None}
    if device.type == "cuda":
        _build.build()
        _build.library()
        out["kernels"] = dict(_build.last_build)
    t0 = time.perf_counter()
    existed = native.library_path().exists()
    # Into this build directory even where this process loaded the
    # runtime from another; raises with g++'s stderr.
    path = native.build()
    if not native.native_available():
        raise RuntimeError(f"the native runtime at {path} did not load "
                           "(see the log)")
    out["native"] = {"compiled": not existed, "path": str(path),
                     "seconds": time.perf_counter() - t0}
    return out


def llm_model(device: torch.device, max_seq: int, checkpoint: Optional[str]):
    """(params, cfg): ``checkpoint``'s, else Mistral-7B Q4 at full width
    and depth with random weights (latency does not depend on them)."""
    from trackiellm_tpu_torch.models import llm

    if checkpoint:
        from trackiellm_tpu_torch.models.checkpoint import load_checkpoint
        params, cfg, _ = load_checkpoint(checkpoint, device=device)
        return params, cfg
    cfg = llm.LLMConfig.mistral_7b()._replace(max_seq=max_seq,
                                              sliding_window=max_seq)
    return llm.init_params_quantized(_gen(device, 0), cfg, bits=4,
                                     device=device), cfg


def warm_llm(params, cfg, device: torch.device, mark: Callable) -> None:
    """The runner's entry points: the small prefill bucket and decode
    chunks, streaming generate, prime/extend chunk buckets, the large
    prefill bucket, the sampled speculative verify."""
    from trackiellm_tpu_torch.llm.runner import GenerationConfig, LLMRunner
    from trackiellm_tpu_torch.llm.tokenizer import ByteTokenizer

    def runner(**gen):
        return LLMRunner(params, cfg, ByteTokenizer(cfg.vocab_size),
                         GenerationConfig(**gen), device=device)

    r = runner(max_tokens=12, min_tokens=4, temperature=0.0)
    r.generate("ola")
    mark("llm: small prefill bucket + decode chunks")
    runner(max_tokens=8, min_tokens=8, temperature=0.0).generate(
        "ola, descreva a cena", on_token=lambda _: None)
    mark("llm: streaming generate (on_token) shape")
    r.reset()
    r.prime("por favor descreva " * 40)
    mark("llm: prime/extend chunk buckets")
    r.reset()
    r.generate("contexto: " + "objeto perto. " * 60)
    mark("llm: large prefill bucket")
    runner(max_tokens=24, temperature=0.7, seed=0, speculative=True,
           spec_min_ngram=1).generate(
        "descreva descreva descreva descreva descreva descreva a cena")
    mark("llm: sampled speculative verify")


def warm_server(params, cfg, device: torch.device, mark: Callable) -> None:
    """An admission wave through ``prefill_batch`` and batched decode
    chunks: five requests on four slots."""
    from trackiellm_tpu_torch.llm.server import LLMServer
    from trackiellm_tpu_torch.llm.tokenizer import ByteTokenizer

    server = LLMServer(params, cfg, batch_slots=4,
                       tokenizer=ByteTokenizer(cfg.vocab_size),
                       chunk_steps=8, device=device)
    try:
        futs = [server.submit(f"pergunta {i} sobre a cena", max_tokens=12)
                for i in range(5)]
        for f in futs:
            f.result(timeout=1800)
    finally:
        server.close()
    mark("server: admission-wave prefill + batched decode chunks")


def warm_asr(device: torch.device, mark: Callable, cfg=None) -> None:
    """Whisper tiny on a 5-s window (n_audio_ctx 500)."""
    from trackiellm_tpu_torch.audio.asr import WhisperASR
    from trackiellm_tpu_torch.models import whisper

    cfg = cfg or whisper.WhisperConfig.tiny()._replace(n_audio_ctx=500)
    asr = WhisperASR(whisper.init_whisper(_gen(device, 1), cfg), cfg,
                     max_tokens=16)
    asr.transcribe(np.zeros(5 * 16000, np.float32))
    mark("asr: transcribe (5 s window)")


def warm_tts(device: torch.device, mark: Callable, cfg=None) -> None:
    """The TTS latency buckets through the streaming vocoder."""
    from trackiellm_tpu_torch.models import tts

    cfg = cfg or tts.TTSConfig.default()
    params = tts.init_tts(_gen(device, 2), cfg)
    for text in ("ha uma mesa a frente.",
                 "ha uma cadeira e uma pessoa perto da porta da "
                 "sala de estar agora."):
        for _ in tts.synthesize_streaming(params, cfg, text):
            pass
    mark("tts: latency buckets + streaming vocoder")


def warm_vision(device: torch.device, mark: Callable, det_cfg=None,
                depth_cfg=None, config=None) -> None:
    """A 480x640 frame through letterbox, detector, NMS, depth and
    fusion."""
    from trackiellm_tpu_torch.models import depth, detector
    from trackiellm_tpu_torch.vision.pipeline import VisionPipeline

    dcfg = det_cfg or detector.DetectorConfig.v8n()
    dparams = detector.init_detector(_gen(device, 3), dcfg)
    pcfg = depth_cfg or depth.DepthConfig.small()
    pparams = depth.init_depth(_gen(device, 4), pcfg)
    pipe = VisionPipeline(
        detector_fn=lambda chw: detector.detector_forward(dparams, dcfg,
                                                          chw),
        depth_fn=lambda chw: depth.depth_forward(pparams, pcfg, chw),
        config=config, device=device)
    pipe.process_frame(np.zeros((480, 640, 3), np.uint8))
    mark("vision: letterbox + detector + NMS + depth + fusion")


def warm_dpt(device: torch.device, mark: Callable, cfg=None) -> None:
    """The DPT-SwinV2 tiny_256 depth tower."""
    from trackiellm_tpu_torch.models import dpt

    cfg = cfg or dpt.DPTSwinConfig.tiny_256()
    params = dpt.init_dpt(_gen(device, 5), cfg)
    with torch.no_grad():
        out = dpt.dpt_forward(params, cfg, torch.zeros(
            (3, cfg.image_size, cfg.image_size), device=device))
    out.reshape(-1)[:1].cpu()
    mark("dpt: SwinV2 tiny_256 depth tower")


def warm_vlm(params, cfg, device: torch.device, mark: Callable,
             max_seq: int, clip_cfg=None) -> None:
    """The CLIP ViT-L/14-336 tower and projector, then the image rows
    spliced into the bucket-1024 prefill."""
    from trackiellm_tpu_torch.models import clip, llm

    ccfg = clip_cfg or clip.CLIPVisionConfig(proj_dim=cfg.dim)
    cparams = clip.init_params(ccfg, _gen(device, 6))
    with torch.no_grad():
        feats = clip.encode_and_project(cparams, ccfg, torch.zeros(
            (3, ccfg.image_size, ccfg.image_size), device=device))
    feats.reshape(-1)[:1].cpu()
    mark("vlm: CLIP ViT-L/14-336 tower + projector")
    bucket = 1024 if max_seq >= 1024 else max_seq
    toks = torch.zeros((bucket,), dtype=torch.long, device=device)
    n_img = feats.shape[0]
    with torch.no_grad():
        embeds = llm.embed_tokens(params, toks)
        embeds[4:4 + n_img] = feats.to(embeds.dtype)
        cache = llm.KVCache.create(cfg, device=device)
        logits, _ = llm.prefill(params, cfg, toks, min(n_img + 16, bucket),
                                cache, embeds=embeds)
    logits[:1].cpu()
    mark("vlm: embeds-spliced prefill bucket")


def run(device: torch.device, max_seq: int = 1024,
        checkpoint: Optional[str] = None, skip=()) -> dict:
    """Build the libraries, then warm every stage not in ``skip``; returns
    the build record, the stages' (name, seconds since the start) and the
    kernel launches by wrapper."""
    from trackiellm_tpu_torch.ops import kernel_wrappers

    unknown = set(skip) - set(STAGES)
    if unknown:
        raise ValueError(f"unknown stages {sorted(unknown)}; the stages are "
                         f"{','.join(STAGES)}")
    mark = Marks()
    libs = build_libraries(device)
    for name, rec in libs.items():
        if rec is None:
            print(f"[{0.0:7.1f}s] {name}: not built (device {device})",
                  flush=True)
        else:
            print(f"[{time.perf_counter() - mark.t0:7.1f}s] {name}: "
                  f"{'compiled' if rec['compiled'] else 'found'} in "
                  f"{rec['seconds']:.1f} s -> {rec['path']}", flush=True)
    wrappers = kernel_wrappers()
    before = {k: w.launches for k, w in wrappers.items()}
    params = cfg = None
    if "llm" not in skip or "server" not in skip or "vlm" not in skip:
        params, cfg = llm_model(device, max_seq, checkpoint)
        _sync(device)
        mark(f"llm: params ({cfg.n_layers} layers)")
    if "llm" not in skip:
        warm_llm(params, cfg, device, mark)
    if "server" not in skip:
        warm_server(params, cfg, device, mark)
    if "asr" not in skip:
        warm_asr(device, mark)
    if "tts" not in skip:
        warm_tts(device, mark)
    if "vision" not in skip:
        warm_vision(device, mark)
    if "dpt" not in skip:
        warm_dpt(device, mark)
    if "vlm" not in skip:
        warm_vlm(params, cfg, device, mark, max_seq)
    _sync(device)
    return {"build": libs, "stages": mark.done,
            "seconds": time.perf_counter() - mark.t0,
            "launches": {k: w.launches - before[k]
                         for k, w in wrappers.items()}}
