"""Run the full assistant loop with mock hardware and tiny random models.

The complete system — camera/mic/IMU workers, vision pipeline, audio
state machine, cortex, LLM with grammar-constrained tools, TTS — wired
exactly as production, with test-scale weights from a seed. Swap in
converted checkpoints for real behavior.

Port of ``examples/run_assistant.py`` (the JAX CLI's ``demo``), with its
tiny configs. It runs on the CUDA card unless the CPU is asked for:

    python -m trackiellm_tpu_torch demo [seconds] [--device D]
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from trackiellm_tpu_torch.app import AppSources, TrackieApp
from trackiellm_tpu_torch.audio.asr import WhisperASR
from trackiellm_tpu_torch.audio.tts_engine import TTSEngine
from trackiellm_tpu_torch.audio.wake_word import (PhraseWakeWord,
                                                  load_default_wake_word)
from trackiellm_tpu_torch.llm.runner import GenerationConfig, LLMRunner
from trackiellm_tpu_torch.llm.tokenizer import ByteTokenizer
from trackiellm_tpu_torch.models import depth as depth_model
from trackiellm_tpu_torch.models import detector as det_model
from trackiellm_tpu_torch.models import llm as llm_model
from trackiellm_tpu_torch.models import tts as tts_model
from trackiellm_tpu_torch.models import whisper as whisper_model
from trackiellm_tpu_torch.models.vad import EnergyVAD
from trackiellm_tpu_torch.utils.config import Config


def _wake_fn(device: torch.device, out: Callable[[str], None]):
    """The bundled pretrained conv spotter (real keyword detection out
    of the box); energy fallback only if the artifact is absent."""
    try:
        return load_default_wake_word(device=device)
    except FileNotFoundError:
        out("[wake] bundled artifact missing; using energy fallback")
        return PhraseWakeWord(consecutive=2)


def build_models(device: torch.device, seed: int = 0):
    """The example's tiny random models on ``device``: the detector, depth,
    Whisper, TTS and an f32 LLM."""
    gen = torch.Generator(device=device).manual_seed(seed)

    det_cfg = det_model.DetectorConfig.tiny()
    det_params = det_model.init_detector(gen, det_cfg)

    def detector_fn(chw):
        # Tiny config expects its own input size; crop/pad as demo glue.
        img = chw[:, :det_cfg.img_size, :det_cfg.img_size]
        return det_model.detector_forward(det_params, det_cfg, img)

    dep_cfg = depth_model.DepthConfig.tiny()
    dep_params = depth_model.init_depth(gen, dep_cfg)

    def depth_fn(chw):
        img = chw[:, :dep_cfg.img_size, :dep_cfg.img_size]
        return depth_model.depth_forward(dep_params, dep_cfg, img)

    asr_cfg = whisper_model.WhisperConfig.test()
    asr = WhisperASR(whisper_model.init_whisper(gen, asr_cfg), asr_cfg,
                     max_tokens=8)

    tts_cfg = tts_model.TTSConfig.tiny()
    tts = TTSEngine(tts_model.init_tts(gen, tts_cfg), tts_cfg)

    llm_cfg = llm_model.LLMConfig.tiny()
    runner = LLMRunner(
        llm_model.init_params(gen, llm_cfg, dtype=torch.float32,
                              device=device), llm_cfg,
        ByteTokenizer(llm_cfg.vocab_size),
        GenerationConfig(max_tokens=32, temperature=0.8))
    return detector_fn, depth_fn, asr, tts, runner


# How long past its ``seconds`` a run may wait for ``until``.
UNTIL_DEADLINE_S = 60.0


def run(seconds: float, device: torch.device,
        out: Callable[[str], None] = print,
        until: Optional[Callable[[TrackieApp], bool]] = None) -> TrackieApp:
    """Run the assistant for ``seconds`` on mock hardware; a typed question
    is injected halfway. With ``until``, the end waits, at most
    UNTIL_DEADLINE_S more, until ``until(app)`` holds: on a loaded CPU one
    frame pass of the tiny models can take most of a second, so a short
    run may stop before the event a caller checks for. Returns the
    stopped app (its stats stay)."""
    detector_fn, depth_fn, asr, tts, runner = build_models(device)

    cfg = Config()
    cfg.set("audio.vad_threshold", 0.5)
    app = TrackieApp(
        config=cfg,
        sources=AppSources(),  # all mock hardware
        detector_fn=detector_fn,
        depth_fn=depth_fn,
        vad_fn=EnergyVAD(1e-3),
        asr_fn=asr,
        tts_fn=tts,
        wake_fn=_wake_fn(device, out),
        llm_runner=runner,
        on_spoken_audio=lambda wav, p: out(
            f"[tts] {len(wav)} samples at priority {p}"),
        device=device,
    )
    app.start()
    out(f"assistant running for {seconds:.0f}s on {device} "
        f"(workers: {app.tasks.status()})")
    # Simulate a typed user question mid-run.
    time.sleep(seconds / 2)
    app.cortex.inject_user_text("o que você vê?")
    time.sleep(seconds / 2)
    if until is not None:
        end = time.monotonic() + UNTIL_DEADLINE_S
        while not until(app) and time.monotonic() < end:
            time.sleep(0.02)
    out(f"cortex stats: {app.cortex.stats}")
    out(f"scheduler stats: {app.scheduler.stats}")
    out("context:\n" + app.cortex.reasoner.generate_context_string())
    app.stop()
    return app
