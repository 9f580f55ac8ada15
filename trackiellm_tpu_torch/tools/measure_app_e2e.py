"""The product's own latency, end of speech to first spoken audio, through
the port's ``TrackieApp`` wiring on the card.

Twin of the JAX package's ``tools/measure_app_e2e.py``, with its method.
What runs is exactly what ``trackiellm_tpu_torch.app.TrackieApp`` ships:
  - the vision worker's continuous 10 Hz camera loop, each frame uploaded
    to the card as it is captured (runtime/workers.py), one scheduler job
    a frame;
  - the audio worker feeding 100 ms mic chunks through the VAD state
    machine (audio/pipeline.py);
  - streaming ASR priming the LLM mid-utterance
    (audio/streaming_asr.py -> Cortex.inject_partial_transcript);
  - end of speech -> authoritative ASR pass -> cortex event ->
    Cortex._process_user_speech -> LLMRunner.generate (k-token lookahead)
    -> sentence streamer -> streaming TTS first chunk.

t0 = the audio pipeline's end-of-speech DECISION (on_speech_end — the
VAD's silence-threshold instant, before ASR). First audio = the first
on_spoken_audio callback after t0; first reply audio = the first of the
reply's own priority. Everything upstream (vision ticks, primes) runs
continuously like production; nothing is pre-staged by the measurement.

Models are full-size (YOLOv8n 640 + MiDaS-small 384 + Whisper-tiny at
n_audio_ctx 500 + Mistral-7B Q4 at max_seq 1024 + the default TTS,
streamed) with random weights from ``--seed`` (by default from the clock;
latency does not depend on the weights). One JSON line, after the card's
name and power limit:

    python -m trackiellm_tpu_torch.tools.measure_app_e2e [--runs 5]
        [--seed S] [--device D]

Run 0 is a warm-up. A run that never reaches reply audio is counted in
``incomplete`` and left out of the medians. Any failure the app absorbed
(``TrackieApp.failures``: a job, LLM call or vision stage that raised, a
crashed worker) is listed under ``failures`` and makes the tool exit 1.
Without a card it raises, unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from trackiellm_tpu_torch.app import AppSources, TrackieApp
from trackiellm_tpu_torch.audio.asr import WhisperASR
from trackiellm_tpu_torch.llm.runner import GenerationConfig, LLMRunner
from trackiellm_tpu_torch.llm.tokenizer import ByteTokenizer
from trackiellm_tpu_torch.models import depth as depth_model
from trackiellm_tpu_torch.models import detector as det_model
from trackiellm_tpu_torch.models import llm as llm_model
from trackiellm_tpu_torch.models import tts as tts_model
from trackiellm_tpu_torch.models import whisper as whisper_model
from trackiellm_tpu_torch.models.vad import EnergyVAD
from trackiellm_tpu_torch.ops import kernel_wrappers
from trackiellm_tpu_torch.ops.backend import default_device
from trackiellm_tpu_torch.utils.config import Config

SR = 16_000
CHUNK = SR // 10            # 100 ms
SPEECH_SECONDS = 3.0
RUNS = 5
N_ANSWER_TOKENS = 12
WARM_TIMEOUT_S = 900.0      # run 0: first launches, cuDNN and cuBLAS setup
RUN_TIMEOUT_S = 120.0
QUERY = "o que ha na minha frente?"


def full_size() -> Dict[str, object]:
    """The reference tool's models and frame."""
    return {
        "detector": det_model.DetectorConfig.v8n(),
        "depth": depth_model.DepthConfig.small(),
        "asr": whisper_model.WhisperConfig.tiny()._replace(n_audio_ctx=500),
        "llm": llm_model.LLMConfig.mistral_7b()._replace(
            max_seq=1024, sliding_window=1024),
        "llm_group": 256,
        "tts": tts_model.TTSConfig.default(),
        "frame": (480, 640),
    }


class ScriptedTextTokenizer(ByteTokenizer):
    """ByteTokenizer whose *generated-token* text is a scripted
    Portuguese reply: random weights decode to unspeakable byte soup,
    which would silence the TTS leg of the measurement. Device-side
    decode is untouched; only the emitted id -> text mapping is scripted,
    so the sentence streamer and TTS run on realistic text (the first
    sentence closes at token 8)."""

    WORDS = ("ha", " uma", " mesa", " grande", " perto", " da", " sua",
             " frente.", " o", " caminho", " esta", " livre.")

    def __init__(self, vocab_size):
        super().__init__(vocab_size)
        self._emit_i = 0

    def decode_token(self, tid):
        word = self.WORDS[self._emit_i % len(self.WORDS)]
        self._emit_i += 1
        return word

    @property
    def token_bytes(self):
        # Hide ByteTokenizer's byte-level surface: the runner's
        # incremental UTF-8 assembler prefers token_bytes when present,
        # which would decode the byte soup instead of the scripted words.
        raise AttributeError("scripted tokenizer decodes via decode_token")


class ScriptedMic:
    """Real-time mic: loud (speech) chunks for ``speech_s``, then silence.
    ``arm()`` starts the next utterance; between utterances it yields
    silence."""

    def __init__(self, rng, speech_s: float = SPEECH_SECONDS):
        self._rng = rng
        self._speech_chunks = int(speech_s * 10)
        self._remaining = 0
        self._lock = threading.Lock()

    def arm(self):
        with self._lock:
            self._remaining = self._speech_chunks

    def read(self):
        with self._lock:
            speaking = self._remaining > 0
            if speaking:
                self._remaining -= 1
        if speaking:
            return (0.3 * self._rng.standard_normal(CHUNK)).astype(
                np.float32)
        return np.zeros(CHUNK, np.float32)


def _trace(name: str, fn: Callable, log) -> Callable:
    def wrapped(*a, **k):
        head = repr(a[0])[:60] if a else ""
        log(f"[tr {time.strftime('%H:%M:%S')}] {name} {head}")
        out = fn(*a, **k)
        log(f"[tr {time.strftime('%H:%M:%S')}] {name} done")
        return out
    return wrapped


def measure(device: torch.device, runs: int = RUNS, seed: int = 0,
            sizes: Optional[Dict[str, object]] = None,
            speech_s: float = SPEECH_SECONDS,
            warm_timeout_s: float = WARM_TIMEOUT_S,
            run_timeout_s: float = RUN_TIMEOUT_S,
            log: Optional[Callable[[str], None]] = None) -> dict:
    """Build the models on ``device``, start the app, and time ``runs``
    utterances after a warm one. Returns the JSON line's fields."""
    sizes = sizes or full_size()
    if log is None:
        def log(msg):
            print(msg, file=sys.stderr, flush=True)
    gen = torch.Generator(device=device).manual_seed(seed)
    mic_rng = np.random.default_rng(seed)
    cam_rng = np.random.default_rng(seed + 1)

    log("building the models...")
    det_cfg, dep_cfg = sizes["detector"], sizes["depth"]
    det_params = det_model.init_detector(gen, det_cfg)
    dep_params = depth_model.init_depth(gen, dep_cfg)
    asr_cfg = sizes["asr"]
    asr = WhisperASR(whisper_model.init_whisper(gen, asr_cfg), asr_cfg,
                     max_tokens=16)
    llm_cfg = sizes["llm"]
    llm_params = llm_model.init_params_quantized(
        gen, llm_cfg, bits=4, group=sizes["llm_group"], device=device)
    # min_tokens == max_tokens: random weights greedy-decode straight
    # into EOS, so the floor forces the full representative decode.
    runner = LLMRunner(llm_params, llm_cfg,
                       ScriptedTextTokenizer(llm_cfg.vocab_size),
                       GenerationConfig(max_tokens=N_ANSWER_TOKENS,
                                        min_tokens=N_ANSWER_TOKENS,
                                        temperature=0.0, lookahead=4))
    tts_cfg = sizes["tts"]
    tts_params = tts_model.init_tts(gen, tts_cfg)
    vad = EnergyVAD(energy_threshold=0.01)
    mic = ScriptedMic(mic_rng, speech_s)
    frame_hw = sizes["frame"]

    def camera():
        # Fresh frame every tick so nothing can replay.
        return cam_rng.integers(0, 255, (*frame_hw, 3), dtype=np.uint8)

    marks = {"t0": None, "first_audio": None, "first_reply": None,
             "asr_done": None}
    mlock = threading.Lock()

    def on_speech_end():
        log(f"[ev {time.strftime('%H:%M:%S')}] speech_end")
        with mlock:
            if marks["t0"] is None:
                marks["t0"] = time.perf_counter()

    def on_spoken(wav, priority):
        log(f"[ev {time.strftime('%H:%M:%S')}] audio prio={int(priority)} "
            f"n={len(wav)}")
        # priority NORMAL(1) = the LLM reply's sentence stream; CRITICAL =
        # safety alerts from the world model (not the reply metric).
        with mlock:
            if marks["t0"] is not None:
                if marks["first_audio"] is None:
                    marks["first_audio"] = time.perf_counter()
                if marks["first_reply"] is None and int(priority) <= 1:
                    marks["first_reply"] = time.perf_counter()

    cfg = Config()
    cfg.set("audio.wake_word", "false")
    cfg.set("audio.vad_threshold", "0.5")
    cfg.set("audio.silence_ms", "300")

    app = TrackieApp(
        config=cfg,
        sources=AppSources(microphone=mic.read, camera=camera),
        detector_fn=lambda chw: det_model.detector_forward(
            det_params, det_cfg, chw),
        depth_fn=lambda chw: depth_model.depth_forward(
            dep_params, dep_cfg, chw),
        vad_fn=lambda chunk: vad(chunk),
        # The REAL ASR pass runs (its latency is the point); its random-
        # weight text is discarded for a fixed query so the LLM turn
        # always happens and streaming partials are true prefixes of the
        # final transcript.
        asr_fn=lambda audio: (asr.transcribe(audio), QUERY)[1],
        tts_stream_fn=lambda text: tts_model.synthesize_streaming(
            tts_params, tts_cfg, text),
        streaming_asr=True,
        llm_runner=runner,
        on_spoken_audio=on_spoken,
        on_speech_end=on_speech_end,
        device=device,
    )
    inner_transcription = app._on_transcription

    def on_transcription(text):
        with mlock:
            if marks["asr_done"] is None and marks["t0"] is not None:
                marks["asr_done"] = time.perf_counter()
        inner_transcription(text)

    app.audio._cb["on_transcription"] = on_transcription
    # Random-weight YOLO sees random "obstacles" in noise frames, and the
    # resulting alerts outrank reply audio in the TTS queue (by design —
    # safety first); with real weights an empty scene raises none, so the
    # safety rules are muted for the latency metric.
    app.cortex.world.run_safety_rules = lambda *a, **k: []
    app.cortex.world.run_navigation_rules = lambda *a, **k: []
    app.cortex._speak = _trace("speak", app.cortex._speak, log)
    app.cortex.decisions.process_llm_response = _trace(
        "decide", app.cortex.decisions.process_llm_response, log)
    app.cortex._process_user_speech = _trace(
        "user_speech", app.cortex._process_user_speech, log)

    # Warm the TTS before the loop starts, as the reference does.
    log("warming the TTS...")
    for text in ("ha uma mesa a frente.",
                 "ha uma cadeira e uma pessoa perto da porta da sala."):
        for _ in tts_model.synthesize_streaming(tts_params, tts_cfg, text):
            pass

    counters = kernel_wrappers()
    for fn in counters.values():
        fn.launches = 0
    results, incomplete = [], 0
    app.start()
    try:
        for run in range(runs + 1):  # run 0 = warm-up
            with mlock:
                marks["t0"] = marks["first_audio"] = None
                marks["first_reply"] = marks["asr_done"] = None
            mic.arm()
            deadline = time.monotonic() + (warm_timeout_s if run == 0
                                           else run_timeout_s)
            while time.monotonic() < deadline:
                with mlock:
                    if marks["first_reply"] is not None:
                        break
                time.sleep(0.02)
            with mlock:
                t0, fa, fr, ad = (marks["t0"], marks["first_audio"],
                                  marks["first_reply"], marks["asr_done"])
            if t0 is None or fr is None:
                log(f"run {run}: INCOMPLETE (t0={t0} reply={fr})")
                incomplete += 1
                continue
            row = {"first_reply_ms": (fr - t0) * 1e3,
                   "first_any_audio_ms": (fa - t0) * 1e3,
                   "transcript_ms": ((ad - t0) * 1e3) if ad else None}
            log(f"run {run}: {row}")
            if run > 0:
                results.append(row)
            # Let the reply finish + queues drain before the next run.
            app.audio.wait_idle(timeout=60)
            time.sleep(1.0)
    finally:
        app.stop(timeout=30.0)
    launches = {k: fn.launches for k, fn in counters.items()}

    out = {
        "config": "TrackieApp loop: end-of-speech -> first audio",
        "device": str(device), "seed": seed, "runs": runs,
        "incomplete": incomplete, "launches": launches,
        "scheduler_stats": app.scheduler.stats,
        "cortex_stats": dict(app.cortex.stats),
        "failures": app.failures(),
    }
    if results:
        tr = [r["transcript_ms"] for r in results if r["transcript_ms"]]
        out.update({
            "p50_first_reply_audio_ms": statistics.median(
                r["first_reply_ms"] for r in results),
            "p50_first_any_audio_ms": statistics.median(
                r["first_any_audio_ms"] for r in results),
            "p50_transcript_ms": statistics.median(tr) if tr else None,
            "runs_ms": [r["first_reply_ms"] for r in results]})
    if out["failures"]:
        out["error"] = "the app absorbed failures"
    elif not results:
        out["error"] = "no complete runs"
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="measure_app_e2e")
    ap.add_argument("--runs", type=int, default=RUNS)
    ap.add_argument("--seed", type=int, default=None,
                    help="weights' and inputs' seed (default: the clock)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; the CPU "
                         "only when asked for with --device cpu)")
    args = ap.parse_args(argv)
    dev = default_device(args.device, "measure the app loop")
    seed = (int(time.time()) & 0x7FFFFFFF if args.seed is None
            else args.seed)
    card = None
    if dev.type == "cuda":
        from trackiellm_tpu_torch.tools import card as smi
        card = smi()
        print(card, flush=True)
    res = measure(dev, runs=args.runs, seed=seed)
    print(json.dumps({**res, "card": card}), flush=True)
    return 0 if "error" not in res else 1


if __name__ == "__main__":
    sys.exit(main())
