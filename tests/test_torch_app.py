"""The port's app loop on the CPU: ``TrackieApp`` end to end with stub
models that return torch tensors (twins of tests/test_e2e.py), the
``demo`` command, the ``measure_app_e2e`` tool at tiny widths, and the
framework-free modules the port copies from the JAX package, held to the
reference's source.

Every threaded test waits with a deadline of 10 s or less and stops the app
with a timeout.
"""

import difflib
import os
import time

import numpy as np
import pytest
import torch

from trackiellm_tpu_torch.app import AppSources, TrackieApp
from trackiellm_tpu_torch.audio.wake_word import PhraseWakeWord
from trackiellm_tpu_torch.models.vad import EnergyVAD
from trackiellm_tpu_torch.runtime.event_bus import EventKind
from trackiellm_tpu_torch.utils.config import Config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SR = 16_000
CHUNK = 1600  # logical 100 ms
DEADLINE_S = 10.0

# Modules the port copies whole: the JAX package's source with
# "trackiellm_tpu" read as "trackiellm_tpu_torch". Each maps the port's
# lines allowed to differ, each replacing one line of the reference, to
# the reason.
COPIES = {
    "utils/config.py": {}, "utils/paths.py": {},
    "runtime/event_bus.py": {}, "runtime/tasks.py": {},
    "runtime/watchdog.py": {},
    "interaction/__init__.py": {}, "interaction/commands.py": {},
    "interaction/feedback.py": {},
    "sensors/__init__.py": {}, "sensors/filters.py": {},
    "sensors/fusion.py": {},
    "cortex/__init__.py": {}, "cortex/reasoner.py": {},
    "cortex/decision.py": {},
    "cortex/memory.py": dict.fromkeys((
        "            emb = self._embed_fn([text]).tolist()[0]",
        "        vecs = self._embed_fn([f.text for f in missing]).tolist()",
        "            qv = np.asarray(self._embed_fn([query]).tolist()[0], "
        "np.float32)"),
        "an embed_fn's rows come back in one fetch whether it returns a "
        "host array or a card tensor (Embedder.embed returns numpy; a card "
        "tensor has no numpy view, and a fetch per element syncs per "
        "element); the values and the ranking are the reference's"),
    "cortex/world_model.py": {}, "cortex/main.py": {},
    "navigation/obstacle_tracker.py": {},
    "vision/qr.py": {
        "(reference: src/vision/tk_text_recognition.cpp:103-104 \u2014 hooks":
        "cites the reference's file by its path in the reference tree, as "
        "the other modules do, not by a checkout's absolute path"},
    "vision/qr_decode.py": {},
    "audio/pipeline.py": {},
}


@pytest.mark.parametrize("path", sorted(COPIES))
def test_copied_module_is_the_reference(path):
    with open(os.path.join(ROOT, "trackiellm_tpu", path),
              encoding="utf-8") as f:
        want = f.read().replace("trackiellm_tpu", "trackiellm_tpu_torch")
    with open(os.path.join(ROOT, "trackiellm_tpu_torch", path),
              encoding="utf-8") as f:
        got = f.read()
    diff = [line for line in difflib.unified_diff(
        want.splitlines(), got.splitlines(), lineterm="", n=0)
        if line[:3] not in ("+++", "---")]
    added = [line[1:] for line in diff if line[:1] == "+"]
    removed = [line for line in diff if line[:1] == "-"]
    assert [a for a in added if a not in COPIES[path]] == []
    assert len(removed) == len(added)


def _scripted_mic(script):
    """script: list of ('loud'|'quiet', n_chunks)."""
    chunks = []
    rng = np.random.default_rng(0)
    for kind, n in script:
        for _ in range(n):
            if kind == "loud":
                chunks.append((0.3 * rng.standard_normal(CHUNK))
                              .astype(np.float32))
            else:
                chunks.append(np.zeros(CHUNK, np.float32))
    it = iter(chunks)

    def read():
        return next(it, np.zeros(CHUNK, np.float32))

    return read


def _stub_detector(chw):
    """Raw detector outputs as tensors on the frame's device: one "cup"."""
    boxes = torch.zeros((8, 4), device=chw.device)
    scores = torch.zeros((8, 80), device=chw.device)
    boxes[0] = torch.tensor([300.0, 280.0, 340.0, 320.0])
    scores[0, 41] = 0.9
    return boxes, scores


class StubLLM:
    def __init__(self):
        self.calls = 0

    def build_prompt(self, system, context, user, tools=()):
        return f"{context}\n{user}"

    def generate(self, prompt, tools=(), force_tool_call=False,
                 on_token=None):
        self.calls += 1
        return "Vejo uma xícara à sua frente."

    def add_tool_response(self, name, result):
        pass


def _wait(cond, timeout=DEADLINE_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not cond():
        time.sleep(0.05)


def test_voice_command_to_spoken_response():
    spoken = []
    llm = StubLLM()
    cfg = Config()
    cfg.set("audio.chunk_ms", 10)  # real-time acceleration
    cfg.set("cortex.loop_hz", 50.0)
    app = TrackieApp(
        config=cfg,
        sources=AppSources(microphone=_scripted_mic([
            ("quiet", 3), ("loud", 3), ("loud", 4), ("quiet", 7)])),
        detector_fn=_stub_detector,
        vad_fn=EnergyVAD(1e-3),
        asr_fn=lambda audio: "o que você vê?",
        tts_fn=lambda text: np.zeros(320, np.float32),
        wake_fn=PhraseWakeWord(consecutive=2, energy_threshold=0.01),
        llm_runner=llm,
        on_spoken_audio=lambda wav, p: spoken.append((len(wav), p)),
        device=CPU,
    )
    bus_sub = app.bus.subscribe()
    app.start()
    try:
        _wait(lambda: spoken and "cup" in
              app.cortex.reasoner.generate_context_string())
    finally:
        app.stop(timeout=5.0)
    assert llm.calls >= 1
    assert spoken, "no TTS audio reached the output"
    kinds = {e.kind for e in bus_sub.drain()}
    assert {EventKind.TRANSCRIPTION_RESULT, EventKind.SPEAK,
            EventKind.VISION_RESULT,
            EventKind.SENSOR_FUSION_RESULT} <= kinds
    assert "cup" in app.cortex.reasoner.generate_context_string()
    assert app.cortex.reasoner.get_summary()["turns"] >= 2
    assert app.scheduler.stats["vision"]["count"] >= 1
    assert app.tasks.errors() == {} and app.failures() == {}


def test_streaming_asr_partials_reach_the_cortex():
    spoken = []

    class PrimingStubLLM(StubLLM):
        def __init__(self):
            super().__init__()
            self.primed = []

        def prime(self, prefix):
            self.primed.append(prefix)

    llm = PrimingStubLLM()
    cfg = Config()
    cfg.set("audio.chunk_ms", 10)
    cfg.set("audio.wake_word", False)  # straight to listening
    cfg.set("cortex.loop_hz", 50.0)
    calls = {"n": 0}

    def scripted_asr(audio):
        calls["n"] += 1
        return ("o que voce ve agora" if len(audio) / SR >= 0.3
                else "o que voce")

    from trackiellm_tpu_torch.audio.streaming_asr import StreamingTranscriber

    app = TrackieApp(
        config=cfg,
        sources=AppSources(microphone=_scripted_mic([("loud", 12),
                                                     ("quiet", 7)])),
        vad_fn=EnergyVAD(1e-3),
        asr_fn=scripted_asr,
        streaming_asr=StreamingTranscriber(scripted_asr, refresh_s=0.2),
        tts_fn=lambda text: np.zeros(320, np.float32),
        llm_runner=llm,
        on_spoken_audio=lambda wav, p: spoken.append(len(wav)),
        device=CPU,
    )
    app.start()
    try:
        _wait(lambda: spoken)
    finally:
        app.stop(timeout=5.0)
    assert spoken, "no TTS audio reached the output"
    assert llm.calls >= 1
    assert llm.primed and llm.primed[-1].endswith("o que voce ve agora")
    assert app.cortex.stats.get("partial_primes", 0) >= 1
    assert calls["n"] >= 3


CUDA_FAULT = "CUDA error: an illegal memory access was encountered"


def _card_fault(*args, **kwargs):
    raise RuntimeError(CUDA_FAULT)


class FaultyLLM(StubLLM):
    def generate(self, prompt, tools=(), force_tool_call=False,
                 on_token=None):
        self.calls += 1
        _card_fault()


@pytest.mark.parametrize("where, source", [
    ("asr", "model calls"), ("tts", "model calls"), ("llm", "model calls"),
    ("depth", "vision stages")])
def test_a_failure_the_app_absorbs_stays_in_failures(where, source):
    """The copied audio pipeline logs a failed ASR or TTS job and goes on,
    the copied cortex a failed LLM call, the vision pipeline a failed
    stage: each failure stays counted in ``failures()``, with its error."""
    llm = FaultyLLM() if where == "llm" else StubLLM()
    cfg = Config()
    cfg.set("audio.chunk_ms", 10)
    cfg.set("audio.wake_word", False)
    cfg.set("cortex.loop_hz", 50.0)
    app = TrackieApp(
        config=cfg,
        sources=AppSources(microphone=_scripted_mic([
            ("quiet", 3), ("loud", 6), ("quiet", 7)])),
        detector_fn=_stub_detector,
        depth_fn=_card_fault if where == "depth" else None,
        vad_fn=EnergyVAD(1e-3),
        asr_fn=(_card_fault if where == "asr"
                else lambda audio: "o que você vê?"),
        tts_fn=(_card_fault if where == "tts"
                else lambda text: np.zeros(320, np.float32)),
        llm_runner=llm,
        device=CPU,
    )
    app.start()
    try:
        _wait(lambda: source in app.failures())
    finally:
        app.stop(timeout=5.0)
    failures = app.failures()
    assert CUDA_FAULT in str(failures[source]), failures
    prefix = ("llm.generate" if where == "llm" else where) + ": "
    assert all(k.startswith(prefix) for k in failures[source]), failures
    assert app.tasks.errors() == {}


def _demo_waits_for(monkeypatch, event):
    """Make the CLI's 1-s demo end only once ``event(app)`` holds (60-s
    deadline): on a loaded CPU one frame pass of the tiny models can take
    most of a second, so the run may stop before what a test checks."""
    from trackiellm_tpu_torch import demo
    real = demo.run
    monkeypatch.setattr(demo, "run", lambda seconds, device: real(
        seconds, device, until=event))


@pytest.mark.parametrize("where", ["tts", "llm"])
def test_demo_exits_1_on_a_failure_it_absorbed(monkeypatch, capsys, where):
    """A TTS job or an LLM call that raises (on the card: a device fault)
    fails the demo, though the app logged it and went on."""
    from trackiellm_tpu_torch import __main__ as cli
    from trackiellm_tpu_torch import demo
    real = demo.build_models

    def faulty(device, seed=0):
        det, dep, asr, tts, runner = real(device, seed)
        if where == "tts":
            tts = _card_fault
        else:
            runner.generate = _card_fault
        return det, dep, asr, tts, runner
    monkeypatch.setattr(demo, "build_models", faulty)
    source = "tts: " if where == "tts" else "llm.generate: "
    _demo_waits_for(monkeypatch, lambda app: any(
        k.startswith(source)
        for k in app.failures().get("model calls", {})))
    assert cli.main(["demo", "1", "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert "demo failed" in err and CUDA_FAULT in err


def test_clean_shutdown_under_load():
    app = TrackieApp(config=Config(), detector_fn=_stub_detector,
                     vad_fn=EnergyVAD(), asr_fn=lambda a: "",
                     tts_fn=lambda t: np.zeros(16, np.float32), device=CPU)
    app.start()
    time.sleep(0.3)
    app.stop(timeout=5.0)
    assert app.tasks.errors() == {}
    assert not any(app.tasks.status().values())


def test_frames_reach_the_pipeline_as_tensors_on_the_apps_device():
    """The camera worker uploads each frame; the cortex's vision tick hands
    that tensor (not the camera's array) to the pipeline, one scheduler
    job a frame."""
    seen = []

    def detector(chw):
        seen.append(chw.device)
        return _stub_detector(chw)
    app = TrackieApp(config=Config(), detector_fn=detector, device=CPU)
    assert app.vision_pipeline.device == CPU
    assert app.navigation.device == CPU
    app.start()
    try:
        _wait(lambda: app.cortex._frames and seen)
    finally:
        app.stop(timeout=5.0)
    frame = app.cortex._frames[-1]
    assert isinstance(frame, torch.Tensor) and frame.device == CPU
    assert seen and app.scheduler.stats["vision"]["count"] >= 1


def test_app_needs_a_card_or_the_cpu(monkeypatch):
    from trackiellm_tpu_torch.utils.errors import TrackieError
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(TrackieError, match="TrackieApp"):
        TrackieApp(config=Config())


def test_demo_on_the_cpu(monkeypatch, capsys):
    """``python -m trackiellm_tpu_torch demo 1 --device cpu`` in-process:
    exit 0, vision ran through the scheduler, the question was answered."""
    from trackiellm_tpu_torch import __main__ as cli
    _demo_waits_for(monkeypatch, lambda app: (
        "vision" in app.scheduler.stats
        and "Usuário: o que você vê?"
        in app.cortex.reasoner.generate_context_string()))
    assert cli.main(["demo", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "assistant running for 1s on cpu" in out
    assert "scheduler stats:" in out and "'vision'" in out
    assert "Usuário: o que você vê?" in out


def test_demo_without_a_card_asks_for_the_cpu(monkeypatch):
    from trackiellm_tpu_torch import __main__ as cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main(["demo", "1"])


def test_measure_app_e2e_at_tiny_widths():
    """The tool's measurement on the CPU at tiny widths (control flow
    only): every run reaches reply audio, the JSON fields are there, no
    kernel launches on the CPU."""
    import json

    from trackiellm_tpu_torch.models import depth, detector, llm, tts, whisper
    from trackiellm_tpu_torch.tools import measure_app_e2e as m
    sizes = {"detector": detector.DetectorConfig.tiny(),
             "depth": depth.DepthConfig.tiny(),
             "asr": whisper.WhisperConfig.test(), "llm": llm.LLMConfig.tiny(),
             "llm_group": 64, "tts": tts.TTSConfig.tiny(), "frame": (96, 128)}
    res = m.measure(CPU, runs=1, seed=3, sizes=sizes, speech_s=1.0,
                    warm_timeout_s=DEADLINE_S, run_timeout_s=DEADLINE_S,
                    log=lambda s: None)
    assert res["incomplete"] == 0 and len(res["runs_ms"]) == 1
    assert res["p50_first_reply_audio_ms"] > 0
    assert res["scheduler_stats"]["asr"]["count"] >= 1
    assert res["cortex_stats"]["last_llm_ms"] > 0
    assert not any(res["launches"].values()) and res["failures"] == {}
    assert "error" not in res
    json.dumps(res)


def test_measure_app_e2e_needs_a_card_or_the_cpu(monkeypatch):
    from trackiellm_tpu_torch.tools import measure_app_e2e as m
    from trackiellm_tpu_torch.utils.errors import TrackieError
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(TrackieError, match="measure the app loop"):
        m.main(["--runs", "1"])


def test_kernel_library_loads_once_across_threads(monkeypatch):
    """The app's threads may reach a first launch together: the kernel
    library is built and loaded once, and every thread gets that one."""
    import ctypes
    import threading
    import types

    from trackiellm_tpu_torch.ops import _build

    class FakeLib:
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn
    built = []

    def build():
        built.append(1)
        time.sleep(0.05)
        return _build.BUILD_ROOT / "fake.so"
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setattr(ctypes, "CDLL", lambda path: FakeLib())
    got = []
    threads = [threading.Thread(target=lambda: got.append(_build.library()))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=DEADLINE_S)
    assert len(built) == 1 and len(got) == 8
    assert all(lib is got[0] for lib in got)
