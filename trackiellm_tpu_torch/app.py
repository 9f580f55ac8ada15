"""Application assembly: the framework's ``main()``.

Parity target: the Rust binary entry (reference: src/main.rs:37-127):
create TaskManager + EventBus + MemoryManager, build the subsystems,
spawn the vision/audio/cortex/sensor workers, shut down on signal with a
10 s join timeout. ``TK_MOCK_SENSORS`` parity: with no real hardware
sources the app runs end-to-end on mock camera/mic/IMU.

Port of ``trackiellm_tpu/app.py``, wired line for line. The app runs on
``device`` (the CUDA card unless the CPU is given): the vision pipeline,
the navigation engine and the camera worker's frame uploads live there.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Callable, Dict, Optional

from trackiellm_tpu_torch.audio.pipeline import AudioPipeline, AudioPipelineConfig
from trackiellm_tpu_torch.cortex.main import Cortex, CortexConfig, CortexState
from trackiellm_tpu_torch.cortex.memory import MemoryManager
from trackiellm_tpu_torch.navigation.path_planner import NavigationEngine
from trackiellm_tpu_torch.ops.backend import default_device
from trackiellm_tpu_torch.runtime.event_bus import EventBus, EventKind
from trackiellm_tpu_torch.runtime.scheduler import InferenceScheduler, JobKind
from trackiellm_tpu_torch.runtime.tasks import TaskManager
from trackiellm_tpu_torch.runtime.watchdog import Watchdog
from trackiellm_tpu_torch.runtime import workers as w
from trackiellm_tpu_torch.sensors.fusion import SensorFusion
from trackiellm_tpu_torch.utils.config import Config
from trackiellm_tpu_torch.utils.logging import get_logger
from trackiellm_tpu_torch.vision.pipeline import VisionPipeline

log = get_logger("app")


@dataclasses.dataclass
class AppSources:
    """Hardware sources; None -> mock (TK_MOCK_SENSORS parity)."""

    camera: Optional[Callable] = None
    microphone: Optional[Callable] = None
    imu: Optional[Callable] = None


class _ScheduledVision:
    """Routes a whole VisionPipeline frame pass through the shared
    scheduler as ONE VISION-priority job (the model calls inside run
    unwrapped). Attribute access falls through to the pipeline."""

    def __init__(self, run_or_skip: Callable, pipeline: VisionPipeline):
        self._run_or_skip = run_or_skip  # the scheduler's, counted
        self._pipe = pipeline

    def process_frame(self, frame, *args, **kwargs):
        # run_or_skip: during conversation focus the tick is rejected
        # at admission (returns None) instead of blocking the calling
        # cortex thread behind the focus window.
        from trackiellm_tpu_torch.runtime.scheduler import SKIPPED

        out = self._run_or_skip(JobKind.VISION, self._pipe.process_frame,
                                frame, *args, **kwargs)
        return None if out is SKIPPED else out

    def __getattr__(self, name):
        return getattr(self._pipe, name)


class _CountedLLM:
    """The LLM runner as the cortex sees it: ``generate`` and ``prime``
    counted (``TrackieApp._counted``), everything else falling through."""

    def __init__(self, runner, counted: Callable[[str, Callable], Callable]):
        self._runner = runner
        self._counted = counted

    def __getattr__(self, name):
        attr = getattr(self._runner, name)
        if name in ("generate", "prime"):
            return self._counted(f"llm.{name}", attr)
        return attr


class TrackieApp:
    """Full-system assembly. Model backends are injected (real models in
    production, stubs in tests — the wiring is identical)."""

    def __init__(
        self,
        config: Optional[Config] = None,
        sources: Optional[AppSources] = None,
        detector_fn=None, depth_fn=None, ocr_fn=None, barcode_fn=None,
        vad_fn=None, asr_fn=None, tts_fn=None, wake_fn=None, sound_fn=None,
        tts_stream_fn=None, embed_fn=None,
        streaming_asr=False,
        llm_runner=None,
        on_spoken_audio: Optional[Callable] = None,
        on_speech_end: Optional[Callable] = None,
        device=None,
    ):
        cfg = config or Config()
        self.device = default_device(device, "build a TrackieApp")
        # The copied audio pipeline logs a failed ASR or TTS job and goes
        # on, the copied cortex a failed LLM call: on the card such an
        # error is a device fault, so every model call below (a scheduler
        # job, with its completion barrier, or an LLM call) is counted
        # here when it raises ("<where>: <error>" -> calls), for
        # failures().
        self.faults: Dict[str, int] = {}
        self._faults_lock = threading.Lock()
        self.bus = EventBus(capacity=cfg.get_int("bus.capacity", 256))
        self.tasks = TaskManager()
        # Conversation focus (scheduler.focus): every conversational
        # signal below refreshes a window during which passive vision is
        # deferred (staleness-bounded), so the reply path never queues
        # behind an in-flight frame pass. The JAX package measured this
        # contention on its TPU (tools/measure_app_e2e.py); the card's
        # own numbers come from tools/measure_app_e2e.py in this package.
        self.scheduler = InferenceScheduler(
            focus_max_stale_s=cfg.get_float("scheduler.focus_stale_s",
                                            2.0))
        # Optional semantic memory (models/embedder.Embedder.embed):
        # retrieval becomes cosine similarity; embedding runs as an
        # OTHER-priority job so it never contends with the reply path.
        embed_run = self._counted("embed", self.scheduler.run)
        self.memory = MemoryManager(
            store_path=cfg.get_string("memory.path", "") or None,
            embed_fn=(None if embed_fn is None else
                      (lambda texts: embed_run(JobKind.OTHER, embed_fn,
                                               texts))))
        self.sensors = SensorFusion()
        self.navigation = NavigationEngine(device=self.device)

        # All model calls route through the shared per-chip scheduler so
        # modalities contend by priority, not by thread timing
        # (BASELINE.json north star: one batched inference scheduler).
        sched = self.scheduler

        def _via(kind: JobKind, fn):
            if fn is None:
                return None
            run = self._counted(kind.value, sched.run)
            return lambda *a, **k: run(kind, fn, *a, **k)

        # Vision model calls are NOT individually scheduler-wrapped: the
        # whole per-frame pipeline pass runs as ONE VISION job (below),
        # so a frame pays one queue wait instead of 2-3 (the JAX package
        # measured per-model wrapping as scheduler wait on every model
        # call of a frame).
        asr_fn = _via(JobKind.ASR, asr_fn)
        tts_fn = _via(JobKind.TTS, tts_fn)
        if tts_stream_fn is not None:
            # Stream chunks through the scheduler one pull at a time so
            # a long synthesis can't hog the device launch queue: the
            # generator is created inline, each chunk fetch is its own
            # TTS-priority job.
            inner_stream = tts_stream_fn
            run_tts = self._counted("tts", sched.run)

            def tts_stream_fn(text):
                gen = run_tts(JobKind.TTS, lambda: iter(inner_stream(text)))
                sentinel = object()
                while True:
                    chunk = run_tts(JobKind.TTS, next, gen, sentinel)
                    if chunk is sentinel:
                        return
                    yield chunk

        # The navigation engine rides the vision pipeline's depth maps
        # (NAVIGATION analysis flag); the cortex then reads its hazards.
        # QR detection (vision/qr.py finder-pattern detector) defaults
        # ON whenever OCR runs — the tk_text_recognition.cpp:103-104
        # hook surface; vision.qr_detection=false disables it.
        if (barcode_fn is None
                and cfg.get_bool("vision.qr_detection", True)):
            from trackiellm_tpu_torch.vision.qr import QRFinderDetector

            barcode_fn = QRFinderDetector()
        self.vision_pipeline = (
            VisionPipeline(detector_fn, depth_fn, ocr_fn,
                           barcode_fn=barcode_fn,
                           navigation_engine=self.navigation,
                           device=self.device)
            if detector_fn else None)
        self.vision = (_ScheduledVision(
            self._counted("vision", sched.run_or_skip), self.vision_pipeline)
                       if self.vision_pipeline else None)

        self._spoken = on_spoken_audio
        self.audio = AudioPipeline(
            config=AudioPipelineConfig(
                chunk_ms=cfg.get_int("audio.chunk_ms", 100),
                vad_threshold=cfg.get_float("audio.vad_threshold", 0.8),
                end_of_speech_silence_ms=cfg.get_int(
                    "audio.silence_ms", 500),
                endpoint_anticipation_ms=cfg.get_int(
                    "audio.endpoint_anticipation_ms", 150),
                wake_word_enabled=cfg.get_bool("audio.wake_word", True),
            ),
            vad_fn=vad_fn, asr_fn=asr_fn, tts_fn=tts_fn,
            tts_stream_fn=tts_stream_fn,
            wake_fn=wake_fn, sound_fn=sound_fn,
            streaming_asr=self._build_streaming_asr(streaming_asr, asr_fn),
            on_transcription=self._on_transcription,
            on_sound=self._on_sound,
            on_tts_audio=self._on_tts_audio,
            # A command utterance has begun: hold conversation focus
            # for its expected span (refreshed by later signals).
            on_speech_start=lambda: sched.focus(5.0),
            # End-of-speech decision instant (the e2e latency metric's
            # t0) — exposed so operators can time the production path.
            on_speech_end=self._wrap_speech_end(on_speech_end),
            # Partial stable transcripts go straight to the cortex so
            # it can prime the LLM mid-utterance (the cortex exists by
            # the time audio flows; capture is deferred via self).
            on_partial_transcription=lambda t: (
                sched.focus(3.0),
                self.cortex.inject_partial_transcript(t))[-1],
        )

        self.cortex = Cortex(
            config=CortexConfig(
                main_loop_hz=cfg.get_float("cortex.loop_hz", 10.0)),
            vision_pipeline=self.vision,
            audio_pipeline=self.audio,
            navigation_engine=self.navigation,
            sensor_fusion=self.sensors,
            llm_runner=(None if llm_runner is None
                        else _CountedLLM(llm_runner, self._counted)),
            memory=self.memory,
        )

        self.watchdog = Watchdog(self.tasks)
        self.sources = sources or AppSources()
        self._started = False

    @staticmethod
    def _build_streaming_asr(streaming_asr, asr_fn):
        """streaming_asr=True builds a LocalAgreement transcriber over
        the (scheduler-routed) ASR; a ready StreamingTranscriber passes
        through; False/None disables partials."""
        if not streaming_asr or asr_fn is None:
            return None
        if streaming_asr is True:
            from trackiellm_tpu_torch.audio.streaming_asr import (
                StreamingTranscriber)

            return StreamingTranscriber(asr_fn)
        return streaming_asr

    def _wrap_speech_end(self, ext: Optional[Callable]) -> Callable:
        def on_end():
            self.scheduler.focus(3.0)  # covers ASR + LLM + first TTS
            if ext:
                ext()
        return on_end

    def _counted(self, where: str, fn: Callable) -> Callable:
        """``fn``, with each error it raises counted in ``faults`` before
        it goes on to the caller."""
        @functools.wraps(fn, updated=())
        def call(*args, **kwargs):
            try:
                return fn(*args, **kwargs)
            except Exception as e:
                key = f"{where}: {e!r}"
                with self._faults_lock:
                    self.faults[key] = self.faults.get(key, 0) + 1
                raise
        return call

    def failures(self) -> Dict[str, object]:
        """Every failure the running app absorbed, by source; empty when
        none did. The demo and measure_app_e2e fail on any: crashed or
        restarted workers, a cortex halted in FATAL_ERROR, model calls
        (ASR, TTS, vision frames, the LLM) that raised, and vision stages
        that degraded a frame."""
        out: Dict[str, object] = {
            f"worker {k}": repr(v) for k, v in self.tasks.errors().items()}
        out.update({f"gave up on {k}": v
                    for k, v in self.watchdog.gave_up.items()})
        if self.watchdog.restarts:
            out["restarts"] = dict(self.watchdog.restarts)
        if self.cortex.state is CortexState.FATAL_ERROR:
            out["cortex"] = "FATAL_ERROR"
        with self._faults_lock:
            if self.faults:
                out["model calls"] = dict(self.faults)
        if self.vision_pipeline and self.vision_pipeline.stage_failures:
            out["vision stages"] = dict(self.vision_pipeline.stage_failures)
        return out

    # -- bus glue -----------------------------------------------------------
    def _on_transcription(self, text: str) -> None:
        self.scheduler.focus(3.0)
        self.bus.publish(EventKind.TRANSCRIPTION_RESULT, text)
        self.cortex.inject_user_text(text)

    def _on_sound(self, name: str) -> None:
        self.bus.publish(EventKind.AMBIENT_SOUND, name)
        self.cortex.inject_ambient_sound(name)

    def _on_tts_audio(self, wav, priority) -> None:
        self.scheduler.focus(1.5)  # rides playback to the last chunk
        self.bus.publish(EventKind.SPEAK, {"samples": len(wav),
                                           "priority": int(priority)})
        if self._spoken:
            self._spoken(wav, priority)

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> None:
        assert not self._started
        self._started = True
        self.cortex.run()
        camera = self.sources.camera or w.mock_camera_source()
        mic = self.sources.microphone or w.mock_microphone_source()
        imu = self.sources.imu or w.mock_imu_source()
        if self.vision is not None:
            self.tasks.spawn("vision", lambda stop: w.vision_worker(
                stop, self.cortex, camera, self.bus,
                fps=self.cortex.config.main_loop_hz, device=self.device))
        self.tasks.spawn("audio", lambda stop: w.audio_worker(
            stop, self.cortex, mic,
            chunk_ms=self.audio.config.chunk_ms))
        self.tasks.spawn("sensors", lambda stop: w.sensor_worker(
            stop, self.sensors, imu, self.cortex, self.bus))
        self.watchdog.start()
        log.info("TrackieApp started: %s", self.tasks.status())

    def stop(self, timeout: float = 10.0) -> None:
        self.watchdog.stop()
        stragglers = self.tasks.join_all(timeout=timeout)
        if stragglers:
            log.warning("workers did not stop in time: %s", stragglers)
        self.cortex.stop()
        self.audio.close()
        self.scheduler.close()
        self.bus.shutdown()
        self._started = False
