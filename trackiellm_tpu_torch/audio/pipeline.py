"""Streaming audio pipeline: wake word -> VAD -> ASR -> TTS state machine
with a priority-interrupting speech queue.

Parity target: the reference's audio pipeline (reference:
src/audio/tk_audio_pipeline.c):
  - state machine AWAITING_WAKE_WORD -> LISTENING_FOR_COMMAND ->
    TRANSCRIBING -> SYNTHESIZING (tk_audio_pipeline.h:61-67),
  - passive listening = wake word + ambient sound classifier (:481),
  - VAD gating with end-of-speech on 500 ms silence @ 0.8 prob
    (:611, tk_cortex_main.c:881-882),
  - ASR on end-of-speech (:660),
  - priority TTS queue where higher-priority speech interrupts lower
    (:837-1008), and direct `say` (:1027),
  - dedicated worker thread (:550).

TPU design: the state machine and buffers are host-side (control flow is
irregular); every model call (VAD step, ASR, sound class, TTS) is a
jitted device program behind an injected callable. A background worker
thread drains the TTS queue so synthesis overlaps listening.
"""

from __future__ import annotations

import dataclasses
import enum
import heapq
import itertools
import threading
import time
from typing import Callable, List, Optional

import numpy as np

from trackiellm_tpu_torch.utils.logging import get_logger

log = get_logger("audio.pipeline")


class AudioState(enum.Enum):
    """Parity: tk_audio_pipeline.h:61-67."""

    AWAITING_WAKE_WORD = "awaiting_wake_word"
    LISTENING_FOR_COMMAND = "listening_for_command"
    TRANSCRIBING = "transcribing"
    SYNTHESIZING = "synthesizing"


class TTSPriority(enum.IntEnum):
    """Parity: the decision-engine priority enum reused by the audio
    pipeline (tk_audio_pipeline.h:39)."""

    LOW = 0
    NORMAL = 1
    HIGH = 2
    CRITICAL = 3


@dataclasses.dataclass
class AudioPipelineConfig:
    sample_rate: int = 16_000
    chunk_ms: int = 100                      # tk_cortex_main.c:875
    vad_threshold: float = 0.8               # tk_cortex_main.c:882
    end_of_speech_silence_ms: int = 500      # tk_cortex_main.c:881
    # Endpoint anticipation: once this much silence has accumulated
    # (but before the end-of-speech threshold), the authoritative ASR
    # pass starts in the background on the audio captured so far — the
    # utterance content is already complete when silence BEGINS, so by
    # the time the endpoint is declared the transcript is usually
    # ready (~100 ms off end-of-speech -> first-reply latency). If
    # speech resumes, the tentative result is discarded. 0 disables.
    endpoint_anticipation_ms: int = 150
    max_command_seconds: float = 15.0
    pre_roll_chunks: int = 3                 # keep audio just before VAD
    passive_sound_window_s: float = 1.0
    wake_word_enabled: bool = True


@dataclasses.dataclass(order=True)
class _QueuedSpeech:
    sort_key: tuple
    text: str = dataclasses.field(compare=False)
    priority: TTSPriority = dataclasses.field(compare=False)
    seq: int = dataclasses.field(compare=False, default=0)
    retries: int = dataclasses.field(compare=False, default=0)


class AudioPipeline:
    """Host state machine over injected model callables.

    Callables (any may be None to disable that stage):
      vad_fn(chunk f32[N]) -> speech probability float
      asr_fn(audio f32[T]) -> transcript str
      tts_fn(text str) -> waveform f32[T]
      tts_stream_fn(text str) -> iterator of waveform chunks f32[Ti]
        (preferred over tts_fn when both are given: the first chunk is
        audible ~2-3x sooner and CRITICAL speech can interrupt BETWEEN
        chunks instead of only between sentences — parity with
        tk_tts_piper's synth-to-callback, tk_tts_piper.c:106-237)
      wake_fn(chunk) -> bool
      sound_fn(window f32[T]) -> class name str or None
    Callbacks: on_wake(), on_speech_start(), on_speech_end(),
      on_transcription(text), on_sound(name), on_tts_audio(wav, priority)
      (fires once per chunk in streaming mode), on_state_change(old, new),
      on_partial_transcription(stable_text) (streaming_asr only; fires
      as the LocalAgreement stable prefix grows mid-utterance).
    """

    def __init__(self, config: Optional[AudioPipelineConfig] = None,
                 vad_fn: Optional[Callable] = None,
                 asr_fn: Optional[Callable] = None,
                 tts_fn: Optional[Callable] = None,
                 wake_fn: Optional[Callable] = None,
                 sound_fn: Optional[Callable] = None,
                 tts_stream_fn: Optional[Callable] = None,
                 streaming_asr=None,
                 **callbacks: Callable):
        self.config = config or AudioPipelineConfig()
        self.vad_fn = vad_fn
        self.asr_fn = asr_fn
        # Optional audio.streaming_asr.StreamingTranscriber: speech
        # chunks are fed DURING the utterance and the agreed stable
        # prefix is emitted via on_partial_transcription(text) —
        # consumers can start acting (LLM prompt prefill) before
        # end-of-speech. The final transcript still comes from one
        # authoritative full-buffer pass (finalize).
        self.streaming_asr = streaming_asr
        self.tts_fn = tts_fn
        self.tts_stream_fn = tts_stream_fn
        self.wake_fn = wake_fn
        self.sound_fn = sound_fn
        self._cb = callbacks

        self.state = (AudioState.AWAITING_WAKE_WORD
                      if self.config.wake_word_enabled and wake_fn
                      else AudioState.LISTENING_FOR_COMMAND)
        self._speech_buf: List[np.ndarray] = []
        self._pre_roll: List[np.ndarray] = []
        self._silence_ms = 0.0
        self._in_speech = False
        self._passive_buf: List[np.ndarray] = []
        # Endpoint anticipation bookkeeping: the tentative holder is
        # valid only while the speech-chunk count is unchanged (speech
        # resuming invalidates it).
        self._n_speech_chunks = 0
        self._tentative: Optional[dict] = None

        # Priority TTS queue + worker thread.
        self._queue: List[_QueuedSpeech] = []
        self._queue_lock = threading.Condition()
        self._seq = itertools.count()
        self._interrupt = threading.Event()
        self._drop_current = False
        self._current_priority: Optional[TTSPriority] = None
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._tts_worker,
                                        daemon=True, name="tts-worker")
        self._worker.start()

    # ------------------------------------------------------------------
    def _emit(self, name: str, *args) -> None:
        cb = self._cb.get(name)
        if cb:
            try:
                cb(*args)
            except Exception as e:  # callbacks must not kill the pipeline
                log.warning("callback %s raised: %s", name, e)

    def _set_state(self, new: AudioState) -> None:
        if new is not self.state:
            old, self.state = self.state, new
            self._emit("on_state_change", old, new)

    # ------------------------------------------------------------------
    # Capture path (parity: tk_audio_pipeline_process_chunk)
    # ------------------------------------------------------------------

    def process_chunk(self, chunk: np.ndarray) -> None:
        """Feed one mono f32 chunk at the configured sample rate."""
        chunk = np.asarray(chunk, np.float32)

        if self.state is AudioState.AWAITING_WAKE_WORD:
            self._passive_listen(chunk)
            return
        if self.state is AudioState.LISTENING_FOR_COMMAND:
            self._active_listen(chunk)
            return
        # TRANSCRIBING / SYNTHESIZING: drop mic input (reference behavior:
        # the pipeline is busy; callers may still queue TTS).

    def _passive_listen(self, chunk: np.ndarray) -> None:
        if self.wake_fn and self.wake_fn(chunk):
            log.info("wake word detected")
            self._emit("on_wake")
            self._reset_listening()
            self._set_state(AudioState.LISTENING_FOR_COMMAND)
            return
        if self.sound_fn:
            self._passive_buf.append(chunk)
            total = sum(len(c) for c in self._passive_buf)
            window = int(self.config.passive_sound_window_s
                         * self.config.sample_rate)
            if total >= window:
                audio = np.concatenate(self._passive_buf)[-window:]
                self._passive_buf = []
                name = self.sound_fn(audio)
                if name:
                    self._emit("on_sound", name)

    def _active_listen(self, chunk: np.ndarray) -> None:
        cfg = self.config
        chunk_ms = 1000.0 * len(chunk) / cfg.sample_rate
        prob = self.vad_fn(chunk) if self.vad_fn else 1.0

        if prob >= cfg.vad_threshold:
            if not self._in_speech:
                self._in_speech = True
                self._speech_buf = list(self._pre_roll)
                self._emit("on_speech_start")
                if self.streaming_asr:
                    self.streaming_asr.reset()
                    for c in self._speech_buf:  # pre-roll belongs too
                        self._feed_streaming(c)
            self._speech_buf.append(chunk)
            self._silence_ms = 0.0
            self._n_speech_chunks += 1
            self._tentative = None  # speech resumed: stale result
            self._feed_streaming(chunk)
        else:
            if self._in_speech:
                self._speech_buf.append(chunk)
                self._silence_ms += chunk_ms
                if (cfg.endpoint_anticipation_ms > 0
                        and self._tentative is None
                        and self._silence_ms
                        >= cfg.endpoint_anticipation_ms
                        and self._silence_ms
                        < cfg.end_of_speech_silence_ms):
                    self._start_tentative_asr()
                if self._silence_ms >= cfg.end_of_speech_silence_ms:
                    self._finish_utterance()
                    return
            else:
                self._pre_roll.append(chunk)
                self._pre_roll = self._pre_roll[-cfg.pre_roll_chunks:]

        max_len = cfg.max_command_seconds * cfg.sample_rate
        if (self._in_speech
                and sum(len(c) for c in self._speech_buf) >= max_len):
            self._finish_utterance()

    def _feed_streaming(self, chunk: np.ndarray) -> None:
        if not self.streaming_asr:
            return
        try:
            grown = self.streaming_asr.feed(chunk)
        except Exception as e:  # partials must not kill capture
            log.warning("streaming ASR feed failed: %s", e)
            return
        if grown:
            self._emit("on_partial_transcription", grown)

    def _start_tentative_asr(self) -> None:
        """Endpoint anticipation: run the authoritative ASR pass NOW,
        during the silence window, so the transcript is ready when the
        endpoint is declared. The tentative audio lacks the last
        ~(end_of_speech - anticipation) ms of trailing silence the
        final buffer would carry — pure silence either way (both are
        padded to the model window downstream), so the pass is
        equivalent. A daemon thread keeps the real-time chunk loop
        unblocked; the model call itself serializes through the same
        scheduler as every other ASR pass."""
        fn = (self.streaming_asr.asr_fn if self.streaming_asr is not None
              else self.asr_fn)
        if fn is None or not self._speech_buf:
            return
        audio = np.concatenate(self._speech_buf)
        holder = {"n_speech": self._n_speech_chunks, "text": None,
                  "failed": False}

        def run():
            try:
                holder["text"] = fn(audio) or ""
            except Exception as e:
                log.warning("tentative ASR failed: %s", e)
                holder["failed"] = True

        t = threading.Thread(target=run, daemon=True,
                             name="tentative-asr")
        holder["thread"] = t
        self._tentative = holder
        t.start()

    def _finish_utterance(self) -> None:
        self._emit("on_speech_end")
        audio = (np.concatenate(self._speech_buf)
                 if self._speech_buf else np.zeros(0, np.float32))
        tentative = self._tentative
        if (tentative is not None
                and tentative["n_speech"] != self._n_speech_chunks):
            tentative = None
        self._tentative = None
        self._reset_listening()
        if (self.asr_fn is None and self.streaming_asr is None) \
                or len(audio) == 0:
            if self.streaming_asr:
                self.streaming_asr.reset()
            self._set_state(self._idle_state())
            return
        self._set_state(AudioState.TRANSCRIBING)
        text = None
        if tentative is not None:
            tentative["thread"].join(timeout=10.0)
            if not tentative["failed"] and tentative["text"] is not None:
                text = tentative["text"]
            if self.streaming_asr is not None:
                self.streaming_asr.reset()
        if text is None:
            try:
                if self.streaming_asr is not None:
                    text = self.streaming_asr.finalize(audio)
                else:
                    text = self.asr_fn(audio)
            except Exception as e:
                log.warning("ASR failed: %s", e)
                text = ""
        self._set_state(self._idle_state())
        if text:
            self._emit("on_transcription", text)

    def _reset_listening(self) -> None:
        self._speech_buf = []
        self._pre_roll = []
        self._silence_ms = 0.0
        self._in_speech = False
        self._n_speech_chunks = 0
        self._tentative = None

    def _idle_state(self) -> AudioState:
        return (AudioState.AWAITING_WAKE_WORD
                if self.config.wake_word_enabled and self.wake_fn
                else AudioState.LISTENING_FOR_COMMAND)

    # ------------------------------------------------------------------
    # TTS path (parity: priority queue w/ interruption + _say)
    # ------------------------------------------------------------------

    def say(self, text: str, priority: TTSPriority = TTSPriority.NORMAL,
            ) -> None:
        """Queue speech. CRITICAL/HIGH interrupts lower-priority speech
        currently synthesizing (parity: tk_audio_pipeline.c:837-1008)."""
        with self._queue_lock:
            seq = next(self._seq)
            heapq.heappush(self._queue,
                           _QueuedSpeech((-int(priority), seq), text,
                                         priority, seq))
            if (self._current_priority is not None
                    and priority > self._current_priority):
                self._interrupt.set()
            self._queue_lock.notify()

    def clear_speech_queue(self) -> None:
        with self._queue_lock:
            self._queue.clear()
            self._drop_current = True   # cancelled, not preempted
            self._interrupt.set()

    def _tts_worker(self) -> None:
        while not self._stop.is_set():
            with self._queue_lock:
                while not self._queue and not self._stop.is_set():
                    self._queue_lock.wait(timeout=0.1)
                if self._stop.is_set():
                    return
                item = heapq.heappop(self._queue)
                self._current_priority = item.priority
            self._interrupt.clear()
            interrupted = False
            emitted = False
            try:
                if self.tts_stream_fn is not None:
                    for chunk in self.tts_stream_fn(item.text):
                        if self._interrupt.is_set():
                            log.info("speech %r interrupted mid-stream",
                                     item.text[:32])
                            interrupted = True
                            break
                        self._emit("on_tts_audio", chunk, item.priority)
                        emitted = True
                elif self.tts_fn is not None:
                    wav = self.tts_fn(item.text)
                    if not self._interrupt.is_set():
                        self._emit("on_tts_audio", wav, item.priority)
                        emitted = True
                    else:
                        log.info("speech %r interrupted by higher priority",
                                 item.text[:32])
                        interrupted = True
            except Exception as e:
                log.warning("TTS failed for %r: %s", item.text[:32], e)
            finally:
                with self._queue_lock:
                    self._current_priority = None
            # An interruption must not silently DROP the utterance:
            # before any audio played (e.g. a CRITICAL alert landing
            # during the reply's first-chunk synthesis), re-queue it so
            # it plays after the interrupting speech. Already-started
            # speech is not replayed (resuming mid-sentence is worse
            # than losing the tail), and a retry cap avoids live-lock
            # under a continuous higher-priority stream.
            with self._queue_lock:
                cancelled = self._drop_current or self._stop.is_set()
                self._drop_current = False
            if (interrupted and not emitted and not cancelled
                    and item.retries < 3):
                with self._queue_lock:
                    seq = next(self._seq)
                    heapq.heappush(
                        self._queue,
                        _QueuedSpeech((-int(item.priority), seq),
                                      item.text, item.priority, seq,
                                      retries=item.retries + 1))
                    self._queue_lock.notify()

    def wait_idle(self, timeout: float = 5.0) -> bool:
        """Block until the speech queue drains (test helper)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._queue_lock:
                if not self._queue and self._current_priority is None:
                    return True
            time.sleep(0.01)
        return False

    def close(self) -> None:
        self._stop.set()
        self._interrupt.set()  # discard any in-flight synthesis result
        with self._queue_lock:
            self._queue_lock.notify_all()
        # Generous join: a first-call TTS compile can take seconds, and
        # returning while the worker is inside device code risks a crash
        # at interpreter exit (same class as the cortex shutdown bug).
        self._worker.join(timeout=10.0)
        if self._worker.is_alive():
            log.warning("TTS worker did not stop within 10 s")
