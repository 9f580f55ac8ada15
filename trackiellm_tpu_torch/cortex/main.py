"""Cortex main loop: lifecycle-managed reasoning engine.

Parity target: ``tk_cortex_main`` (reference: src/cortex/tk_cortex_main.c):
  - state machine UNINITIALIZED -> IDLE -> LISTENING -> PROCESSING ->
    RESPONDING (+ FATAL_ERROR / SHUTDOWN) (tk_cortex_main.h:51-60),
  - dedicated event-loop thread with a bounded (128-slot) event queue
    (:231-280, :957),
  - video ring buffer depth 4 (:542) with deep-copied latest-frame
    processing (:1149-1176),
  - audio chunks forwarded straight to the audio pipeline (:660-666),
  - 10 Hz timer tick driving decision-queue processing + navigation
    analysis + context decay (:1116-1126, :1246),
  - LLM inference on final user speech with a 2048-token context budget
    (:1323-1335), decision-engine execution of the response (:1363-1374),
  - emergency-stop flag checked every iteration (:963-970),
  - perf counters: EMA loop time + last vision/LLM latency, logged every
    100 iterations (:369-375, 1388-1411).

TPU design: the loop is a host thread (control flow); every heavy stage
it calls (vision pipeline, audio models, LLM) is a jitted device program
owned by the injected subsystem objects.
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from trackiellm_tpu_torch.cortex.decision import (
    ActionPriority,
    DecisionEngine,
)
from trackiellm_tpu_torch.cortex.memory import MemoryManager
from trackiellm_tpu_torch.cortex.reasoner import ContextPriority, ContextualReasoner
from trackiellm_tpu_torch.cortex.world_model import WorldModel
from trackiellm_tpu_torch.interaction.commands import CommandParser
from trackiellm_tpu_torch.interaction.feedback import (
    FeedbackManager,
    FeedbackPriority,
)
from trackiellm_tpu_torch.utils.errors import ErrorCode, TrackieError
from trackiellm_tpu_torch.utils.logging import get_logger

log = get_logger("cortex")


class CortexState(enum.Enum):
    """Parity: tk_cortex_state_t (tk_cortex_main.h:51-60)."""

    UNINITIALIZED = "uninitialized"
    IDLE = "idle"
    LISTENING = "listening"
    PROCESSING = "processing"
    RESPONDING = "responding"
    FATAL_ERROR = "fatal_error"
    SHUTDOWN = "shutdown"


class EventType(enum.Enum):
    NEW_VIDEO_FRAME = "new_video_frame"
    USER_SPEECH_PARTIAL = "user_speech_partial"
    USER_SPEECH_FINAL = "user_speech_final"
    SIGNIFICANT_VISION_CHANGE = "significant_vision_change"
    AMBIENT_SOUND = "ambient_sound"
    SYSTEM_TIMER = "system_timer"
    EMERGENCY = "emergency"
    STOP = "stop"


@dataclasses.dataclass
class CortexEvent:
    type: EventType
    payload: Any = None


# Dequeue priority (lower = sooner). The reference's queue is FIFO
# (tk_cortex_main.c:231) but its event *rate* is low; here the 10 Hz
# camera alone can back the queue up, and a USER_SPEECH_FINAL stuck
# behind stale NEW_VIDEO_FRAME events adds whole frames of latency to
# the reply (measured: >1 s p50 through the production loop before
# this ordering). Same-priority events stay FIFO via a sequence number.
_EVENT_PRIORITY = {
    EventType.EMERGENCY: 0,
    EventType.USER_SPEECH_FINAL: 1,
    # Partials share the final's class so a queued partial is always
    # handled BEFORE the final it precedes (FIFO within a priority).
    EventType.USER_SPEECH_PARTIAL: 1,
    EventType.AMBIENT_SOUND: 2,
    EventType.SIGNIFICANT_VISION_CHANGE: 3,
    EventType.SYSTEM_TIMER: 3,
    EventType.NEW_VIDEO_FRAME: 4,
    # Graceful STOP drains last: events already queued (a final speech
    # turn, a pending alert) are still handled before the loop exits;
    # EMERGENCY preempts everything via its flag regardless.
    EventType.STOP: 5,
}


@dataclasses.dataclass
class CortexConfig:
    """Defaults mirror tk_cortex_main.c / cortex_worker.rs."""

    main_loop_hz: float = 10.0        # cortex_worker.rs:131
    event_queue_depth: int = 128      # tk_cortex_main.c:231
    video_buffer_depth: int = 4       # tk_cortex_main.c:542
    llm_token_budget: int = 2048      # tk_cortex_main.c:1334
    # Consecutive event-handler failures before the loop escalates to
    # FATAL_ERROR and halts (tk_cortex_main.c:986-989 escalates on
    # critical failure; repeated failures are treated as critical here).
    max_consecutive_failures: int = 3
    # Context emission order: "prefix_stable" (default) keeps volatile
    # per-tick categories at the prompt tail so cross-turn KV prefix
    # reuse covers the head; "parity" is the reference's urgent-first
    # order (reasoner.generate_context_string docstring).
    context_layout: str = "prefix_stable"
    # Multimodal scene input: when the runner is a VLMRunner
    # (llm/vlm.py), attach the latest camera frame to each user-query
    # prompt — the model SEES the scene instead of reading YOLO labels
    # only. Placement (system + context, then image, then user text)
    # keeps the stable prompt head reusable across turns (the VLM
    # runner's digest-guarded prefix cache). Off by default: the
    # text-only production path is the measured artifact.
    vlm_scene_image: bool = False
    system_prompt: str = (
        "Você é o Trackie, um assistente para pessoas com deficiência "
        "visual. Responda de forma curta, clara e útil.")


class _SentenceStreamer:
    """Accumulates generation tokens and emits completed sentences.

    Holds off entirely when the output opens with '{' (tool-call JSON
    must reach the decision engine whole). ``streamed`` reports whether
    any speech was emitted (the caller then skips re-speaking the full
    text)."""

    _BOUNDARY = ".!?;"

    def __init__(self, emit):
        self._emit = emit
        self._buf = ""
        self._tool_like: Optional[bool] = None
        self.streamed = False

    def feed(self, piece: str) -> None:
        self._buf += piece
        if self._tool_like is None:
            stripped = self._buf.lstrip()
            if not stripped:
                return
            self._tool_like = stripped.startswith("{")
        if self._tool_like:
            return
        while True:
            idx = next((i for i, c in enumerate(self._buf)
                        if c in self._BOUNDARY), None)
            if idx is None:
                return
            sentence = self._buf[:idx + 1].strip()
            self._buf = self._buf[idx + 1:]
            if len(sentence) >= 2:  # skip degenerate fragments
                self._emit(sentence)
                self.streamed = True

    def flush(self) -> None:
        if not self._tool_like and self._buf.strip():
            self._emit(self._buf.strip())
            self._buf = ""
            self.streamed = True


class Cortex:
    """The reasoning engine. Subsystems are injected (any may be None —
    the reference's tests build a cortex with NULL model paths and drive
    the reasoner directly; the same works here)."""

    def __init__(
        self,
        config: Optional[CortexConfig] = None,
        vision_pipeline=None,       # .process_frame(frame) -> VisionResult
        audio_pipeline=None,        # .process_chunk / .say
        navigation_engine=None,     # .update(depth) / .hazards()
        sensor_fusion=None,         # .get_world_state()
        llm_runner=None,            # trackiellm_tpu_torch.llm.runner.LLMRunner
        reasoner: Optional[ContextualReasoner] = None,
        decision_engine: Optional[DecisionEngine] = None,
        world_model: Optional[WorldModel] = None,
        memory: Optional[MemoryManager] = None,
        on_response: Optional[Callable[[str], None]] = None,
        on_state_change: Optional[Callable] = None,
    ):
        self.config = config or CortexConfig()
        self.vision = vision_pipeline
        self.audio = audio_pipeline
        self.navigation = navigation_engine
        self.sensors = sensor_fusion
        self.llm = llm_runner
        self.reasoner = reasoner or ContextualReasoner()
        self.decisions = decision_engine or DecisionEngine(
            speak_fn=self._speak)
        self.world = world_model or WorldModel()
        self.memory = memory or MemoryManager()
        # Alert dedup queue + voice-command fast path (parity:
        # tk_feedback_manager + tk_voice_commands, src/interaction/).
        self.feedback = FeedbackManager(speak_fn=self._speak)
        self.commands = CommandParser()
        self._last_response = ""
        # Context/tools frozen at the first streaming-ASR partial of an
        # utterance, so the primed prompt prefix byte-matches the final
        # prompt (the final turn reuses them; see
        # _process_partial_transcript).
        self._partial_ctx = None

        self._on_response = on_response
        self._on_state_change = on_state_change

        self.state = CortexState.UNINITIALIZED
        self._consecutive_failures = 0
        self._events: "queue.PriorityQueue" = queue.PriorityQueue(
            maxsize=self.config.event_queue_depth)
        self._event_seq = 0
        self._frames = collections.deque(
            maxlen=self.config.video_buffer_depth)
        self._frame_lock = threading.Lock()
        # Coalescing: at most ONE NEW_VIDEO_FRAME event is queued at a
        # time — frames land in the ring regardless, and the handler
        # always processes the LATEST one, so queued duplicates are
        # pure backlog.
        self._vision_event_pending = False
        self._thread: Optional[threading.Thread] = None
        self._stop_flag = threading.Event()
        self._emergency_flag = threading.Event()
        self._known_labels: set = set()

        # Perf counters (parity: tk_cortex_main.c:369-375).
        self.stats: Dict[str, float] = {
            "loop_ema_ms": 0.0, "last_vision_ms": 0.0, "last_llm_ms": 0.0,
            "iterations": 0,
        }
        self._register_default_tools()
        self.state = CortexState.IDLE

    # ------------------------------------------------------------------
    # Lifecycle (parity: tk_cortex_create/run/stop)
    # ------------------------------------------------------------------

    def run(self, block: bool = False) -> None:
        if self._thread is not None:
            raise TrackieError(ErrorCode.INVALID_STATE, "cortex already running")
        self._stop_flag.clear()
        self._thread = threading.Thread(target=self._main_loop,
                                        name="cortex-loop", daemon=True)
        self._thread.start()
        if block:
            self._thread.join()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop_flag.set()
        self._enqueue(CortexEvent(EventType.STOP), drop_ok=True)
        if self._thread:
            self._thread.join(timeout=timeout)
            self._thread = None
        self._set_state(CortexState.SHUTDOWN)

    def _set_state(self, new: CortexState) -> None:
        if new is not self.state:
            old, self.state = self.state, new
            if self._on_state_change:
                try:
                    self._on_state_change(old, new)
                except Exception:
                    pass

    # ------------------------------------------------------------------
    # Injection API (parity: tk_cortex_inject_*)
    # ------------------------------------------------------------------

    def _enqueue(self, event: CortexEvent, drop_ok: bool = False) -> bool:
        try:
            self._event_seq += 1
            self._events.put_nowait(
                (_EVENT_PRIORITY.get(event.type, 3), self._event_seq,
                 event))
            return True
        except queue.Full:
            if not drop_ok:
                log.warning("event queue full; dropping %s", event.type)
            return False

    def inject_video_frame(self, frame) -> None:
        """Parity: tk_cortex_inject_video_frame (:669) — ring-buffer the
        frame, enqueue NEW_VIDEO_FRAME (coalesced: one queued event
        covers any number of newer frames in the ring)."""
        with self._frame_lock:
            self._frames.append(frame)
            if self._vision_event_pending:
                return
            self._vision_event_pending = True
        self._enqueue(CortexEvent(EventType.NEW_VIDEO_FRAME), drop_ok=True)

    def inject_audio_chunk(self, chunk) -> None:
        """Parity: tk_cortex_inject_audio_frame (:660) — straight into
        the audio pipeline; its transcription callback re-enters via
        inject_user_text."""
        if self.audio is not None:
            self.audio.process_chunk(chunk)

    def inject_user_text(self, text: str) -> None:
        self._enqueue(CortexEvent(EventType.USER_SPEECH_FINAL, text))

    def inject_partial_transcript(self, stable_text: str) -> None:
        """Streaming-ASR hook (audio/streaming_asr.py partials): the
        agreed stable transcript prefix, emitted while the user is
        still speaking. The cortex primes the LLM with the
        prompt-so-far so the final turn extends only the tail.
        Advisory — drops are harmless (the final turn re-prefills)."""
        self._enqueue(CortexEvent(EventType.USER_SPEECH_PARTIAL,
                                  stable_text), drop_ok=True)

    def inject_ambient_sound(self, sound_class: str) -> None:
        self._enqueue(CortexEvent(EventType.AMBIENT_SOUND, sound_class))

    def emergency_stop(self) -> None:
        self._emergency_flag.set()
        self._enqueue(CortexEvent(EventType.EMERGENCY), drop_ok=True)

    # ------------------------------------------------------------------
    # Main loop (parity: cortex_main_loop_thread :957)
    # ------------------------------------------------------------------

    def _main_loop(self) -> None:
        period = 1.0 / self.config.main_loop_hz
        next_tick = time.monotonic()
        while True:
            stopping = self._stop_flag.is_set()
            if stopping and self._events.empty():
                break
            t0 = time.monotonic()
            if self._emergency_flag.is_set():
                self._handle_emergency()
                self._emergency_flag.clear()

            # The timer has priority when due — a continuous event stream
            # must not starve decision-queue processing / decay / nav
            # analysis (the reference drives these from a dedicated
            # timer for the same reason). During shutdown no new timer
            # work starts; only already-queued events drain.
            now = time.monotonic()
            if now >= next_tick and not stopping:
                event = CortexEvent(EventType.SYSTEM_TIMER)
                next_tick = max(next_tick + period, now)
            else:
                try:
                    _, _, event = self._events.get(
                        timeout=0.05 if stopping
                        else max(next_tick - now, 0.0))
                except queue.Empty:
                    continue  # timer due / shutdown re-check
            try:
                if event.type is EventType.STOP:
                    break
                self._handle_event(event)
                # Only substantive events clear the failure streak — a
                # trivially-succeeding timer tick between two crashing
                # speech events must not mask a persistent failure.
                if event.type is not EventType.SYSTEM_TIMER:
                    self._consecutive_failures = 0
            except Exception as e:
                # %r, not %s: TimeoutError and friends stringify to ''
                # (a degraded relay produced three empty messages before
                # this was caught).
                log.error("cortex loop error on %s: %r", event.type, e)
                # Parity: individual stage errors degrade; repeated
                # failures escalate to FATAL_ERROR and halt the loop
                # (tk_cortex_main.c:986-989).
                self._consecutive_failures += 1
                if (self._consecutive_failures
                        >= self.config.max_consecutive_failures):
                    log.error("cortex: %d consecutive failures — "
                              "entering FATAL_ERROR",
                              self._consecutive_failures)
                    self._set_state(CortexState.FATAL_ERROR)
                    break

            dt_ms = (time.monotonic() - t0) * 1e3
            ema = self.stats["loop_ema_ms"]
            self.stats["loop_ema_ms"] = 0.9 * ema + 0.1 * dt_ms
            self.stats["iterations"] += 1
            if self.stats["iterations"] % 100 == 0:
                log.info("cortex perf: loop EMA %.2f ms, vision %.1f ms, "
                         "llm %.1f ms", self.stats["loop_ema_ms"],
                         self.stats["last_vision_ms"],
                         self.stats["last_llm_ms"])

    def _handle_event(self, event: CortexEvent) -> None:
        """Parity: cortex_handle_event (:1053)."""
        if event.type is EventType.NEW_VIDEO_FRAME:
            self._process_vision()
        elif event.type is EventType.USER_SPEECH_PARTIAL:
            self._process_partial_transcript(event.payload)
        elif event.type is EventType.USER_SPEECH_FINAL:
            self._process_user_speech(event.payload)
        elif event.type is EventType.AMBIENT_SOUND:
            self._process_ambient_sound(event.payload)
        elif event.type is EventType.SYSTEM_TIMER:
            self._process_timer_tick()
        elif event.type is EventType.SIGNIFICANT_VISION_CHANGE:
            self._process_significant_change(event.payload)
        elif event.type is EventType.EMERGENCY:
            pass  # handled by the flag check at loop top

    # ------------------------------------------------------------------
    # Vision path (parity: cortex_process_vision_input :1149)
    # ------------------------------------------------------------------

    def _process_vision(self) -> None:
        with self._frame_lock:
            frame = self._frames[-1] if self._frames else None
            self._vision_event_pending = False
        if self.vision is None or frame is None:
            return
        t0 = time.monotonic()
        orientation = None
        if self.sensors is not None:
            try:
                orientation = self.sensors.get_orientation()
            except Exception:
                pass
        try:
            result = self.vision.process_frame(frame,
                                               orientation_wxyz=orientation)
        except TypeError:  # stub pipelines without the kwarg
            result = self.vision.process_frame(frame)
        if result is None:
            # Tick skipped (conversation focus holds passive vision);
            # the next tick brings a fresher frame.
            return
        self.stats["last_vision_ms"] = (time.monotonic() - t0) * 1e3

        scene_desc = ""
        if result.scene_graph:
            from trackiellm_tpu_torch.vision.scene_graph import describe_scene_graph
            scene_desc = describe_scene_graph(result.scene_graph)
        self.reasoner.update_vision_context(result.objects, scene_desc)
        full_text = getattr(result, "full_text", "") or ""
        barcodes = getattr(result, "barcodes", None) or ()
        valid = getattr(result, "valid_analyses", None)
        ran_ocr = False
        if valid is not None:
            from trackiellm_tpu_torch.vision.pipeline import AnalysisFlags
            ran_ocr = bool(valid & AnalysisFlags.OCR)
        if full_text or barcodes or ran_ocr:
            # An OCR pass that found NOTHING must also clear the
            # previous text/QR context (else "há um código QR" would
            # linger ~58 decay ticks after the camera turned away);
            # frames where OCR simply did not run keep the old items
            # decaying naturally.
            self.reasoner.update_text_context(full_text, barcodes)

        cues = getattr(result, "navigation_cues", None)
        if cues:
            self.reasoner.update_navigation_context(cues)
            for alert in self.world.run_navigation_rules(cues):
                self.feedback.submit(alert, FeedbackPriority.CRITICAL)

        self.world.update_from_detections(result.objects)
        alerts = self.world.run_safety_rules()
        for alert in alerts:
            self.reasoner.add_context_item(
                alert.replace("URGENTE: ", ""),
                priority=ContextPriority.URGENT, category="safety")
            self.feedback.submit(alert, FeedbackPriority.CRITICAL)

        # Significant-change detection: a label never seen before
        # (parity: CORTEX_EVENT_SIGNIFICANT_VISION_CHANGE :1229-1237).
        new_labels = {o.label for o in result.objects} - self._known_labels
        if new_labels:
            self._known_labels |= new_labels
            self._enqueue(CortexEvent(
                EventType.SIGNIFICANT_VISION_CHANGE, sorted(new_labels)),
                drop_ok=True)

    def _process_significant_change(self, labels: List[str]) -> None:
        self.reasoner.add_context_item(
            f"Novos objetos na cena: {', '.join(labels)}",
            priority=ContextPriority.NORMAL, category="vision_change")

    # ------------------------------------------------------------------
    # Speech / LLM path (parity: cortex_run_llm_inference :1323)
    # ------------------------------------------------------------------

    def _context_budget(self, user_text: str, tools, margin: int) -> int:
        """Token budget for the reasoner context, derived from the
        runner's REAL window and tokenizer: the exact token count of
        the final prompt built with an EMPTY context (system prompt +
        tool block + instruction formatting + user text), plus
        ``margin`` (BOS, the ``Context:`` insert, and — on the priming
        path — growth of the streaming transcript between the stable
        prefix and the final one). A fixed allowance undercounts the
        tool block under byte-level tokenizers: the prompt then
        overflows the window, truncation invalidates the primed
        prefix, and the turn pays a full re-prefill (measured 3.2 s on
        the round-3 production-loop run)."""
        budget = self.config.llm_token_budget
        count_fn = getattr(self.llm, "count_tokens", None)
        max_prompt = getattr(self.llm, "max_prompt_tokens", None)
        if count_fn is None or max_prompt is None:
            return budget
        build = getattr(self.llm, "build_prompt", None)
        if build is not None:
            overhead = count_fn(build(self.config.system_prompt, "",
                                      user_text, tools)) + margin
        else:
            overhead = (count_fn(self.config.system_prompt)
                        + count_fn(user_text) + margin + 128)
        return max(min(budget, max_prompt - overhead), 16)

    def _process_partial_transcript(self, stable_text: str) -> None:
        """Prime the LLM with the prompt-so-far while the user is still
        speaking (streaming-ASR stable prefix). Runs on the cortex
        event thread, so it can never race an in-flight generation —
        partials queued behind a USER_SPEECH_FINAL simply arrive after
        it and re-prime for nothing (harmless)."""
        if (self.llm is None or not stable_text
                or not hasattr(self.llm, "prime")):
            return
        if self._partial_ctx is None:
            tools = self._tool_definitions()
            # Margin 192: the final transcript grows past this stable
            # prefix between prime and USER_SPEECH_FINAL.
            budget = self._context_budget(stable_text, tools, margin=192)
            context = self.reasoner.generate_context_string(
                user_query=stable_text, token_budget=budget,
                count_fn=getattr(self.llm, "count_tokens", None),
                layout=self.config.context_layout)
            self._partial_ctx = (context, tools)
        context, tools = self._partial_ctx
        prompt = self.llm.build_prompt(self.config.system_prompt, context,
                                       stable_text, tools)
        # Strip the prompt-format closing so the primed text is a true
        # byte prefix of the final prompt (same format, longer user
        # text).
        if prompt.endswith(" [/INST]"):
            prompt = prompt[: -len(" [/INST]")]
        try:
            self.llm.prime(prompt)
            self.stats["partial_primes"] = (
                self.stats.get("partial_primes", 0) + 1)
        except Exception as e:  # priming is best-effort
            log.warning("partial-transcript prime failed: %s", e)

    def _process_user_speech(self, text: str) -> None:
        self._set_state(CortexState.PROCESSING)
        frozen, self._partial_ctx = self._partial_ctx, None

        # Fast-path intents bypass LLM inference entirely (parity:
        # tk_voice_commands' keyword shim ahead of the model).
        cmd = self.commands.parse(text)
        if cmd is not None and cmd.intent in ("emergency_stop",
                                              "stop_speech", "repeat"):
            if cmd.intent == "emergency_stop":
                self.emergency_stop()
            elif cmd.intent == "stop_speech":
                if self.audio is not None:
                    try:
                        self.audio.clear_speech_queue()
                    except Exception:
                        pass
            elif cmd.intent == "repeat" and self._last_response:
                self._speak(self._last_response, int(ActionPriority.HIGH))
            self._set_state(CortexState.IDLE)
            return

        self.reasoner.add_conversation_turn("user", text)

        # Long-term memory recall feeds the context (Rust memory parity).
        for frag in self.memory.retrieve_relevant(text):
            self.reasoner.add_context_item(
                f"Memória: {frag.text}", priority=ContextPriority.LOW,
                category="memory")

        if self.llm is None:
            self._set_state(CortexState.IDLE)
            return

        t0 = time.monotonic()
        # Budget the context against the runner's REAL window/tokenizer
        # when available (a 2048 budget against a small window would
        # overflow the prompt bucket).
        if frozen is not None:
            # Streaming-ASR partials primed the runner against THIS
            # context/tool list; regenerating would break the byte
            # prefix and waste the primed cache.
            context, tools = frozen
        else:
            tools = self._tool_definitions()
            margin = 32
            if self.config.vlm_scene_image:
                # The image run occupies real window positions.
                clip_cfg = getattr(self.llm, "clip_cfg", None)
                if clip_cfg is not None:
                    margin += clip_cfg.n_image_tokens + 8
            budget = self._context_budget(text, tools, margin=margin)
            context = self.reasoner.generate_context_string(
                user_query=text, token_budget=budget,
                count_fn=getattr(self.llm, "count_tokens", None),
                layout=self.config.context_layout)

        # Multimodal scene input: attach the freshest camera frame when
        # configured and the runner supports it (VLMRunner). The image
        # marker lands AFTER the stable system+context head (prefix
        # reuse covers the head; a changed frame rolls back only the
        # image+user tail) and BEFORE the user text.
        images = ()
        marker = getattr(self.llm, "IMAGE_MARKER", None)
        if self.config.vlm_scene_image and marker:
            # User speech can't inject markers — scrub them from the
            # query AND the context (the reasoner quotes the query in
            # conversation turns) before appending the real one.
            text = text.replace(marker, " ")
            context = context.replace(marker, " ") if context else context
            with self._frame_lock:
                frame = self._frames[-1] if self._frames else None
            if frame is not None:
                context = (f"{context}\n\nImagem da câmera: {marker}"
                           if context else f"Imagem da câmera: {marker}")
                images = (frame,)
        prompt = self.llm.build_prompt(self.config.system_prompt, context,
                                       text, tools)

        # Stream completed sentences straight to TTS while the model is
        # still decoding — the user hears the first clause ~N-tokens
        # earlier. Suppressed when the output looks like a tool call
        # (leading '{'): those must be parsed whole.
        stream = _SentenceStreamer(
            lambda s: self._speak(s, int(ActionPriority.NORMAL)))
        # Cancel between tokens when the cortex is shutting down OR an
        # emergency stop fires — generation blocks the single event-loop
        # thread, so without this an emergency_stop() would only be
        # serviced after the full multi-second reply (a real latency
        # hazard for an assistive-navigation device; the reference
        # checks its emergency flag every loop iteration,
        # tk_cortex_main.c:963-970).
        import inspect

        gen_kwargs = {}
        try:
            if "should_stop" in inspect.signature(
                    self.llm.generate).parameters:
                gen_kwargs["should_stop"] = (
                    lambda: self._stop_flag.is_set()
                    or self._emergency_flag.is_set())
        except (TypeError, ValueError):
            pass
        if images:
            gen_kwargs["images"] = images
        raw = self.llm.generate(prompt, tools=tools,
                                on_token=stream.feed, **gen_kwargs)
        self.stats["last_llm_ms"] = (time.monotonic() - t0) * 1e3

        self._set_state(CortexState.RESPONDING)
        if stream.streamed:
            stream.flush()
            resp = self.decisions.parse_only(raw)
        else:
            resp = self.decisions.process_llm_response(raw)
        if resp.is_tool_call:
            done = self.decisions.process_actions()
            for action in done:
                self.llm.add_tool_response(action.name, action.result)
            # One follow-up generation turns the tool result into speech.
            followup = self.llm.generate(
                self.llm.build_prompt(
                    self.config.system_prompt,
                    f"Resultado da ferramenta {resp.tool_name}: "
                    f"{done[0].result if done else 'sem resultado'}",
                    text))
            self.decisions.process_llm_response(followup)
            raw = followup
        self.reasoner.add_conversation_turn("assistant", raw)
        self._last_response = raw
        self._set_state(CortexState.IDLE)

    # ------------------------------------------------------------------
    # Other handlers
    # ------------------------------------------------------------------

    def _process_ambient_sound(self, sound_class: str) -> None:
        urgent = sound_class in ("ALARM", "SIREN")
        self.reasoner.update_ambient_sound(sound_class, urgent=urgent)
        if urgent:
            self._speak(f"URGENTE: {sound_class} detectado!",
                        int(ActionPriority.CRITICAL))

    def _process_timer_tick(self) -> None:
        """Parity: CORTEX_EVENT_SYSTEM_TIMER (:1116) — decision queue +
        navigation analysis + decay."""
        self.decisions.process_actions()
        self.feedback.process()
        if self.navigation is not None and self.sensors is not None:
            try:
                hazards = self.navigation.current_hazards()
                if hazards:
                    self.reasoner.update_navigation_context(hazards)
                    for alert in self.world.run_navigation_rules(hazards):
                        self._speak(alert, int(ActionPriority.CRITICAL))
            except Exception as e:
                log.warning("navigation tick failed: %s", e)
        self.reasoner.decay_tick()

    def _handle_emergency(self) -> None:
        n = self.decisions.emergency_stop()
        if self.audio is not None:
            try:
                self.audio.clear_speech_queue()
            except Exception:
                pass
        self.decisions.emergency_response("Parada de emergência ativada.")
        log.warning("emergency stop: %d actions cancelled", n)

    # ------------------------------------------------------------------

    def _speak(self, text: str, priority: int) -> None:
        if self.audio is not None:
            try:
                self.audio.say(text, priority)
                return
            except Exception as e:
                log.warning("say failed: %s", e)
        if self._on_response:
            self._on_response(text)

    def _tool_definitions(self):
        """ToolDefinitions for every registered tool, carrying each
        tool's argument schema so grammar-forced calls emit TYPED
        arguments (llm/schema.py; llama.cpp json_schema_to_grammar
        parity over the reference's GBNF contract)."""
        from trackiellm_tpu_torch.llm.runner import ToolDefinition

        defs = []
        for name, desc, schema in self.decisions.tool_specs:
            params = {}
            if schema and isinstance(schema.get("properties"), dict):
                params = {k: str(v.get("description")
                                 or v.get("type") or "")
                          for k, v in schema["properties"].items()
                          if isinstance(v, dict)}
            defs.append(ToolDefinition(
                name, desc or name.replace("_", " "), params,
                schema=schema))
        return defs

    def _register_default_tools(self) -> None:
        """Default tool set executing against the reasoner / memory /
        navigation (parity: the decision engine's action handlers)."""
        d = self.decisions

        def describe_scene(args):
            return self.reasoner.generate_context_string(token_budget=256)

        def save_memory(args):
            self.memory.archive(str(args.get("text", "")))
            self.memory.save()
            return "ok"

        def set_fact(args):
            self.memory.set_fact(str(args.get("key", "")),
                                 str(args.get("value", "")))
            return "ok"

        def recall(args):
            frags = self.memory.retrieve_relevant(str(args.get("query", "")))
            return "; ".join(f.text for f in frags) or "nada encontrado"

        def find_clear_path(args):
            if self.navigation is None:
                return "navegação indisponível"
            return self.navigation.describe_clear_path()

        S = {"type": "string"}
        d.register_tool(
            "describe_scene", describe_scene,
            description="descreve a cena atual",
            schema={"type": "object", "properties": {}})
        d.register_tool(
            "save_memory", save_memory,
            description="guarda uma informação na memória",
            schema={"type": "object",
                    "properties": {"text": {**S, "description":
                                            "o que lembrar"}},
                    "required": ["text"]})
        d.register_tool(
            "set_fact", set_fact,
            description="guarda um fato chave/valor",
            schema={"type": "object",
                    "properties": {"key": S, "value": S},
                    "required": ["key", "value"]})
        d.register_tool(
            "recall_memory", recall,
            description="busca memórias relevantes",
            schema={"type": "object",
                    "properties": {"query": {**S, "description":
                                             "termo de busca"}},
                    "required": ["query"]})
        d.register_tool(
            "find_clear_path", find_clear_path,
            description="procura um caminho livre",
            schema={"type": "object", "properties": {}})
