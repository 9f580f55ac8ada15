"""Shared per-card inference scheduler.

Port of ``trackiellm_tpu/runtime/scheduler.py``. The reference runs each
model in whatever thread owns it (vision thread, audio thread, cortex
thread) against separate ONNX/llama.cpp sessions. On one card, all
modalities share a single execution stream (the legacy default stream of
every thread) — the north star (BASELINE.json) requires "all three
modalities share one batched inference scheduler per chip". This
scheduler is that component:

  - jobs are (kind, fn, args) with priorities: safety-critical vision
    preempts queued LLM decode slices, ASR preempts idle chat;
  - one dispatch thread owns the device launch order, so latency-class
    jobs are never stuck behind a long low-priority queue (the stream
    executes in launch order — admission order IS the schedule);
  - per-kind latency EMAs feed the cortex perf counters.

Callers get a Future; the LLM's long generations should be submitted as
short slices (e.g. 8-16 decode steps) so vision/ASR jobs interleave.

The host logic (priorities, focus windows, ``run_or_skip``, the staleness
bound) is the reference's line for line; only the completion barrier
(:func:`_block`) differs: it waits for the card's stream and lets a CUDA
error fail the job's future, where the reference swallowed every
exception.
"""

from __future__ import annotations

import dataclasses
import enum
import heapq
import itertools
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, Optional

import torch

from trackiellm_tpu_torch.utils.logging import get_logger

log = get_logger("runtime.scheduler")


class JobKind(enum.Enum):
    VISION = "vision"
    ASR = "asr"
    VAD = "vad"
    TTS = "tts"
    LLM_PREFILL = "llm_prefill"
    LLM_DECODE = "llm_decode"
    OTHER = "other"


# Returned by run_or_skip when conversation focus holds the kind back.
SKIPPED = object()

DEFAULT_PRIORITIES: Dict[JobKind, int] = {
    JobKind.VAD: 5,          # tiny + gating everything else
    JobKind.ASR: 4,          # gates the whole voice-command path (the
    #                          transcript feeds LLM prefill); one short
    #                          job per utterance, so it cannot starve
    #                          the continuous vision loop below it
    JobKind.TTS: 3,          # the user is WAITING to hear this
    JobKind.LLM_PREFILL: 3,
    JobKind.LLM_DECODE: 2,
    JobKind.VISION: 1,       # passive 10 Hz tick: a saturated camera
    #                          stream above TTS starves the reply's
    #                          vocoder chunks indefinitely (measured:
    #                          the production loop never spoke while
    #                          frames queued at the old priority 3).
    #                          Safety alerts tolerate one stale tick;
    #                          an unheard reply is a broken product.
    JobKind.OTHER: 0,
}


@dataclasses.dataclass(order=True)
class _Job:
    sort_key: tuple
    kind: JobKind = dataclasses.field(compare=False)
    fn: Callable = dataclasses.field(compare=False)
    args: tuple = dataclasses.field(compare=False)
    kwargs: dict = dataclasses.field(compare=False)
    future: Future = dataclasses.field(compare=False)
    submitted_at: float = dataclasses.field(compare=False)


class InferenceScheduler:
    """Priority dispatch of device work."""

    def __init__(self, priorities: Optional[Dict[JobKind, int]] = None,
                 focus_kinds=(JobKind.VISION,),
                 focus_max_stale_s: float = 2.0):
        self._prio = dict(DEFAULT_PRIORITIES)
        if priorities:
            self._prio.update(priorities)
        self._heap: list = []
        self._cv = threading.Condition()
        self._seq = itertools.count()
        self._stop = threading.Event()
        self.stats: Dict[str, Dict[str, float]] = {}
        # Conversation focus: while the window is live, run_or_skip
        # rejects focus_kinds jobs at ADMISSION so the reply path never
        # queues behind a passive vision pass on the device — priorities
        # alone cannot preempt an in-flight program (measured on the TPU
        # by the JAX package, tools/measure_app_e2e.py). A staleness
        # bound keeps safety vision alive at >= 1/focus_max_stale_s Hz
        # even while a conversation holds focus.
        self._focus_until = 0.0
        self._focus_kinds = frozenset(focus_kinds)
        self._focus_max_stale_s = focus_max_stale_s
        self._last_done: Dict[JobKind, float] = {}
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        name="inference-scheduler",
                                        daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------

    def submit(self, kind: JobKind, fn: Callable, *args,
               priority: Optional[int] = None, **kwargs) -> Future:
        fut: Future = Future()
        pri = priority if priority is not None else self._prio[kind]
        job = _Job(
            sort_key=(-pri, next(self._seq)),
            kind=kind, fn=fn, args=args, kwargs=kwargs, future=fut,
            submitted_at=time.monotonic(),
        )
        with self._cv:
            heapq.heappush(self._heap, job)
            self._cv.notify()
        return fut

    def run(self, kind: JobKind, fn: Callable, *args,
            timeout: float = 30.0, **kwargs) -> Any:
        """Submit and wait."""
        return self.submit(kind, fn, *args, **kwargs).result(timeout=timeout)

    def focus(self, hold_s: float) -> None:
        """Extend the conversation-focus window by ``hold_s`` seconds.

        Callers refresh it on every conversational signal (speech
        start/end, transcripts, spoken-audio chunks), so the window
        rides the conversation and simply expires afterwards — no
        acquire/release pairing to leak on an error path."""
        with self._cv:
            self._focus_until = max(self._focus_until,
                                    time.monotonic() + hold_s)
            self._cv.notify()

    @property
    def focus_active(self) -> bool:
        return time.monotonic() < self._focus_until

    def run_or_skip(self, kind: JobKind, fn: Callable, *args,
                    timeout: float = 30.0, **kwargs):
        """``run()``, unless conversation focus gates this kind right
        now — then return :data:`SKIPPED` immediately WITHOUT queueing.

        Admission control, not deferral, on purpose: the passive vision
        tick is submitted from the cortex event-loop thread, which
        blocks on the result. Deferring the queued job was measured (on
        the TPU, by the JAX package) to pin that thread for up to the
        staleness bound and triple the reply p50 (user-speech events
        queued behind a stuck cortex); a skip costs nothing and the next
        tick brings a fresher frame anyway."""
        with self._cv:
            if self._gated(kind, time.monotonic()):
                return SKIPPED
        return self.run(kind, fn, *args, timeout=timeout, **kwargs)

    # ------------------------------------------------------------------

    def _gated(self, kind: JobKind, now: float) -> bool:
        """True while conversation focus holds this kind back (unless
        its last completion is stale enough that safety wins)."""
        return (now < self._focus_until
                and kind in self._focus_kinds
                and now - self._last_done.get(kind, 0.0)
                < self._focus_max_stale_s)

    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            with self._cv:
                while not self._heap and not self._stop.is_set():
                    self._cv.wait(timeout=0.1)
                if self._stop.is_set():
                    break
                job = heapq.heappop(self._heap)
            if job.future.cancelled():
                continue
            t0 = time.monotonic()
            try:
                result = job.fn(*job.args, **job.kwargs)
                # Block here so the next launch truly follows this one —
                # the scheduler thread is the device's admission queue.
                result = _block(result)
                job.future.set_result(result)
            except Exception as e:
                job.future.set_exception(e)
            self._record(job, t0)

    def _record(self, job: _Job, t0: float) -> None:
        dt_ms = (time.monotonic() - t0) * 1e3
        wait_ms = (t0 - job.submitted_at) * 1e3
        s = self.stats.setdefault(job.kind.value, {
            "count": 0.0, "ema_ms": 0.0, "ema_wait_ms": 0.0})
        s["count"] += 1
        a = 0.2
        s["ema_ms"] = (1 - a) * s["ema_ms"] + a * dt_ms
        s["ema_wait_ms"] = (1 - a) * s["ema_wait_ms"] + a * wait_ms
        with self._cv:
            self._last_done[job.kind] = time.monotonic()

    # ------------------------------------------------------------------

    def pending(self) -> int:
        with self._cv:
            return len(self._heap)

    def close(self) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        self._thread.join(timeout=10.0)


def _block(result: Any) -> Any:
    """Completion barrier: when ``result`` holds a CUDA tensor (itself, or
    in a tuple, list or dict), wait for the current stream of its card, so
    the next job launches after this one has run and ``ema_ms`` covers its
    device time. A CUDA error raises here and fails the job's future.
    Results with no card tensor (strings, numpy, generators,
    :data:`SKIPPED`) pass through untouched."""
    devices: set = set()
    _cuda_devices(result, devices)
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()
    return result


def _cuda_devices(value: Any, out: set) -> None:
    """Collect the CUDA devices of the tensors in ``value``."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            out.add(value.device)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _cuda_devices(v, out)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
