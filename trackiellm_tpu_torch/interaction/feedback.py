"""Feedback manager: deduplicating priority queue of speech requests.

Parity target: ``tk_feedback_manager`` (reference:
src/interaction/tk_feedback_manager.h:131-173): a priority queue of TTS
requests where re-submitting an already-queued message *updates* its
priority instead of duplicating it, drained by an update loop into the
audio pipeline.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
import time
from typing import Callable, Dict, List, Optional


class FeedbackPriority(enum.IntEnum):
    LOW = 0
    NORMAL = 1
    HIGH = 2
    CRITICAL = 3


@dataclasses.dataclass
class FeedbackRequest:
    message: str
    priority: FeedbackPriority
    submitted_at: float
    repeat_count: int = 1


class FeedbackManager:
    """Dedup-by-message priority queue with a cooldown per message."""

    def __init__(self, speak_fn: Optional[Callable[[str, int], None]] = None,
                 dedup_window_s: float = 5.0):
        self._speak = speak_fn
        self.dedup_window_s = dedup_window_s
        self._queue: Dict[str, FeedbackRequest] = {}
        self._recent: Dict[str, float] = {}  # message -> last spoken
        self._lock = threading.Lock()

    def submit(self, message: str,
               priority: FeedbackPriority = FeedbackPriority.NORMAL) -> bool:
        """Queue a message. Duplicate of a queued message: priority is
        raised to the max of both (parity: dedup/update). Duplicate of a
        recently-spoken message inside the window: suppressed."""
        now = time.monotonic()
        with self._lock:
            last = self._recent.get(message)
            if (last is not None and now - last < self.dedup_window_s
                    and priority < FeedbackPriority.CRITICAL):
                return False
            req = self._queue.get(message)
            if req is not None:
                req.priority = max(req.priority, priority)
                req.repeat_count += 1
                return True
            self._queue[message] = FeedbackRequest(message, priority, now)
            return True

    def process(self, max_messages: int = 2) -> List[FeedbackRequest]:
        """Drain up to N highest-priority requests into the speaker
        (parity: the update loop)."""
        with self._lock:
            ordered = sorted(self._queue.values(),
                             key=lambda r: (-r.priority, r.submitted_at))
            batch = ordered[:max_messages]
            for req in batch:
                del self._queue[req.message]
                self._recent[req.message] = time.monotonic()
        for req in batch:
            if self._speak:
                self._speak(req.message, int(req.priority))
        return batch

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    def clear(self) -> None:
        with self._lock:
            self._queue.clear()
