"""Typed broadcast event bus.

Parity target: the Rust event bus — ``tokio::sync::broadcast`` with
capacity 256 carrying the ``TrackieEvent`` enum: VisionResult /
SensorFusionResult / NavigationResult / TranscriptionResult / VADEvent /
Speak / Shutdown, payloads Arc-wrapped (reference:
src/event_bus/src/lib.rs:192-251).

Python design: per-subscriber bounded deques (lagging subscribers drop
oldest — broadcast semantics, a slow consumer never blocks publishers),
plus optional synchronous callbacks for in-thread delivery.
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import threading
import time
from typing import Any, Callable, Dict, List, Optional


class EventKind(enum.Enum):
    """Parity: TrackieEvent variants (event_bus lib.rs:192-208)."""

    VISION_RESULT = "vision_result"
    SENSOR_FUSION_RESULT = "sensor_fusion_result"
    NAVIGATION_RESULT = "navigation_result"
    TRANSCRIPTION_RESULT = "transcription_result"
    VAD_EVENT = "vad_event"
    AMBIENT_SOUND = "ambient_sound"
    SPEAK = "speak"
    SHUTDOWN = "shutdown"


@dataclasses.dataclass
class TrackieEvent:
    kind: EventKind
    payload: Any = None
    timestamp: float = dataclasses.field(default_factory=time.monotonic)


class Subscription:
    """A bounded receive queue; drops oldest on overflow (lag)."""

    def __init__(self, capacity: int):
        self._q: collections.deque = collections.deque(maxlen=capacity)
        self._cv = threading.Condition()
        self.lagged = 0
        self.closed = False

    def _push(self, event: TrackieEvent) -> None:
        with self._cv:
            if len(self._q) == self._q.maxlen:
                self.lagged += 1
            self._q.append(event)
            self._cv.notify()

    def recv(self, timeout: Optional[float] = None) -> Optional[TrackieEvent]:
        with self._cv:
            if not self._q:
                self._cv.wait(timeout=timeout)
            return self._q.popleft() if self._q else None

    def drain(self) -> List[TrackieEvent]:
        with self._cv:
            out = list(self._q)
            self._q.clear()
            return out


class EventBus:
    """Broadcast bus: every subscriber sees every published event."""

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self._subs: List[Subscription] = []
        self._callbacks: Dict[EventKind, List[Callable]] = {}
        self._lock = threading.Lock()
        self.published = 0

    def subscribe(self) -> Subscription:
        sub = Subscription(self.capacity)
        with self._lock:
            self._subs.append(sub)
        return sub

    def unsubscribe(self, sub: Subscription) -> None:
        with self._lock:
            if sub in self._subs:
                self._subs.remove(sub)
                sub.closed = True

    def on(self, kind: EventKind, callback: Callable[[TrackieEvent], None],
           ) -> None:
        """Synchronous in-publisher-thread delivery (cheap hot path)."""
        with self._lock:
            self._callbacks.setdefault(kind, []).append(callback)

    def publish(self, kind: EventKind, payload: Any = None) -> int:
        """Returns the number of queue subscribers reached."""
        event = TrackieEvent(kind, payload)
        with self._lock:
            subs = list(self._subs)
            cbs = list(self._callbacks.get(kind, ()))
        for sub in subs:
            sub._push(event)
        for cb in cbs:
            try:
                cb(event)
            except Exception:
                pass
        self.published += 1
        return len(subs)

    def shutdown(self) -> None:
        self.publish(EventKind.SHUTDOWN)
