"""Runtime profiler: toggleable sampling + scoped timers + torch.profiler
bridge.

Parity target: the Rust ``profiling`` crate — runtime-toggleable
``Profiler::start/stop`` producing a ``ProfilingReport``, RAII
``ProfiledThread`` scope guards with Instant timing (reference:
src/profiling/src/profiler_core.rs:37-102). The device addition is the
``device_trace`` context manager wrapping ``torch.profiler`` with CUDA
activity, so a captured trace can be opened in Perfetto or
chrome://tracing (SURVEY.md section 5.1). Port of
``trackiellm_tpu/services/profiling.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from typing import Dict, List

import torch


@dataclasses.dataclass
class ProfileSample:
    name: str
    duration_ms: float
    timestamp: float


@dataclasses.dataclass
class ScopeStats:
    count: int = 0
    total_ms: float = 0.0
    min_ms: float = float("inf")
    max_ms: float = 0.0

    @property
    def mean_ms(self) -> float:
        return self.total_ms / self.count if self.count else 0.0


@dataclasses.dataclass
class ProfilingReport:
    started_at: float
    stopped_at: float
    samples: List[ProfileSample]
    by_scope: Dict[str, ScopeStats]


class Profiler:
    """Thread-safe, runtime-toggleable profiler."""

    def __init__(self, max_samples: int = 10_000):
        self._lock = threading.Lock()
        self._active = False
        self._samples: List[ProfileSample] = []
        self._stats: Dict[str, ScopeStats] = {}
        self._started_at = 0.0
        self._max = max_samples

    def start(self) -> None:
        with self._lock:
            self._active = True
            self._samples = []
            self._stats = {}
            self._started_at = time.time()

    def stop(self) -> ProfilingReport:
        with self._lock:
            self._active = False
            return ProfilingReport(self._started_at, time.time(),
                                   list(self._samples), dict(self._stats))

    @property
    def active(self) -> bool:
        return self._active

    def record(self, name: str, duration_ms: float) -> None:
        if not self._active:
            return
        with self._lock:
            if len(self._samples) < self._max:
                self._samples.append(
                    ProfileSample(name, duration_ms, time.time()))
            st = self._stats.setdefault(name, ScopeStats())
            st.count += 1
            st.total_ms += duration_ms
            st.min_ms = min(st.min_ms, duration_ms)
            st.max_ms = max(st.max_ms, duration_ms)

    @contextlib.contextmanager
    def scope(self, name: str):
        """RAII scope guard (parity: ProfiledThread)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, (time.perf_counter() - t0) * 1e3)


_global_profiler = Profiler()


def global_profiler() -> Profiler:
    return _global_profiler


@contextlib.contextmanager
def profile_scope(name: str):
    with _global_profiler.scope(name):
        yield


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the block with ``torch.profiler`` and write its trace to
    ``log_dir/trace_<pid>_<ns>.json`` (Chrome trace format), with CUDA
    activity when there is a card. Yields the profiler; its path is
    ``prof.trace_path`` after the block. A trace that cannot start or be
    written raises: a trace that silently did not happen would hide the
    device."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    path = os.path.join(log_dir,
                        f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    prof.trace_path = path
