"""Task manager: spawn / track / cancel long-running workers.

Parity target: the Rust ``TaskManager`` + async_executor abstraction
(reference: src/async_tasks/src/task_manager.rs, lib.rs:14-18) and
main.rs's spawn-4-workers / ctrl-c / join-with-10s-timeout shape
(src/main.rs:37-127). (The reference's C twins tk_task_scheduler.c /
tk_worker_pool.c are empty stubs — the Rust crate is the real one.)
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

from trackiellm_tpu_torch.utils.logging import get_logger

log = get_logger("runtime.tasks")


@dataclasses.dataclass
class TaskHandle:
    name: str
    thread: threading.Thread
    stop_event: threading.Event
    started_at: float
    error: Optional[BaseException] = None
    target: Optional[Callable] = None
    restarts: int = 0

    @property
    def alive(self) -> bool:
        return self.thread.is_alive()


class TaskManager:
    """Thread-backed task registry with cooperative cancellation."""

    def __init__(self):
        self._tasks: Dict[str, TaskHandle] = {}
        self._lock = threading.Lock()

    def spawn(self, name: str, target: Callable[[threading.Event], None],
              ) -> TaskHandle:
        """``target`` receives a stop Event it must poll (cooperative
        cancellation, like tokio task + shutdown channel)."""
        stop = threading.Event()
        handle = TaskHandle(name, None, stop, time.monotonic(),  # type: ignore
                            target=target)

        def _run():
            try:
                target(stop)
            except BaseException as e:  # worker panics are caught at join
                handle.error = e
                log.error("task %s crashed: %s", name, e)

        t = threading.Thread(target=_run, name=f"task-{name}", daemon=True)
        handle.thread = t
        with self._lock:
            if name in self._tasks and self._tasks[name].alive:
                raise ValueError(f"task {name!r} already running")
            self._tasks[name] = handle
        t.start()
        return handle

    def cancel(self, name: str) -> bool:
        with self._lock:
            handle = self._tasks.get(name)
        if handle is None:
            return False
        handle.stop_event.set()
        return True

    def join_all(self, timeout: float = 10.0) -> List[str]:
        """Signal stop to every task and join with a global deadline
        (parity: main.rs 10 s join timeout). Returns names that failed
        to stop in time."""
        with self._lock:
            tasks = list(self._tasks.values())
        for h in tasks:
            h.stop_event.set()
        deadline = time.monotonic() + timeout
        stragglers = []
        for h in tasks:
            h.thread.join(timeout=max(deadline - time.monotonic(), 0.01))
            if h.thread.is_alive():
                stragglers.append(h.name)
        return stragglers

    def respawn(self, name: str) -> Optional[TaskHandle]:
        """Restart a dead task with its original target (worker recovery;
        parity with the reference's systemd Restart=on-failure at the
        process level, README.md:92-107, done per-worker here)."""
        with self._lock:
            old = self._tasks.get(name)
            if old is None or old.alive or old.target is None:
                return None
            restarts = old.restarts + 1
            target = old.target
            del self._tasks[name]
        handle = self.spawn(name, target)
        handle.restarts = restarts
        return handle

    def status(self) -> Dict[str, bool]:
        with self._lock:
            return {n: h.alive for n, h in self._tasks.items()}

    def errors(self) -> Dict[str, BaseException]:
        with self._lock:
            return {n: h.error for n, h in self._tasks.items() if h.error}
