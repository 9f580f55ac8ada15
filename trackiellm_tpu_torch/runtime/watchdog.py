"""Worker watchdog: automatic restart of crashed workers.

Parity target: the reference's failure-handling stack (SURVEY.md
section 5.3) — worker panics caught at join (src/main.rs:107-118) and
systemd ``Restart=on-failure`` at the ops level (README.md:92-107).
Here the restart happens in-process, per worker, with a restart budget
so a crash-looping worker degrades instead of spinning.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from trackiellm_tpu_torch.runtime.tasks import TaskManager
from trackiellm_tpu_torch.utils.logging import get_logger

log = get_logger("runtime.watchdog")


class Watchdog:
    def __init__(self, tasks: TaskManager, interval_s: float = 1.0,
                 max_restarts: int = 3):
        self.tasks = tasks
        self.interval_s = interval_s
        self.max_restarts = max_restarts
        self.restarts: Dict[str, int] = {}
        self.gave_up: Dict[str, str] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="watchdog")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.check_once()

    def check_once(self) -> None:
        errors = self.tasks.errors()
        for name, err in errors.items():
            if name in self.gave_up:
                continue
            count = self.restarts.get(name, 0)
            if count >= self.max_restarts:
                self.gave_up[name] = str(err)
                log.error("worker %s exceeded %d restarts; giving up "
                          "(last error: %s)", name, self.max_restarts, err)
                continue
            handle = self.tasks.respawn(name)
            if handle is not None:
                self.restarts[name] = count + 1
                log.warning("restarted crashed worker %s (attempt %d): %s",
                            name, count + 1, err)

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)
