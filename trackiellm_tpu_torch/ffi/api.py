"""Stable module-command API: the framework's inter-module bus surface.

Parity target: the reference's FFI module registry + async command
execution — ``tk_module_register/unregister`` over a concurrent registry
(reference: src/ffi/src/ffi_bridge.rs:229-307), ``tk_module_execute_command``
with a completion callback (src/ffi/c_api/tk_ffi_api.h:545-567), and the
cortex registering one executor per module type
(src/cortex/tk_cortex_main.c:399-448, 771-925).

Commands are (module, name, payload dict); execution can be synchronous
or callback-async on an executor thread. This is the surface plugins and
companion apps program against.
"""

from __future__ import annotations

import concurrent.futures
import enum
import threading
from typing import Any, Callable, Dict, Optional

from trackiellm_tpu_torch.utils.errors import ErrorCode, TrackieError


class ModuleType(enum.Enum):
    """Parity: TkModuleType."""

    SENSORS = "sensors"
    VISION = "vision"
    NAVIGATION = "navigation"
    AUDIO = "audio"
    CORTEX = "cortex"
    CUSTOM = "custom"


# Executor signature: (command: str, params: dict) -> result
ModuleExecutor = Callable[[str, Dict[str, Any]], Any]


class ModuleRegistry:
    """Concurrent module registry + command dispatcher."""

    def __init__(self, max_workers: int = 2):
        self._executors: Dict[ModuleType, ModuleExecutor] = {}
        self._lock = threading.Lock()
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="tk-module")

    def register(self, module: ModuleType, executor: ModuleExecutor) -> None:
        """Parity: tk_module_register (ffi_bridge.rs:253)."""
        with self._lock:
            if module in self._executors:
                raise TrackieError(ErrorCode.ALREADY_EXISTS,
                                   f"module {module.value} already registered")
            self._executors[module] = executor

    def unregister(self, module: ModuleType) -> None:
        with self._lock:
            self._executors.pop(module, None)

    def registered(self) -> list:
        with self._lock:
            return list(self._executors)

    # ------------------------------------------------------------------

    def execute(self, module: ModuleType, command: str,
                params: Optional[Dict[str, Any]] = None) -> Any:
        """Synchronous command execution."""
        with self._lock:
            fn = self._executors.get(module)
        if fn is None:
            raise TrackieError(ErrorCode.MODULE_NOT_REGISTERED,
                               module.value)
        return fn(command, params or {})

    def execute_async(self, module: ModuleType, command: str,
                      params: Optional[Dict[str, Any]] = None,
                      callback: Optional[Callable[[Any, Optional[Exception]],
                                                  None]] = None,
                      ) -> concurrent.futures.Future:
        """Parity: tk_module_execute_command + TkCallback
        (tk_ffi_api.h:545-567) — runs on the executor pool; the callback
        receives (result, error)."""
        fut = self._pool.submit(self.execute, module, command, params)
        if callback is not None:
            def _done(f):
                try:
                    callback(f.result(), None)
                except Exception as e:
                    callback(None, e)
            fut.add_done_callback(_done)
        return fut

    def close(self) -> None:
        self._pool.shutdown(wait=False)
