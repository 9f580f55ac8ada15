"""Leveled logging with a global gate and optional JSON/structured output.

The port's copy of ``trackiellm_tpu/utils/logging.py`` (stdlib only), so the
port's loader and converter log as the JAX package's do.

Parity target: ``TK_LOG_*`` macros gated on a global level with
file/line/func capture (reference: src/utils/tk_logging.h:30-133) plus the
``logging_ext`` crate's JSON event formatter and audit helpers
(reference: src/logging_ext/src/lib.rs:7-21).
"""

from __future__ import annotations

import enum
import json
import logging
import sys
import time
from typing import Any, Dict, Optional


class LogLevel(enum.IntEnum):
    TRACE = 5
    DEBUG = logging.DEBUG
    INFO = logging.INFO
    WARN = logging.WARNING
    ERROR = logging.ERROR
    FATAL = logging.CRITICAL


logging.addLevelName(LogLevel.TRACE, "TRACE")

_ROOT_NAME = "trackiellm"
_configured = False


def _configure() -> None:
    global _configured
    if _configured:
        return
    root = logging.getLogger(_ROOT_NAME)
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter(
                "%(asctime)s.%(msecs)03d %(levelname)-5s [%(name)s] "
                "%(funcName)s: %(message)s",
                datefmt="%H:%M:%S",
            )
        )
        root.addHandler(handler)
    root.setLevel(LogLevel.INFO)
    root.propagate = False
    _configured = True


def get_logger(name: str) -> logging.Logger:
    """Get a child logger, e.g. ``get_logger("vision.pipeline")``."""
    _configure()
    return logging.getLogger(f"{_ROOT_NAME}.{name}")


def set_log_level(level: LogLevel | int) -> None:
    """Global level gate (parity: tk_log_set_level, tk_logging.h:122-133)."""
    _configure()
    logging.getLogger(_ROOT_NAME).setLevel(int(level))


class JsonEventFormatter:
    """Structured JSON event lines (parity: logging_ext event_formatter)."""

    @staticmethod
    def format_event(event_type: str, payload: Dict[str, Any],
                     severity: str = "INFO") -> str:
        return json.dumps(
            {
                "ts": time.time(),
                "type": event_type,
                "severity": severity,
                "payload": payload,
            },
            separators=(",", ":"),
            default=str,
        )


class AuditTrail:
    """Audit-trail helper for auth / data-access / config events
    (parity: src/logging_ext/src/audit_helpers.rs)."""

    def __init__(self, sink: Optional[logging.Logger] = None):
        self._log = sink or get_logger("audit")

    def record(self, category: str, actor: str, action: str,
               detail: Optional[Dict[str, Any]] = None) -> None:
        self._log.info(
            "%s",
            JsonEventFormatter.format_event(
                f"audit.{category}",
                {"actor": actor, "action": action, "detail": detail or {}},
            ),
        )

    def auth_event(self, actor: str, action: str, success: bool) -> None:
        self.record("auth", actor, action, {"success": success})

    def data_access(self, actor: str, resource: str) -> None:
        self.record("data_access", actor, "read", {"resource": resource})

    def config_change(self, actor: str, key: str, value: Any) -> None:
        self.record("config", actor, "set", {"key": key, "value": value})
