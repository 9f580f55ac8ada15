"""Error codes and the framework exception type.

The port's own copy of ``trackiellm_tpu/utils/errors.py``: the same
``ErrorCode`` names and values (the reference's ``tk_error_code_t``
domains in blocks of 1000, src/utils/tk_error_handling.h:40-123) and the
same ``TrackieError``, so the port imports nothing of the JAX package.
"""

from __future__ import annotations

import enum
from typing import Optional


class ErrorCode(enum.IntEnum):
    """Error codes grouped by domain x 1000 (mirrors tk_error_handling.h)."""

    SUCCESS = 0

    # --- generic (1xxx) ---
    INVALID_ARGUMENT = 1001
    OUT_OF_MEMORY = 1002
    NOT_IMPLEMENTED = 1003
    INTERNAL = 1004
    TIMEOUT = 1005
    BUFFER_TOO_SMALL = 1006
    NOT_FOUND = 1007
    ALREADY_EXISTS = 1008
    PERMISSION_DENIED = 1009
    INVALID_STATE = 1010

    # --- io / filesystem (2xxx) ---
    IO_ERROR = 2001
    FILE_NOT_FOUND = 2002
    FILE_CORRUPT = 2003
    PATH_INVALID = 2004

    # --- config (3xxx) ---
    CONFIG_PARSE_ERROR = 3001
    CONFIG_KEY_MISSING = 3002
    CONFIG_TYPE_MISMATCH = 3003

    # --- model runtime (4xxx) ---
    MODEL_LOAD_FAILED = 4001
    MODEL_FORMAT_UNKNOWN = 4002
    MODEL_METADATA_INVALID = 4003
    INFERENCE_FAILED = 4004
    MODEL_CACHE_FULL = 4005
    QUANT_UNSUPPORTED = 4006

    # --- device / compute (5xxx) ---
    DEVICE_UNAVAILABLE = 5001
    DEVICE_OOM = 5002
    KERNEL_LAUNCH_FAILED = 5003
    COMPILATION_FAILED = 5004
    TRANSFER_FAILED = 5005

    # --- vision (6xxx) ---
    VISION_PIPELINE_ERROR = 6001
    PREPROCESS_FAILED = 6002
    DETECTION_FAILED = 6003
    DEPTH_FAILED = 6004
    OCR_FAILED = 6005

    # --- audio (7xxx) ---
    AUDIO_PIPELINE_ERROR = 7001
    VAD_FAILED = 7002
    ASR_FAILED = 7003
    TTS_FAILED = 7004
    AUDIO_FORMAT_UNSUPPORTED = 7005

    # --- cortex / reasoning (8xxx) ---
    CORTEX_ERROR = 8001
    CONTEXT_OVERFLOW = 8002
    DECISION_PARSE_ERROR = 8003
    TOOL_CALL_INVALID = 8004
    EMERGENCY_STOP = 8005

    # --- navigation / sensors (9xxx) ---
    NAVIGATION_ERROR = 9001
    SENSOR_FUSION_ERROR = 9002
    PLANE_FIT_FAILED = 9003

    # --- ffi / services (10xxx) ---
    FFI_ERROR = 10001
    MODULE_NOT_REGISTERED = 10002
    SECURITY_ERROR = 10003
    AUTH_FAILED = 10004


class TrackieError(Exception):
    """Framework exception carrying an :class:`ErrorCode`.

    The reference surfaces errors as ``tk_error_code_t`` returns plus a
    thread-local last-error string (src/ffi/c_api/tk_ffi_api.h:183); the
    Python-idiomatic equivalent is one exception type whose ``code`` the
    FFI layer can marshal back to an int.
    """

    def __init__(self, code: ErrorCode, message: str = ""):
        self.code = ErrorCode(code)
        self.message = message or self.code.name
        super().__init__(f"[{self.code.name}({int(self.code)})] {self.message}")


def check(cond: bool, code: ErrorCode, message: str = "") -> None:
    """Raise :class:`TrackieError` with *code* if *cond* is falsy."""
    if not cond:
        raise TrackieError(code, message)


_LAST_ERROR: Optional[TrackieError] = None


def set_last_error(err: TrackieError) -> None:
    """Record the most recent error (FFI parity: tk_get_last_error)."""
    global _LAST_ERROR
    _LAST_ERROR = err


def get_last_error() -> Optional[TrackieError]:
    return _LAST_ERROR
