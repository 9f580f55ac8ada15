"""Runtime key=value config with typed getters and defaults.

Parity target: ``tk_config_t`` (reference: src/internal_tools/
tk_config_parser.h:48-149) — a flat ``key = value`` file format with
``#`` comments, typed getters (string/int/float/bool) that fall back to a
caller-supplied default, programmatic set, and save-back.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional, Tuple

from trackiellm_tpu_torch.utils.errors import ErrorCode, TrackieError

_TRUE = {"1", "true", "yes", "on"}
_FALSE = {"0", "false", "no", "off"}


class Config:
    """Flat key=value configuration store."""

    def __init__(self, values: Optional[Dict[str, str]] = None):
        self._values: Dict[str, str] = dict(values or {})

    # -- construction ------------------------------------------------------
    @classmethod
    def load(cls, path: str | os.PathLike) -> "Config":
        """Parse a ``key = value`` file. Lines starting with ``#`` or ``;``
        and blank lines are skipped; inline ``#`` comments are honoured."""
        cfg = cls()
        try:
            with open(path, "r", encoding="utf-8") as f:
                for lineno, raw in enumerate(f, 1):
                    line = raw.strip()
                    if not line or line[0] in "#;":
                        continue
                    if "=" not in line:
                        raise TrackieError(
                            ErrorCode.CONFIG_PARSE_ERROR,
                            f"{path}:{lineno}: expected 'key = value', got {line!r}",
                        )
                    key, _, val = line.partition("=")
                    # strip inline comment (outside quotes)
                    if "#" in val and not (val.strip().startswith('"')):
                        val = val.split("#", 1)[0]
                    val = val.strip().strip('"')
                    cfg._values[key.strip()] = val
        except OSError as e:
            raise TrackieError(ErrorCode.FILE_NOT_FOUND, f"{path}: {e}") from e
        return cfg

    def save(self, path: str | os.PathLike) -> None:
        with open(path, "w", encoding="utf-8") as f:
            for k, v in sorted(self._values.items()):
                f.write(f"{k} = {v}\n")

    # -- typed getters (parity: tk_config_get_* w/ defaults) ---------------
    def get_string(self, key: str, default: Optional[str] = None) -> str:
        v = self._values.get(key)
        if v is None:
            if default is None:
                raise TrackieError(ErrorCode.CONFIG_KEY_MISSING, key)
            return default
        return v

    def get_int(self, key: str, default: Optional[int] = None) -> int:
        v = self._values.get(key)
        if v is None:
            if default is None:
                raise TrackieError(ErrorCode.CONFIG_KEY_MISSING, key)
            return default
        try:
            return int(v, 0)
        except ValueError as e:
            raise TrackieError(
                ErrorCode.CONFIG_TYPE_MISMATCH, f"{key}={v!r} is not an int"
            ) from e

    def get_float(self, key: str, default: Optional[float] = None) -> float:
        v = self._values.get(key)
        if v is None:
            if default is None:
                raise TrackieError(ErrorCode.CONFIG_KEY_MISSING, key)
            return default
        try:
            return float(v)
        except ValueError as e:
            raise TrackieError(
                ErrorCode.CONFIG_TYPE_MISMATCH, f"{key}={v!r} is not a float"
            ) from e

    def get_bool(self, key: str, default: Optional[bool] = None) -> bool:
        v = self._values.get(key)
        if v is None:
            if default is None:
                raise TrackieError(ErrorCode.CONFIG_KEY_MISSING, key)
            return default
        low = v.lower()
        if low in _TRUE:
            return True
        if low in _FALSE:
            return False
        raise TrackieError(
            ErrorCode.CONFIG_TYPE_MISMATCH, f"{key}={v!r} is not a bool"
        )

    # -- mutation / mapping protocol ---------------------------------------
    def set(self, key: str, value) -> None:
        self._values[key] = str(value)

    def __contains__(self, key: str) -> bool:
        return key in self._values

    def __len__(self) -> int:
        return len(self._values)

    def items(self) -> Iterator[Tuple[str, str]]:
        return iter(sorted(self._values.items()))
