"""Path object + filesystem helpers.

Parity target: ``tk_path_t`` and the file-manager ops (reference:
src/internal_tools/tk_file_manager.h:40,119-268). Built on
:mod:`pathlib` — the value added here is the reference's semantics
(exists/size/atomic-write/ensure-dir) under one object.
"""

from __future__ import annotations

import os
import pathlib
import tempfile
from typing import Union

from trackiellm_tpu_torch.utils.errors import ErrorCode, TrackieError

PathLike = Union[str, os.PathLike]


class Path:
    """Thin path object mirroring tk_path_t semantics."""

    def __init__(self, p: PathLike):
        self._p = pathlib.Path(p)

    # -- queries -----------------------------------------------------------
    def exists(self) -> bool:
        return self._p.exists()

    def is_file(self) -> bool:
        return self._p.is_file()

    def is_dir(self) -> bool:
        return self._p.is_dir()

    def size(self) -> int:
        try:
            return self._p.stat().st_size
        except OSError as e:
            raise TrackieError(ErrorCode.FILE_NOT_FOUND, str(self._p)) from e

    def extension(self) -> str:
        return self._p.suffix.lstrip(".")

    def basename(self) -> str:
        return self._p.name

    def join(self, *parts: PathLike) -> "Path":
        return Path(self._p.joinpath(*parts))

    # -- io ------------------------------------------------------------------
    def read_bytes(self) -> bytes:
        try:
            return self._p.read_bytes()
        except OSError as e:
            raise TrackieError(ErrorCode.IO_ERROR, f"{self._p}: {e}") from e

    def read_text(self) -> str:
        try:
            return self._p.read_text(encoding="utf-8")
        except OSError as e:
            raise TrackieError(ErrorCode.IO_ERROR, f"{self._p}: {e}") from e

    def write_bytes_atomic(self, data: bytes) -> None:
        """Write via temp file + rename so readers never see a torn file
        (the reference's memory-store/auth-state saves need this property)."""
        self._p.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=str(self._p.parent), prefix=".tk_tmp_")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, self._p)
        except OSError as e:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise TrackieError(ErrorCode.IO_ERROR, f"{self._p}: {e}") from e

    def write_text_atomic(self, text: str) -> None:
        self.write_bytes_atomic(text.encode("utf-8"))

    def ensure_dir(self) -> "Path":
        self._p.mkdir(parents=True, exist_ok=True)
        return self

    def unlink(self, missing_ok: bool = True) -> None:
        try:
            self._p.unlink(missing_ok=missing_ok)
        except OSError as e:
            raise TrackieError(ErrorCode.IO_ERROR, f"{self._p}: {e}") from e

    # -- dunder --------------------------------------------------------------
    def __str__(self) -> str:
        return str(self._p)

    def __fspath__(self) -> str:
        return str(self._p)

    def __repr__(self) -> str:
        return f"Path({str(self._p)!r})"

    def __eq__(self, other) -> bool:
        return isinstance(other, Path) and self._p == other._p

    def __hash__(self) -> int:
        return hash(self._p)
