"""Build the CUDA kernels with nvcc at first use and load them with ctypes.

All sources under ``csrc/`` compile into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds). The library
lands in ``trackiellm_tpu_torch/_build/<hash>/``, keyed on a hash of the
sources and flags, so a checkout builds what it needs on its first kernel
call and reuses it after. A failed build raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Optional

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
_LIB_NAME = "libtrackie_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# Each exported function returns a cudaError_t (0 = success) or -1.
_SIGNATURES = {
    # xq, sx, sxsum, packed, scales, out, partial,
    # M, K, N, G, BM, splits, groups_per_split, stream
    "trackie_q4_w4a8": (_P,) * 7 + (_I,) * 7 + (_P,),
    # q, k, v, sinks, out, H, Hk, S, D, dtype, scale, causal, window,
    # softcap, stream
    "trackie_flash_attn": (_P,) * 5 + (_I,) * 5 + (_F, _I, _I, _F, _P),
}

_lib: Optional[ctypes.CDLL] = None


class KernelBuildError(RuntimeError):
    """nvcc is missing, or it refused the sources."""


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelBuildError(
        "nvcc not found on PATH or under /usr/local/cuda/bin: the CUDA "
        "kernels of trackiellm_tpu_torch cannot be built on this host")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> pathlib.Path:
    return BUILD_ROOT / _digest() / _LIB_NAME


def build() -> pathlib.Path:
    """Compile the sources unless a library with their hash exists."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    # Build beside the target and rename: a reader never sees half a file.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise KernelBuildError(
            f"nvcc failed (exit {proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(status: int, kernel: str) -> None:
    """Raise if a launch was refused (the C side returns cudaGetLastError)."""
    if status == -1:
        raise ValueError(f"{kernel}: the kernel does not take these arguments")
    if status != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {status}")
