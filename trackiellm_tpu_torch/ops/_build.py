"""Build the CUDA kernels with nvcc at first use and load them with ctypes.

All sources under ``csrc/`` compile into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds): one nvcc per
``*.cu`` file, all started together, then one link. The library lands in
``trackiellm_tpu_torch/_build/<hash>/``, keyed on a hash of the sources,
the ``*.cuh`` headers they include and the flags, so a checkout builds what
it needs on its first kernel call and reuses it after. A failed build
raises with nvcc's stderr.

The host half of every launch is here too, since decode is bound by it:
a wrapper holds one :class:`Launcher` per C function (looked up once, and
again only when the library is reloaded) and passes :func:`stream`, the
current stream's raw handle, read without building a ``torch.cuda.Stream``.
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

import torch

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
_LIB_NAME = "libtrackie_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# Each exported function returns a cudaError_t (0 = success) or -1.
_SIGNATURES = {
    # xq, sx, sxsum, packed, scales, out, partial,
    # M, K, N, G, BM, splits, groups_per_split, stream
    "trackie_q4_w4a8": (_P,) * 7 + (_I,) * 7 + (_P,),
    # x, xq, sx, sxsum, M, K, G, dtype, stream
    "trackie_quantize_act": (_P,) * 4 + (_I,) * 4 + (_P,),
    # q, k, v, sinks, out, H, Hk, S, D, dtype, scale, causal, window,
    # softcap, stream
    "trackie_flash_attn": (_P,) * 5 + (_I,) * 5 + (_F, _I, _I, _F, _P),
    # x, values, scales, out, partial, M, K, N, G, dtype, BM, splits,
    # groups_per_split, stream
    "trackie_q8_matmul": (_P,) * 5 + (_I,) * 8 + (_P,),
    # x, packed, scales, out, partial, M, K, N, G, dtype, BM, splits,
    # groups_per_split, stream
    "trackie_q4_f32a": (_P,) * 5 + (_I,) * 8 + (_P,),
    # x, norm, gu, gu_scales, down, down_scales, scratch, flags, out, M, D,
    # H, G, x_dtype, norm_dtype, eps, blocks, stream
    "trackie_fused_mlp_q4": (_P,) * 9 + (_I,) * 6 + (_F, _I, _P),
    # x, packed, scales, out, M, K, N, G, dtype, tile_k, tile_n, stages,
    # stream
    "trackie_q4_stream": (_P,) * 4 + (_I,) * 8 + (_P,),
    # x, w, n_bytes, partial, blocks, out, stream
    "trackie_stream_sum": (_P, _P, ctypes.c_longlong, _P, _I, _P, _P),
    # x, out, scratch, numel, n, stream
    "trackie_add_one_chain": (_P, _P, _P, _I, _I, _P),
    # x, out, n, steps, stream
    "trackie_grid64": (_P, _P, _I, _I, _P),
}

_lib: Optional[ctypes.CDLL] = None


class KernelBuildError(RuntimeError):
    """nvcc is missing, or it refused the sources."""


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _hashed_files() -> list:
    """The sources and the headers they include."""
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


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
    for src in _hashed_files():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> pathlib.Path:
    return BUILD_ROOT / _digest() / _LIB_NAME


def _run_all(cmds: list) -> None:
    """Run the commands side by side; raise with the stderr of each that
    failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed (exit {proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{err}")
    if failed:
        raise KernelBuildError("\n".join(failed))


def build() -> pathlib.Path:
    """Compile the sources unless a library with their hash exists."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # Build beside the target and rename: a reader never sees half a file.
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [str(pathlib.Path(tmp) / f"{src.stem}.o") for src in sources()]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                  for src, obj in zip(sources(), objs)])
        lib = str(pathlib.Path(tmp) / _LIB_NAME)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, out)
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
    """Raise if a launch was refused (the C side returns cudaGetLastError,
    -1 for arguments a kernel does not take, -2 where the driver lacks a
    function the launch needs)."""
    if status == -2:
        raise RuntimeError(f"{kernel}: the CUDA driver has no "
                           "cuTensorMapEncodeTiled")
    if status == -1:
        raise ValueError(f"{kernel}: the kernel does not take these arguments")
    if status != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {status}")


class Launcher:
    """One C function of the kernel library, called as ``launcher(*args)``;
    a status that is not 0 raises through :func:`check`, at every launch.
    The function is looked up at the first call and again whenever ``_lib``
    is not the library it came from, so no handle outlives ``_lib`` (a
    reset ``_lib`` builds, or raises :class:`KernelBuildError`, anew)."""

    __slots__ = ("name", "kernel", "_lib", "_fn")

    def __init__(self, name: str, kernel: str):
        if name not in _SIGNATURES:
            raise KeyError(f"the kernel library exports no {name}")
        self.name, self.kernel = name, kernel
        self._lib = self._fn = None

    def __call__(self, *args) -> None:
        lib = _lib
        if lib is None or lib is not self._lib:
            lib = library()
            self._fn, self._lib = getattr(lib, self.name), lib
        check(self._fn(*args), self.kernel)


def stream(t: torch.Tensor) -> int:
    """The raw handle of the current CUDA stream of ``t``'s device, read as
    PyTorch's own Triton launcher reads it, without the ``torch.cuda.Stream``
    that ``torch.cuda.current_stream`` builds. Read at every launch, never
    cached: graph capture and ``torch.cuda.stream`` change it. The function
    exists only in CUDA builds of torch, so only a CUDA tensor's path
    calls this."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())
