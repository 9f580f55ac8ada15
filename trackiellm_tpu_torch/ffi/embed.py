"""ctypes bindings for the embeddable C ABI (trackie_ffi.h).

Parity target: the reference's external FFI surface consumed by
bindings and companion apps (reference: src/ffi/c_api/tk_ffi_api.h —
TkContext/TkTensor handles :74-98, tensor math :251-382, media handles
:404-526, async tk_module_execute_command :545-567).

Two directions:
  - Python -> C: NativeTensor / NativeAudioStream / NativeVisionFrame /
    NativeContext wrap the opaque handles for host apps written here.
  - C -> Python: ``register_python_module`` installs a Python callable
    as a module executor through a CFUNCTYPE trampoline, so an external
    C embedder driving tk_module_execute_command reaches framework
    subsystems (the analogue of the C cortex registering
    c_module_executor with the Rust registry,
    src/cortex/tk_cortex_main.c:399-448).

Port of ``trackiellm_tpu/ffi/embed.py``. A handle's bytes live on the
host; an executor receives them as a tensor on an explicit device (the
card unless the caller asks for the CPU), copied there, and its result is
copied back to the host before ``NativeTensor.from_numpy``. An
``execute_async`` executor runs on a C worker thread, which launches on
the card's legacy default stream as the app's other threads do;
``drain`` is a ctypes call, so the GIL is released while the C side waits
for those executors.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from trackiellm_tpu_torch.ffi.native import _load
from trackiellm_tpu_torch.ops.backend import default_device
from trackiellm_tpu_torch.utils.errors import ErrorCode, TrackieError
from trackiellm_tpu_torch.utils.logging import get_logger

log = get_logger("ffi.embed")

# dtype ids (trackie_ffi.h TkDataType)
TK_F32, TK_I32, TK_U8 = 0, 1, 2
_DTYPE_NP = {TK_F32: np.float32, TK_I32: np.int32, TK_U8: np.uint8}
_NP_DTYPE = {np.dtype(np.float32): TK_F32, np.dtype(np.int32): TK_I32,
             np.dtype(np.uint8): TK_U8}

_EXECUTOR = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, ctypes.c_void_p,
    ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p)
_CALLBACK = ctypes.CFUNCTYPE(
    None, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)

_declared = False


def _lib():
    lib = _load()
    if lib is None:
        raise TrackieError(ErrorCode.UNSUPPORTED,
                           "native FFI library unavailable")
    global _declared
    if not _declared:
        _declare_ffi(lib)
        _declared = True
    return lib


def _declare_ffi(lib) -> None:
    p = ctypes.c_void_p
    i64p = ctypes.POINTER(ctypes.c_int64)
    szp = ctypes.POINTER(ctypes.c_size_t)
    lib.tk_ffi_last_error.restype = ctypes.c_char_p
    lib.tk_context_create.argtypes = [ctypes.POINTER(p)]
    lib.tk_context_destroy.argtypes = [ctypes.POINTER(p)]
    lib.tk_tensor_create.argtypes = [ctypes.POINTER(p), ctypes.c_int,
                                     i64p, ctypes.c_size_t]
    lib.tk_tensor_destroy.argtypes = [ctypes.POINTER(p)]
    lib.tk_tensor_get_data.argtypes = [p, ctypes.POINTER(p), szp]
    lib.tk_tensor_get_mutable_data.argtypes = [p, ctypes.POINTER(p), szp]
    lib.tk_tensor_get_shape.argtypes = [p, i64p, szp]
    lib.tk_tensor_dtype.argtypes = [p, ctypes.POINTER(ctypes.c_int)]
    lib.tk_tensor_reshape.argtypes = [p, i64p, ctypes.c_size_t]
    lib.tk_tensor_fill.argtypes = [p, ctypes.c_double]
    lib.tk_tensor_add.argtypes = [p, p, p]
    lib.tk_tensor_matmul.argtypes = [p, p, p]
    lib.tk_tensor_matmul_blocked.argtypes = [p, p, p, ctypes.c_size_t]
    lib.tk_audio_stream_create.argtypes = [
        ctypes.POINTER(p), ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_size_t]
    lib.tk_audio_stream_destroy.argtypes = [ctypes.POINTER(p)]
    lib.tk_audio_stream_write.argtypes = [p, ctypes.c_void_p,
                                          ctypes.c_size_t, szp]
    lib.tk_audio_stream_read.argtypes = [p, ctypes.c_void_p,
                                         ctypes.c_size_t, szp]
    lib.tk_audio_stream_reset.argtypes = [p]
    lib.tk_vision_frame_create.argtypes = [ctypes.POINTER(p), ctypes.c_int,
                                           ctypes.c_uint32, ctypes.c_uint32]
    lib.tk_vision_frame_destroy.argtypes = [ctypes.POINTER(p)]
    lib.tk_vision_frame_get_data.argtypes = [p, ctypes.POINTER(p), szp]
    lib.tk_vision_frame_get_mutable_data.argtypes = [p, ctypes.POINTER(p),
                                                     szp]
    lib.tk_vision_frame_get_info.argtypes = [
        p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32)]
    lib.tk_context_register_module.argtypes = [p, ctypes.c_int32,
                                               _EXECUTOR, ctypes.c_void_p]
    lib.tk_context_unregister_module.argtypes = [p, ctypes.c_int32]
    lib.tk_module_execute_command.argtypes = [
        p, ctypes.c_int32, ctypes.c_char_p, p, ctypes.POINTER(p),
        _CALLBACK, ctypes.c_void_p]
    lib.tk_context_drain.argtypes = [p]
    lib.tk_version_string.restype = ctypes.c_char_p


def _check(status: int, what: str) -> None:
    if status != 0:
        msg = _lib().tk_ffi_last_error().decode(errors="replace")
        raise TrackieError(ErrorCode.FFI_ERROR, f"{what}: {msg} ({status})")


class NativeTensor:
    """Owned TkTensor handle. ``from_numpy``/``to_numpy`` copy."""

    def __init__(self, dtype_id: int, shape: Sequence[int],
                 _handle: Optional[ctypes.c_void_p] = None):
        lib = _lib()
        if _handle is not None:
            self._h = _handle
            return
        h = ctypes.c_void_p()
        arr = (ctypes.c_int64 * len(shape))(*shape)
        _check(lib.tk_tensor_create(ctypes.byref(h), dtype_id, arr,
                                    len(shape)), "tensor_create")
        self._h = h

    @classmethod
    def from_numpy(cls, a: np.ndarray) -> "NativeTensor":
        a = np.ascontiguousarray(a)
        dt = _NP_DTYPE.get(a.dtype)
        if dt is None:
            raise TrackieError(ErrorCode.INVALID_ARGUMENT,
                               f"unsupported dtype {a.dtype}")
        t = cls(dt, a.shape)
        buf, n = t._mutable()
        ctypes.memmove(buf, a.ctypes.data, min(n, a.nbytes))
        return t

    @classmethod
    def from_vision_frame(cls, frame: "NativeVisionFrame") -> "NativeTensor":
        """A uint8 (H, W, C) tensor holding a copy of the frame's pixels,
        copied in C memory (no host array in between)."""
        fmt, w, h = frame.info
        ch = 1 if fmt == NativeVisionFrame.FMT_GRAY8 else 3
        t = cls(TK_U8, (h, w, ch))
        buf, n = t._mutable()
        src, size = frame._data()
        ctypes.memmove(buf, src, min(n, size))
        return t

    @classmethod
    def _adopt(cls, handle) -> "NativeTensor":
        if isinstance(handle, ctypes.c_void_p):
            return cls(0, (), _handle=handle)
        return cls(0, (), _handle=ctypes.c_void_p(int(handle)))

    def _mutable(self) -> Tuple[ctypes.c_void_p, int]:
        lib = _lib()
        pdata = ctypes.c_void_p()
        nbytes = ctypes.c_size_t()
        _check(lib.tk_tensor_get_mutable_data(
            self._h, ctypes.byref(pdata), ctypes.byref(nbytes)),
            "tensor_get_mutable_data")
        return pdata, nbytes.value

    @property
    def shape(self) -> Tuple[int, ...]:
        lib = _lib()
        n = ctypes.c_size_t(0)
        _check(lib.tk_tensor_get_shape(self._h, None, ctypes.byref(n)),
               "tensor_get_shape")
        arr = (ctypes.c_int64 * n.value)()
        _check(lib.tk_tensor_get_shape(self._h, arr, ctypes.byref(n)),
               "tensor_get_shape")
        return tuple(arr[: n.value])

    @property
    def dtype_id(self) -> int:
        d = ctypes.c_int()
        _check(_lib().tk_tensor_dtype(self._h, ctypes.byref(d)),
               "tensor_dtype")
        return d.value

    def to_numpy(self) -> np.ndarray:
        buf, n = self._mutable()
        out = np.empty(self.shape, _DTYPE_NP[self.dtype_id])
        ctypes.memmove(out.ctypes.data, buf, min(n, out.nbytes))
        return out

    def to_torch(self, device=None) -> torch.Tensor:
        """A copy of the tensor on ``device`` (by default the card)."""
        device = default_device(device, "NativeTensor.to_torch")
        return torch.from_numpy(self.to_numpy()).to(device)

    def reshape(self, shape: Sequence[int]) -> "NativeTensor":
        arr = (ctypes.c_int64 * len(shape))(*shape)
        _check(_lib().tk_tensor_reshape(self._h, arr, len(shape)),
               "tensor_reshape")
        return self

    def fill(self, value: float) -> "NativeTensor":
        _check(_lib().tk_tensor_fill(self._h, value), "tensor_fill")
        return self

    def add(self, other: "NativeTensor") -> "NativeTensor":
        out = NativeTensor(self.dtype_id, self.shape)
        _check(_lib().tk_tensor_add(self._h, other._h, out._h),
               "tensor_add")
        return out

    def matmul(self, other: "NativeTensor",
               blocked: bool = False, block_size: int = 0) -> "NativeTensor":
        m = self.shape[0]
        n = other.shape[1]
        out = NativeTensor(TK_F32, (m, n))
        if blocked:
            _check(_lib().tk_tensor_matmul_blocked(
                self._h, other._h, out._h, block_size), "matmul_blocked")
        else:
            _check(_lib().tk_tensor_matmul(self._h, other._h, out._h),
                   "matmul")
        return out

    def close(self) -> None:
        if self._h:
            _lib().tk_tensor_destroy(ctypes.byref(self._h))

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeAudioStream:
    """TkAudioStream frame FIFO (f32 only from Python)."""

    def __init__(self, sample_rate: int = 16000, channels: int = 1,
                 capacity_frames: int = 48000):
        h = ctypes.c_void_p()
        _check(_lib().tk_audio_stream_create(
            ctypes.byref(h), 2, sample_rate, channels, capacity_frames),
            "audio_stream_create")
        self._h = h
        self.channels = channels

    def write(self, samples: np.ndarray) -> int:
        a = np.ascontiguousarray(samples, np.float32)
        n = a.size // self.channels
        w = ctypes.c_size_t()
        _check(_lib().tk_audio_stream_write(
            self._h, a.ctypes.data_as(ctypes.c_void_p), n,
            ctypes.byref(w)), "audio_stream_write")
        return w.value

    def read(self, max_frames: int) -> np.ndarray:
        out = np.empty(max_frames * self.channels, np.float32)
        r = ctypes.c_size_t()
        _check(_lib().tk_audio_stream_read(
            self._h, out.ctypes.data_as(ctypes.c_void_p), max_frames,
            ctypes.byref(r)), "audio_stream_read")
        return out[: r.value * self.channels]

    def reset(self) -> None:
        _check(_lib().tk_audio_stream_reset(self._h), "audio_stream_reset")

    def close(self) -> None:
        if self._h:
            _lib().tk_audio_stream_destroy(ctypes.byref(self._h))

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeVisionFrame:
    """TkVisionFrame pixel staging buffer."""

    FMT_RGB24, FMT_BGR24, FMT_GRAY8 = 1, 2, 3

    def __init__(self, width: int, height: int, fmt: int = 1):
        h = ctypes.c_void_p()
        _check(_lib().tk_vision_frame_create(ctypes.byref(h), fmt,
                                             width, height),
               "vision_frame_create")
        self._h = h

    @property
    def info(self) -> Tuple[int, int, int]:
        fmt = ctypes.c_int()
        w = ctypes.c_uint32()
        hh = ctypes.c_uint32()
        _check(_lib().tk_vision_frame_get_info(
            self._h, ctypes.byref(fmt), ctypes.byref(w), ctypes.byref(hh)),
            "vision_frame_get_info")
        return fmt.value, w.value, hh.value

    def write(self, pixels: np.ndarray) -> None:
        a = np.ascontiguousarray(pixels, np.uint8)
        pdata = ctypes.c_void_p()
        nbytes = ctypes.c_size_t()
        _check(_lib().tk_vision_frame_get_mutable_data(
            self._h, ctypes.byref(pdata), ctypes.byref(nbytes)),
            "vision_frame_get_mutable_data")
        ctypes.memmove(pdata, a.ctypes.data, min(nbytes.value, a.nbytes))

    def _data(self) -> Tuple[ctypes.c_void_p, int]:
        pdata = ctypes.c_void_p()
        nbytes = ctypes.c_size_t()
        _check(_lib().tk_vision_frame_get_data(
            self._h, ctypes.byref(pdata), ctypes.byref(nbytes)),
            "vision_frame_get_data")
        return pdata, nbytes.value

    def read(self) -> np.ndarray:
        fmt, w, h = self.info
        ch = 1 if fmt == self.FMT_GRAY8 else 3
        pdata, nbytes = self._data()
        out = np.empty((h, w, ch), np.uint8)
        ctypes.memmove(out.ctypes.data, pdata, min(nbytes, out.nbytes))
        return out

    def close(self) -> None:
        if self._h:
            _lib().tk_vision_frame_destroy(ctypes.byref(self._h))

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _host_array(result) -> np.ndarray:
    """An executor's result on the host: a tensor is copied off its
    device explicitly."""
    if isinstance(result, torch.Tensor):
        return result.detach().cpu().numpy()
    return np.asarray(result)


Input = Union[np.ndarray, torch.Tensor, NativeTensor, None]


class NativeContext:
    """TkContext: module registry + async command bus.

    Python executors receive (command: str, input: torch.Tensor | None),
    the input copied to the device given at registration, and return a
    tensor, an array or None.
    """

    def __init__(self):
        h = ctypes.c_void_p()
        _check(_lib().tk_context_create(ctypes.byref(h)), "context_create")
        self._h = h
        self._trampolines: Dict[int, object] = {}  # keep CFUNCTYPEs alive
        self._callbacks: list = []

    def register_python_module(
            self, module_id: int,
            fn: Callable[[str, Optional[torch.Tensor]], object],
            device=None) -> None:
        """Install ``fn`` as module ``module_id``'s executor. Its input is
        copied to ``device`` (by default the card; the executor's thread
        enters it). An executor that raises fails the command with status
        -6, and the error is logged."""
        device = default_device(device, "register_python_module")

        # NativeTensor._adopt closes the handle in __del__ — borrowed
        # inputs are protected by nulling the handle after the copy.
        def tramp_safe(command, input_handle, output_pp, _state):
            try:
                enter = (torch.cuda.device(device) if device.type == "cuda"
                         else contextlib.nullcontext())
                with enter:
                    inp = None
                    if input_handle:
                        view = NativeTensor._adopt(input_handle)
                        inp = view.to_torch(device)
                        view._h = None  # borrowed; caller owns it
                    result = fn(command.decode(), inp)
                    if result is not None and output_pp:
                        t = NativeTensor.from_numpy(_host_array(result))
                        output_pp[0] = t._h.value
                        t._h = None
                return 0
            except Exception:
                log.exception("module %d executor failed on %r", module_id,
                              command)
                return -6

        cfn = _EXECUTOR(tramp_safe)
        self._trampolines[module_id] = cfn
        _check(_lib().tk_context_register_module(self._h, module_id, cfn,
                                                 None), "register_module")

    def unregister_module(self, module_id: int) -> None:
        _check(_lib().tk_context_unregister_module(self._h, module_id),
               "unregister_module")
        # A queued worker job may have copied the Module struct before
        # unregistration and could still call the trampoline — drain the
        # pool before dropping the ctypes trampoline reference (ADVICE
        # round 2: narrow use-after-free window).
        _lib().tk_context_drain(self._h)
        self._trampolines.pop(module_id, None)

    @staticmethod
    def _input(input_arr: Input) -> Tuple[Optional[NativeTensor], bool]:
        """(the input's handle owner, whether this call made it)."""
        if input_arr is None or isinstance(input_arr, NativeTensor):
            return input_arr, False
        return NativeTensor.from_numpy(_host_array(input_arr)), True

    def execute(self, module_id: int, command: str,
                input_arr: Input = None) -> Optional[np.ndarray]:
        """Synchronous module command; returns the output array."""
        inp, _ = self._input(input_arr)
        out_h = ctypes.c_void_p()
        _check(_lib().tk_module_execute_command(
            self._h, module_id, command.encode(),
            inp._h if inp else None, ctypes.byref(out_h), _CALLBACK(),
            None), "execute_command")
        if not out_h:
            return None
        t = NativeTensor._adopt(out_h)
        try:
            return t.to_numpy()
        finally:
            t.close()

    def execute_async(self, module_id: int, command: str,
                      input_arr: Input,
                      callback: Callable[[int, Optional[np.ndarray]], None],
                      ) -> None:
        """Queues on the context worker pool; callback(status, result).
        A ``NativeTensor`` input must stay open until the callback."""
        inp, owned = self._input(input_arr)

        def cb(status, result_handle, _ud):
            arr = None
            if result_handle:
                t = NativeTensor._adopt(result_handle)
                try:
                    arr = t.to_numpy()
                finally:
                    t.close()
            if owned:
                inp.close()  # input had to stay alive until completion
            # One-shot: release the ctypes ref once fired so _callbacks
            # doesn't grow without bound (ADVICE round 2).
            try:
                self._callbacks.remove(ccb)
            except ValueError:
                pass
            callback(status, arr)

        ccb = _CALLBACK(cb)
        self._callbacks.append(ccb)
        _check(_lib().tk_module_execute_command(
            self._h, module_id, command.encode(),
            inp._h if inp else None, None, ccb, None), "execute_command")

    def drain(self) -> None:
        _check(_lib().tk_context_drain(self._h), "context_drain")

    def close(self) -> None:
        if self._h:
            _lib().tk_context_destroy(ctypes.byref(self._h))

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def version() -> str:
    return _lib().tk_version_string().decode()


# ---------------------------------------------------------------------------
# Framework subsystems as modules
# ---------------------------------------------------------------------------

TK_MODULE_VISION = 10  # trackie_ffi.h TkModuleType
VISION_ROW = 8


def pack_vision_result(result) -> np.ndarray:
    """A ``VisionResult`` as an f32 (1 + N, 8) array for the C ABI: row 0
    holds the valid-analysis bits and N; each object row holds class id,
    confidence, the xyxy box, distance and minimum distance (NaN where the
    frame gave none)."""
    out = np.full((1 + len(result.objects), VISION_ROW), np.nan, np.float32)
    out[0, :2] = (int(result.valid_analyses), len(result.objects))
    for row, o in zip(out[1:], result.objects):
        row[:6] = (o.class_id, o.confidence, *o.box)
        if o.distance_m is not None:
            row[6] = o.distance_m
        if o.min_distance_m is not None:
            row[7] = o.min_distance_m
    return out


def vision_module(pipeline, flags=None
                  ) -> Callable[[str, Optional[torch.Tensor]], np.ndarray]:
    """An executor for :meth:`NativeContext.register_python_module` that
    runs ``pipeline.process_frame`` on the command's (H, W, 3) uint8 frame
    (command ``"process_frame"``) and returns :func:`pack_vision_result`."""
    from trackiellm_tpu_torch.vision.pipeline import AnalysisFlags

    flags = AnalysisFlags.ALL if flags is None else flags

    def execute(command: str, frame: Optional[torch.Tensor]) -> np.ndarray:
        if command != "process_frame" or frame is None:
            raise TrackieError(ErrorCode.INVALID_ARGUMENT,
                               f"vision module: no command {command!r} "
                               "with this input")
        return pack_vision_result(pipeline.process_frame(frame, flags))

    return execute
