"""ctypes bindings for the native C++ runtime (trackie_runtime.cpp) and
the embeddable C ABI (trackie_ffi.cpp), both in one shared library.

The library is compiled with g++ at first use into ``native-<hash>/``
under the CUDA kernels' build directory (``ops/_build.py``'s
``BUILD_ROOT``: ``$TRACKIE_BUILD_DIR``, else ``trackiellm_tpu_torch/_build``),
keyed on a hash of the sources, the headers and the flags, and renamed
into place from a temporary name by ``_build.build_once``, so that
processes importing this module together never load half a file. Every
primitive but AEAD has a pure-Python fallback for a host without a
compiler; AEAD raises there.
"""

from __future__ import annotations

import ctypes
import pathlib
import shutil
import subprocess
import threading
from typing import Optional, Tuple

from trackiellm_tpu_torch.ops import _build
from trackiellm_tpu_torch.utils.logging import get_logger

log = get_logger("ffi.native")

NATIVE_SRC = pathlib.Path(__file__).resolve().parent / "native"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")
_SOURCES = ("trackie_runtime.cpp", "trackie_ffi.cpp")
_LIB_NAME = "libtrackie_runtime.so"

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_build_failed = False


def _digest() -> str:
    return _build.digest(GXX_FLAGS, sorted(NATIVE_SRC.glob("trackie_*")))


def library_path(root: Optional[pathlib.Path] = None) -> pathlib.Path:
    """Where the library of this checkout's sources lives once built under
    ``root`` (by default ``_build.BUILD_ROOT``)."""
    return (pathlib.Path(root or _build.BUILD_ROOT) / f"native-{_digest()}"
            / _LIB_NAME)


def build() -> pathlib.Path:
    """Compile the sources with g++ unless a library with their hash
    exists; raise with g++'s stderr if it refuses them."""

    def make(tmp: pathlib.Path) -> pathlib.Path:
        gxx = shutil.which("g++")
        if gxx is None:
            raise FileNotFoundError("g++ not found on PATH")
        proc = subprocess.run(
            [gxx, *GXX_FLAGS, "-o", str(tmp / _LIB_NAME),
             *(str(NATIVE_SRC / s) for s in _SOURCES)],
            capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise subprocess.CalledProcessError(
                proc.returncode, proc.args, proc.stdout, proc.stderr)
        return tmp / _LIB_NAME

    out = library_path()
    _build.build_once(out, make)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lib_lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            path = build()
        except (subprocess.SubprocessError, OSError) as e:
            log.warning("native build failed (falling back to Python): %s",
                        getattr(e, "stderr", None) or e)
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            log.warning("native load failed: %s", e)
            _build_failed = True
            return None
        _declare(lib)
        _lib = lib
        return _lib


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    u8p = c.POINTER(c.c_uint8)
    lib.tk_ring_create.restype = c.c_void_p
    lib.tk_ring_create.argtypes = [c.c_size_t]
    lib.tk_ring_destroy.argtypes = [c.c_void_p]
    lib.tk_ring_size.restype = c.c_size_t
    lib.tk_ring_size.argtypes = [c.c_void_p]
    lib.tk_ring_capacity.restype = c.c_size_t
    lib.tk_ring_capacity.argtypes = [c.c_void_p]
    for fn in (lib.tk_ring_write, lib.tk_ring_read,
               lib.tk_ring_write_overwrite):
        fn.restype = c.c_size_t
        fn.argtypes = [c.c_void_p, u8p, c.c_size_t]

    lib.tk_queue_create.restype = c.c_void_p
    lib.tk_queue_create.argtypes = [c.c_size_t]
    lib.tk_queue_destroy.argtypes = [c.c_void_p]
    lib.tk_queue_push.restype = c.c_int
    lib.tk_queue_push.argtypes = [c.c_void_p, c.c_int32, u8p, c.c_size_t]
    lib.tk_queue_pop.restype = c.c_int64
    lib.tk_queue_pop.argtypes = [c.c_void_p, c.POINTER(c.c_int32), u8p,
                                 c.c_size_t, c.c_int64,
                                 c.POINTER(c.c_size_t)]
    lib.tk_queue_count.restype = c.c_size_t
    lib.tk_queue_count.argtypes = [c.c_void_p]
    lib.tk_queue_dropped.restype = c.c_uint64
    lib.tk_queue_dropped.argtypes = [c.c_void_p]

    lib.tk_arena_create.restype = c.c_void_p
    lib.tk_arena_create.argtypes = [c.c_size_t]
    lib.tk_arena_destroy.argtypes = [c.c_void_p]
    lib.tk_arena_alloc.restype = c.c_int64
    lib.tk_arena_alloc.argtypes = [c.c_void_p, c.c_size_t]
    lib.tk_arena_used.restype = c.c_size_t
    lib.tk_arena_used.argtypes = [c.c_void_p]
    lib.tk_arena_reset.argtypes = [c.c_void_p]

    lib.tk_ct_memcmp.restype = c.c_int
    lib.tk_ct_memcmp.argtypes = [u8p, u8p, c.c_size_t]
    lib.tk_aead_encrypt.argtypes = [u8p, u8p, u8p, c.c_size_t, u8p,
                                    c.c_size_t, u8p, u8p]
    lib.tk_aead_decrypt.restype = c.c_int
    lib.tk_aead_decrypt.argtypes = [u8p, u8p, u8p, c.c_size_t, u8p,
                                    c.c_size_t, u8p, u8p]


def native_available() -> bool:
    return _load() is not None


def _as_u8p(data: bytes):
    return ctypes.cast(ctypes.create_string_buffer(data, len(data)),
                       ctypes.POINTER(ctypes.c_uint8))


# ---------------------------------------------------------------------------
# Ring buffer
# ---------------------------------------------------------------------------

class NativeRingBuffer:
    """SPSC byte ring (native when available, deque fallback).

    Parity: the cortex audio/video rings (tk_cortex_main.c:542-543).
    """

    def __init__(self, capacity: int):
        import threading

        self._lib = _load()
        # tk_ring_write_overwrite mutates BOTH head and tail (it drops
        # the oldest bytes), which breaks the lock-free SPSC contract —
        # a concurrent read() could tear. This lock restores safety for
        # every combination of callers; the non-overwrite fast path pays
        # one uncontended mutex acquire per chunk (cold next to the
        # ctypes call itself).
        self._mu = threading.Lock()
        if self._lib:
            self._h = self._lib.tk_ring_create(capacity)
        else:
            import collections

            self._buf = collections.deque(maxlen=1 << max(
                capacity - 1, 1).bit_length())

    def write(self, data: bytes, overwrite: bool = False) -> int:
        with self._mu:
            if self._lib:
                fn = (self._lib.tk_ring_write_overwrite if overwrite
                      else self._lib.tk_ring_write)
                return int(fn(self._h, _as_u8p(data), len(data)))
            if overwrite:
                self._buf.extend(data)
                return len(data)
            free = self._buf.maxlen - len(self._buf)
            take = min(free, len(data))
            self._buf.extend(data[:take])
            return take

    def read(self, n: int) -> bytes:
        with self._mu:
            if self._lib:
                out = (ctypes.c_uint8 * n)()
                got = int(self._lib.tk_ring_read(self._h, out, n))
                return bytes(out[:got])
            take = min(n, len(self._buf))
            return bytes(self._buf.popleft() for _ in range(take))

    def __len__(self) -> int:
        with self._mu:
            if self._lib:
                return int(self._lib.tk_ring_size(self._h))
            return len(self._buf)

    @property
    def capacity(self) -> int:
        if self._lib:
            return int(self._lib.tk_ring_capacity(self._h))
        return self._buf.maxlen

    def __del__(self):
        if getattr(self, "_lib", None) and getattr(self, "_h", None):
            self._lib.tk_ring_destroy(self._h)
            self._h = None


# ---------------------------------------------------------------------------
# Event queue
# ---------------------------------------------------------------------------

class NativeEventQueue:
    """Bounded deep-copy event queue (native mutex+condvar ring, the
    cortex queue's exact shape — tk_cortex_main.c:231-366)."""

    MAX_PAYLOAD = 1 << 20

    def __init__(self, capacity: int = 128):
        self._lib = _load()
        if self._lib:
            self._h = self._lib.tk_queue_create(capacity)
        else:
            import queue as _q

            self._q = _q.Queue(maxsize=capacity)
            self._dropped = 0

    def push(self, event_type: int, payload: bytes = b"") -> bool:
        if self._lib:
            return bool(self._lib.tk_queue_push(
                self._h, event_type, _as_u8p(payload), len(payload)))
        import queue as _q

        try:
            self._q.put_nowait((event_type, payload))
            return True
        except _q.Full:
            self._dropped += 1
            return False

    def pop(self, timeout_ms: int = 100) -> Optional[Tuple[int, bytes]]:
        if self._lib:
            t = ctypes.c_int32(0)
            size = ctypes.c_size_t(0)
            out = (ctypes.c_uint8 * self.MAX_PAYLOAD)()
            got = int(self._lib.tk_queue_pop(
                self._h, ctypes.byref(t), out, self.MAX_PAYLOAD,
                timeout_ms, ctypes.byref(size)))
            if got < 0:
                return None
            return int(t.value), bytes(out[:got])
        import queue as _q

        try:
            return self._q.get(timeout=timeout_ms / 1000.0)
        except _q.Empty:
            return None

    def __len__(self) -> int:
        if self._lib:
            return int(self._lib.tk_queue_count(self._h))
        return self._q.qsize()

    @property
    def dropped(self) -> int:
        if self._lib:
            return int(self._lib.tk_queue_dropped(self._h))
        return self._dropped

    def __del__(self):
        if getattr(self, "_lib", None) and getattr(self, "_h", None):
            self._lib.tk_queue_destroy(self._h)
            self._h = None


# ---------------------------------------------------------------------------
# Arena
# ---------------------------------------------------------------------------

class NativeArena:
    """Bump allocator handing out offsets into one native block
    (parity: the GPU memory manager's slab intent,
    src/ai_models/tk_memory_manager.h)."""

    def __init__(self, capacity: int):
        self._lib = _load()
        self.capacity = capacity
        if self._lib:
            self._h = self._lib.tk_arena_create(capacity)
        else:
            self._offset = 0
            self._allocs = 0

    def alloc(self, n: int) -> int:
        """Returns the 64-byte-aligned offset, or raises MemoryError."""
        if self._lib:
            off = int(self._lib.tk_arena_alloc(self._h, n))
        else:
            aligned = (self._offset + 63) & ~63
            off = aligned if aligned + n <= self.capacity else -1
            if off >= 0:
                self._offset = aligned + n
                self._allocs += 1
        if off < 0:
            raise MemoryError(f"arena exhausted allocating {n} bytes")
        return off

    @property
    def used(self) -> int:
        if self._lib:
            return int(self._lib.tk_arena_used(self._h))
        return self._offset

    def reset(self) -> None:
        if self._lib:
            self._lib.tk_arena_reset(self._h)
        else:
            self._offset = 0

    def __del__(self):
        if getattr(self, "_lib", None) and getattr(self, "_h", None):
            self._lib.tk_arena_destroy(self._h)
            self._h = None


# ---------------------------------------------------------------------------
# Security primitives
# ---------------------------------------------------------------------------

def constant_time_compare(a: bytes, b: bytes) -> bool:
    if len(a) != len(b):
        return False
    lib = _load()
    if lib:
        return lib.tk_ct_memcmp(_as_u8p(a), _as_u8p(b), len(a)) == 0
    import hmac

    return hmac.compare_digest(a, b)


def aead_encrypt(key: bytes, nonce: bytes, plaintext: bytes,
                 aad: bytes = b"") -> bytes:
    """ChaCha20-Poly1305 (RFC 8439): returns ciphertext || tag(16).
    Parity: tk_encryption.c's AEAD surface."""
    assert len(key) == 32 and len(nonce) == 12
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "native AEAD unavailable (no toolchain) — no Python fallback "
            "is provided for crypto by design")
    out = (ctypes.c_uint8 * max(len(plaintext), 1))()
    tag = (ctypes.c_uint8 * 16)()
    lib.tk_aead_encrypt(_as_u8p(key), _as_u8p(nonce), _as_u8p(aad),
                        len(aad), _as_u8p(plaintext), len(plaintext),
                        out, tag)
    return bytes(out[:len(plaintext)]) + bytes(tag)


def aead_decrypt(key: bytes, nonce: bytes, ciphertext_and_tag: bytes,
                 aad: bytes = b"") -> bytes:
    """Verifies the tag (constant time) then decrypts; raises ValueError
    on authentication failure."""
    assert len(key) == 32 and len(nonce) == 12
    assert len(ciphertext_and_tag) >= 16
    lib = _load()
    if lib is None:
        raise RuntimeError("native AEAD unavailable")
    n = len(ciphertext_and_tag) - 16
    ct, tag = ciphertext_and_tag[:n], ciphertext_and_tag[n:]
    out = (ctypes.c_uint8 * max(n, 1))()
    rc = lib.tk_aead_decrypt(_as_u8p(key), _as_u8p(nonce), _as_u8p(aad),
                             len(aad), _as_u8p(ct), n, _as_u8p(tag), out)
    if rc != 0:
        raise ValueError("AEAD authentication failed")
    return bytes(out[:n])
