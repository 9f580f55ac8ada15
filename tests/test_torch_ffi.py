"""The port's FFI layer: the JAX package's tests/test_ffi.py on
``trackiellm_tpu_torch.ffi`` (native C++ primitives: ring, queue, arena,
AEAD with the RFC 8439 vector; the module-command registry; the C++ RAII
header), then what the port adds: its library is built into
``_build/native-<hash>/`` and renamed into place (processes building at
once all load it), the pure-Python fallbacks on a host without a
compiler, and AEAD ciphertexts and tags byte-equal to the JAX package's
library on the RFC 8439 vector and on seeded messages."""

import threading
import time

import pytest

from trackiellm_tpu_torch.ffi import (
    ModuleRegistry,
    ModuleType,
    NativeArena,
    NativeEventQueue,
    NativeRingBuffer,
    aead_decrypt,
    aead_encrypt,
    constant_time_compare,
    native_available,
)
from trackiellm_tpu_torch.ffi import native
from trackiellm_tpu_torch.ops import _build
from trackiellm_tpu_torch.utils.errors import TrackieError


class TestNativeBuild:
    def test_library_compiles_and_loads(self):
        # The environment ships g++; the native path must be live.
        assert native_available()


class TestRingBuffer:
    def test_write_read_roundtrip(self):
        r = NativeRingBuffer(64)
        assert r.write(b"hello") == 5
        assert len(r) == 5
        assert r.read(5) == b"hello"
        assert len(r) == 0

    def test_wraparound(self):
        r = NativeRingBuffer(8)
        cap = r.capacity
        r.write(b"x" * (cap - 2))
        r.read(cap - 2)
        r.write(b"abcdef")  # wraps the physical end
        assert r.read(6) == b"abcdef"

    def test_full_rejects(self):
        r = NativeRingBuffer(8)
        cap = r.capacity
        assert r.write(b"a" * cap) == cap
        assert r.write(b"more") == 0

    def test_overwrite_mode_keeps_newest(self):
        r = NativeRingBuffer(8)
        cap = r.capacity
        r.write(bytes(range(cap)))
        r.write(b"NEW", overwrite=True)
        data = r.read(cap)
        assert data.endswith(b"NEW")
        assert len(data) == cap

    def test_threaded_spsc(self):
        r = NativeRingBuffer(1 << 12)
        total = 50_000
        received = bytearray()

        def producer():
            sent = 0
            while sent < total:
                chunk = bytes((i % 251 for i in range(sent, min(
                    sent + 997, total))))
                n = r.write(chunk)
                sent += n
                if n == 0:
                    time.sleep(0.0001)

        def consumer():
            while len(received) < total:
                got = r.read(1024)
                received.extend(got)
                if not got:
                    time.sleep(0.0001)

        tp = threading.Thread(target=producer)
        tc = threading.Thread(target=consumer)
        tp.start(); tc.start()
        tp.join(10); tc.join(10)
        assert bytes(received) == bytes(i % 251 for i in range(total))


class TestEventQueue:
    def test_push_pop(self):
        q = NativeEventQueue(capacity=4)
        assert q.push(7, b"payload")
        t, payload = q.pop(timeout_ms=100)
        assert t == 7 and payload == b"payload"

    def test_pop_timeout(self):
        q = NativeEventQueue(capacity=4)
        t0 = time.monotonic()
        assert q.pop(timeout_ms=50) is None
        assert time.monotonic() - t0 >= 0.04

    def test_full_drops_and_counts(self):
        q = NativeEventQueue(capacity=2)
        assert q.push(1) and q.push(2)
        assert not q.push(3)
        assert q.dropped == 1
        assert len(q) == 2

    def test_blocking_pop_wakes_on_push(self):
        q = NativeEventQueue(capacity=4)
        got = []

        def waiter():
            got.append(q.pop(timeout_ms=2000))

        t = threading.Thread(target=waiter)
        t.start()
        time.sleep(0.05)
        q.push(42, b"x")
        t.join(3)
        assert got and got[0][0] == 42


class TestArena:
    def test_aligned_bump(self):
        a = NativeArena(1024)
        o1 = a.alloc(10)
        o2 = a.alloc(10)
        assert o1 % 64 == 0 and o2 % 64 == 0 and o2 > o1
        assert a.used >= 20

    def test_exhaustion_and_reset(self):
        a = NativeArena(128)
        a.alloc(100)
        with pytest.raises(MemoryError):
            a.alloc(100)
        a.reset()
        assert a.alloc(100) == 0


class TestAEAD:
    def test_rfc8439_vector(self):
        """RFC 8439 section 2.8.2 test vector."""
        key = bytes(range(0x80, 0xA0))
        nonce = bytes.fromhex("070000004041424344454647")
        aad = bytes.fromhex("50515253c0c1c2c3c4c5c6c7")
        plaintext = (b"Ladies and Gentlemen of the class of '99: "
                     b"If I could offer you only one tip for the future, "
                     b"sunscreen would be it.")
        expected_ct = bytes.fromhex(
            "d31a8d34648e60db7b86afbc53ef7ec2"
            "a4aded51296e08fea9e2b5a736ee62d6"
            "3dbea45e8ca9671282fafb69da92728b"
            "1a71de0a9e060b2905d6a5b67ecd3b36"
            "92ddbd7f2d778b8c9803aee328091b58"
            "fab324e4fad675945585808b4831d7bc"
            "3ff4def08e4b7a9de576d26586cec64b"
            "6116")
        expected_tag = bytes.fromhex("1ae10b594f09e26a7e902ecbd0600691")
        out = aead_encrypt(key, nonce, plaintext, aad)
        assert out[:-16] == expected_ct
        assert out[-16:] == expected_tag

    def test_roundtrip_and_tamper(self):
        key = bytes(32)
        nonce = bytes(12)
        msg = b"estado de autenticacao"
        ct = aead_encrypt(key, nonce, msg, b"hdr")
        assert aead_decrypt(key, nonce, ct, b"hdr") == msg
        tampered = bytes([ct[0] ^ 1]) + ct[1:]
        with pytest.raises(ValueError):
            aead_decrypt(key, nonce, tampered, b"hdr")
        with pytest.raises(ValueError):
            aead_decrypt(key, nonce, ct, b"wrong-aad")

    def test_empty_plaintext(self):
        key = bytes(32)
        nonce = bytes(12)
        ct = aead_encrypt(key, nonce, b"")
        assert aead_decrypt(key, nonce, ct) == b""

    def test_constant_time_compare(self):
        assert constant_time_compare(b"abc", b"abc")
        assert not constant_time_compare(b"abc", b"abd")
        assert not constant_time_compare(b"abc", b"ab")


class TestModuleRegistry:
    def test_register_execute(self):
        reg = ModuleRegistry()
        reg.register(ModuleType.VISION,
                     lambda cmd, p: {"cmd": cmd, "echo": p.get("x")})
        out = reg.execute(ModuleType.VISION, "analyze", {"x": 1})
        assert out == {"cmd": "analyze", "echo": 1}
        reg.close()

    def test_duplicate_and_missing(self):
        reg = ModuleRegistry()
        reg.register(ModuleType.AUDIO, lambda c, p: None)
        with pytest.raises(TrackieError):
            reg.register(ModuleType.AUDIO, lambda c, p: None)
        with pytest.raises(TrackieError):
            reg.execute(ModuleType.CORTEX, "x")
        reg.unregister(ModuleType.AUDIO)
        assert ModuleType.AUDIO not in reg.registered()
        reg.close()

    def test_async_callback(self):
        reg = ModuleRegistry()
        reg.register(ModuleType.NAVIGATION, lambda c, p: c.upper())
        results = []
        done = threading.Event()

        def cb(result, error):
            results.append((result, error))
            done.set()

        reg.execute_async(ModuleType.NAVIGATION, "scan", callback=cb)
        assert done.wait(2.0)
        assert results == [("SCAN", None)]
        reg.close()

    def test_async_error_callback(self):
        reg = ModuleRegistry()

        def boom(c, p):
            raise RuntimeError("nope")

        reg.register(ModuleType.CUSTOM, boom)
        done = threading.Event()
        errs = []
        reg.execute_async(ModuleType.CUSTOM, "x",
                          callback=lambda r, e: (errs.append(e), done.set()))
        assert done.wait(2.0)
        assert isinstance(errs[0], RuntimeError)
        reg.close()


class TestCppWrappers:
    def test_raii_wrapper_compiles_and_runs(self, tmp_path):
        """Compile the header-only C++ RAII layer against the C ABI and
        run its assertions (parity: tk_ffi_cpp_api)."""
        import os
        import shutil
        import subprocess
        import textwrap

        if shutil.which("g++") is None:
            pytest.skip("no g++")
        native = os.path.join(os.path.dirname(__file__), "..",
                              "trackiellm_tpu_torch", "ffi", "native")
        src = tmp_path / "t.cpp"
        src.write_text(textwrap.dedent("""
            #include <cassert>
            #include "trackie_runtime.hpp"
            int main() {
                trackie::RingBuffer ring(64);
                const uint8_t msg[] = "abc";
                assert(ring.write(msg, 3) == 3);
                assert(ring.read(3).size() == 3);
                trackie::EventQueue q(2);
                assert(q.push(1, msg, 3));
                auto e = q.pop(50);
                assert(e && e->type == 1);
                uint8_t key[32] = {0}, nonce[12] = {0};
                std::vector<uint8_t> pt = {9, 9};
                assert(trackie::aead_decrypt(
                    key, nonce, trackie::aead_encrypt(key, nonce, pt)) == pt);
                return 0;
            }
        """))
        exe = tmp_path / "t"
        subprocess.run(
            ["g++", "-O1", "-std=c++17", f"-I{native}", str(src),
             os.path.join(native, "trackie_runtime.cpp"), "-o", str(exe)],
            check=True, capture_output=True, timeout=120)
        subprocess.run([str(exe)], check=True, timeout=30)


# --- what the port adds ---------------------------------------------------------

class TestPortBuild:
    def test_library_is_keyed_on_the_sources(self):
        assert native_available()
        path = native.library_path()
        assert path.exists()
        assert path.parent.name == f"native-{native._digest()}"
        assert path.parent.parent == _build.BUILD_ROOT

    def test_processes_building_at_once_all_load(self, tmp_path):
        """Three processes build into an empty directory together; each
        renames a whole library into place and loads it."""
        import os
        import subprocess
        import sys

        code = ("from trackiellm_tpu_torch.ffi import native; "
                "assert native.native_available(); "
                "print(native.library_path())")
        env = dict(os.environ, TRACKIE_BUILD_DIR=str(tmp_path))
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        procs = [subprocess.Popen([sys.executable, "-c", code], cwd=root,
                                  env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for _ in range(3)]
        outs = [p.communicate(timeout=300) for p in procs]
        assert all(p.returncode == 0 for p in procs), outs
        paths = {o.strip() for o, _ in outs}
        assert len(paths) == 1
        built = tmp_path / f"native-{native._digest()}"
        assert [f.name for f in built.iterdir()] == [native._LIB_NAME]


class TestFallbacks:
    @pytest.fixture
    def no_compiler(self, monkeypatch):
        monkeypatch.setattr(native, "_load", lambda: None)

    def test_ring_queue_arena_in_python(self, no_compiler):
        r = NativeRingBuffer(8)
        assert r.write(b"abc") == 3 and r.read(3) == b"abc"
        q = NativeEventQueue(capacity=1)
        assert q.push(5, b"p") and not q.push(6)
        assert q.pop(timeout_ms=10) == (5, b"p") and q.dropped == 1
        a = NativeArena(128)
        assert a.alloc(10) == 0 and a.alloc(10) == 64
        with pytest.raises(MemoryError):
            a.alloc(100)
        assert constant_time_compare(b"ab", b"ab")

    def test_aead_raises(self, no_compiler):
        with pytest.raises(RuntimeError):
            aead_encrypt(bytes(32), bytes(12), b"x")
        with pytest.raises(RuntimeError):
            aead_decrypt(bytes(32), bytes(12), bytes(17))


def _seeded(seed, n):
    import numpy as np
    rng = np.random.default_rng(seed)
    return (rng.bytes(32), rng.bytes(12), rng.bytes(n),
            rng.bytes(int(rng.integers(0, 40))))


class TestAeadAgainstTheJaxPackage:
    def test_rfc8439_vector_byte_equal(self):
        from trackiellm_tpu.ffi import native as jnative
        key = bytes(range(0x80, 0xA0))
        nonce = bytes.fromhex("070000004041424344454647")
        aad = bytes.fromhex("50515253c0c1c2c3c4c5c6c7")
        plaintext = (b"Ladies and Gentlemen of the class of '99: "
                     b"If I could offer you only one tip for the future, "
                     b"sunscreen would be it.")
        assert jnative.native_available()
        assert (aead_encrypt(key, nonce, plaintext, aad)
                == jnative.aead_encrypt(key, nonce, plaintext, aad))

    @pytest.mark.parametrize("seed,n", [(0, 0), (1, 1), (2, 63), (3, 64),
                                        (4, 65), (5, 1000), (6, 4099)])
    def test_seeded_messages_byte_equal(self, seed, n):
        from trackiellm_tpu.ffi import native as jnative
        key, nonce, msg, aad = _seeded(seed, n)
        ct = aead_encrypt(key, nonce, msg, aad)
        assert ct == jnative.aead_encrypt(key, nonce, msg, aad)
        assert len(ct) == n + 16
        assert jnative.aead_decrypt(key, nonce, ct, aad) == msg
        assert aead_decrypt(key, nonce, ct, aad) == msg
