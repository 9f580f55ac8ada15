"""The port's services and interaction modules: the JAX package's
tests/test_services.py on ``trackiellm_tpu_torch``, then what the port
adds or changes: ``device_trace`` over ``torch.profiler`` writing a trace
file, ``MetricsCollector._device`` on ``torch.cuda`` ({} for a CPU
caller), and the two packages reading each other's encrypted auth state
and wire frames byte for byte.
"""

import hashlib
import socket
import threading
import time

import pytest
import torch

from trackiellm_tpu_torch.services import (
    ConnectionPool,
    DeploymentService,
    ExperimentService,
    FrameDecoder,
    MetricsCollector,
    MonitoringService,
    PluginManager,
    Profiler,
    TelemetrySender,
    encode_frame,
)
from trackiellm_tpu_torch.services.deployment import parse_version
from trackiellm_tpu_torch.services.monitoring import TelemetryConfig
from trackiellm_tpu_torch.services.networking import KIND_BLOB, KIND_JSON
from trackiellm_tpu_torch.services.security import AuthManager
from trackiellm_tpu_torch.interaction import (
    CommandParser,
    FeedbackManager,
    FeedbackPriority,
)
from trackiellm_tpu_torch.utils.errors import TrackieError


class TestMonitoring:
    def test_collect_has_core_metrics(self):
        m = MetricsCollector().collect()
        assert "ts" in m
        assert "mem_total_bytes" in m
        assert "rss_bytes" in m

    def test_telemetry_batching(self):
        s = TelemetrySender(TelemetryConfig(batch_size=3))
        for i in range(7):
            s.record({"i": i})
        assert s.sent_batches == 2
        s.flush()
        assert s.sent_batches == 3
        assert sum(len(b) for b in s.spool) == 7

    def test_transport_injection(self):
        sent = []
        s = TelemetrySender(
            TelemetryConfig(batch_size=1, auth_token="tok"),
            transport=lambda ep, hdr, batch: sent.append(
                (ep, hdr["authorization"], batch)) or True)
        s.record({"x": 1})
        assert sent[0][1] == "Bearer tok"

    def test_service_loop(self):
        svc = MonitoringService(interval_s=0.05)
        svc.start()
        time.sleep(0.15)
        svc.stop()
        assert svc.last_metrics
        assert svc.sender.spool or svc.sender.sent_batches >= 0


class TestProfiler:
    def test_scopes_and_report(self):
        p = Profiler()
        p.start()
        with p.scope("stage_a"):
            time.sleep(0.01)
        with p.scope("stage_a"):
            time.sleep(0.005)
        with p.scope("stage_b"):
            pass
        report = p.stop()
        assert report.by_scope["stage_a"].count == 2
        assert report.by_scope["stage_a"].mean_ms >= 5.0
        assert report.by_scope["stage_a"].max_ms >= \
            report.by_scope["stage_a"].min_ms
        assert len(report.samples) == 3

    def test_inactive_records_nothing(self):
        p = Profiler()
        with p.scope("x"):
            pass
        p.start()
        report = p.stop()
        assert report.samples == []


class TestSecurity:
    def test_pin_set_verify(self):
        a = AuthManager()
        assert not a.has_pin
        a.set_pin("1234")
        assert a.verify_pin("1234")
        assert not a.verify_pin("9999")

    def test_pin_too_short(self):
        with pytest.raises(TrackieError):
            AuthManager().set_pin("12")

    def test_sessions_and_permissions(self):
        a = AuthManager(session_ttl_s=100.0)
        a.set_pin("4321")
        s = a.create_session("4321", permissions=["vision.read"])
        assert a.check_permission(s.session_id, "vision.read")
        assert not a.check_permission(s.session_id, "memory.write")
        assert a.revoke_session(s.session_id)
        assert not a.check_permission(s.session_id, "vision.read")

    def test_wrong_pin_rejected(self):
        a = AuthManager()
        a.set_pin("1234")
        with pytest.raises(TrackieError):
            a.create_session("0000")

    def test_session_expiry(self):
        a = AuthManager(session_ttl_s=0.01)
        a.set_pin("1234")
        s = a.create_session("1234")
        time.sleep(0.02)
        assert not a.check_permission(s.session_id, "x")
        assert a.prune_expired() == 1

    def test_encrypted_state_roundtrip(self, tmp_path):
        path = str(tmp_path / "auth.bin")
        a = AuthManager(state_path=path)
        a.set_pin("1234")
        a.create_session("1234")
        a.save_state("1234")

        b = AuthManager(state_path=path)
        b.load_state("1234")
        assert b.device_id == a.device_id
        assert b.verify_pin("1234")
        # Wrong PIN cannot decrypt.
        c = AuthManager(state_path=path)
        with pytest.raises(TrackieError):
            c.load_state("9999")


class TestNetworking:
    def test_frame_roundtrip(self):
        dec = FrameDecoder()
        frames = dec.feed(encode_frame({"op": "ping"})
                          + encode_frame(b"\x01\x02", kind=KIND_BLOB))
        assert frames[0] == (KIND_JSON, {"op": "ping"})
        assert frames[1] == (KIND_BLOB, b"\x01\x02")

    def test_incremental_decode(self):
        data = encode_frame({"n": 42})
        dec = FrameDecoder()
        assert dec.feed(data[:3]) == []
        assert dec.feed(data[3:10]) == []
        assert dec.feed(data[10:]) == [(KIND_JSON, {"n": 42})]

    def test_bad_magic_raises(self):
        dec = FrameDecoder()
        with pytest.raises(TrackieError):
            dec.feed(b"\x00\x00\x01\x00\x04\x00\x00\x00abcd")

    def test_connection_pool_over_loopback(self):
        server = socket.create_server(("127.0.0.1", 0))
        host, port = server.getsockname()
        echoes = []

        def serve():
            conn, _ = server.accept()
            dec = FrameDecoder()
            data = conn.recv(65536)
            for kind, payload in dec.feed(data):
                echoes.append(payload)
                conn.sendall(encode_frame({"echo": payload}))
            conn.close()

        t = threading.Thread(target=serve, daemon=True)
        t.start()
        pool = ConnectionPool()
        c = pool.acquire(host, port)
        c.send({"hello": 1})
        kind, reply = c.recv_frame(timeout=3.0)
        assert reply == {"echo": {"hello": 1}}
        pool.release(host, port, c)
        # Reuse gets the same connection object back.
        c2 = pool.acquire(host, port)
        assert c2 is c
        pool.close_all()
        server.close()
        assert pool.created == 1


class TestDeployment:
    def test_version_parse_and_compare(self):
        assert parse_version("v1.2.3") == (1, 2, 3)
        assert parse_version("2.0") > parse_version("1.9.9")

    def test_update_flow_with_verification(self, tmp_path):
        payload = b"new model weights"
        manifest = {
            "version": "1.1.0",
            "url": "https://updates.invalid/pkg",
            "sha256": hashlib.sha256(payload).hexdigest(),
            "filename": "pkg.bin",
        }
        svc = DeploymentService(
            "1.0.0", str(tmp_path),
            query_fn=lambda: manifest,
            download_fn=lambda url: payload)
        installed = svc.update_if_available()
        assert installed and installed.endswith("pkg.bin")
        with open(installed, "rb") as f:
            assert f.read() == payload

    def test_digest_mismatch_refused(self, tmp_path):
        manifest = {"version": "2.0.0", "url": "u",
                    "sha256": "00" * 32, "filename": "x"}
        svc = DeploymentService("1.0.0", str(tmp_path),
                                query_fn=lambda: manifest,
                                download_fn=lambda url: b"evil")
        with pytest.raises(TrackieError):
            svc.update_if_available()

    def test_no_update_when_current(self, tmp_path):
        svc = DeploymentService(
            "2.0.0", str(tmp_path),
            query_fn=lambda: {"version": "1.0.0"})
        assert svc.update_if_available() is None


class TestPlugins:
    PLUGIN_SRC = '''
PLUGIN_NAME = "greeter"
PLUGIN_VERSION = "1.2.0"

def register(api):
    base = api.get("greeting", "ola")
    return {"greet": lambda name: f"{base}, {name}!"}
'''

    def test_load_and_call(self, tmp_path):
        (tmp_path / "greeter.py").write_text(self.PLUGIN_SRC)
        pm = PluginManager(api={"greeting": "oi"})
        loaded = pm.load_directory(str(tmp_path))
        assert [p.name for p in loaded] == ["greeter"]
        assert pm.get("greeter").version == "1.2.0"
        assert pm.call("greeter", "greet", "Ana") == "oi, Ana!"

    def test_bad_plugin_rejected(self, tmp_path):
        (tmp_path / "bad.py").write_text("raise RuntimeError('boom')\n")
        pm = PluginManager()
        assert pm.load_directory(str(tmp_path)) == []

    def test_missing_register_rejected(self, tmp_path):
        (tmp_path / "noreg.py").write_text("x = 1\n")
        pm = PluginManager()
        with pytest.raises(TrackieError):
            pm.load_file(str(tmp_path / "noreg.py"))


class TestExperiments:
    def test_benchmark_and_summary(self):
        svc = ExperimentService()
        vals = iter([10.0, 12.0, 11.0])
        out = svc.benchmark("llm_a", "tok_s", lambda: next(vals))
        assert out["count"] == 3
        assert out["mean"] == pytest.approx(11.0)

    def test_ab_regression_detection(self):
        svc = ExperimentService(regression_threshold_pct=5.0)
        for v in (100.0, 102.0):
            svc.analysis.record("base", "tok_s", v)
        for v in (80.0, 82.0):
            svc.analysis.record("cand", "tok_s", v)
        cmp = svc.ab_test("tok_s", "base", "cand")
        assert cmp.is_regression and not cmp.is_improvement

    def test_latency_direction(self):
        svc = ExperimentService()
        svc.analysis.record("base", "latency_ms", 100.0)
        svc.analysis.record("cand", "latency_ms", 50.0)
        cmp = svc.ab_test("latency_ms", "base", "cand",
                          higher_is_better=False)
        assert cmp.is_improvement


class TestFeedbackManager:
    def test_dedup_updates_priority(self):
        spoken = []
        fm = FeedbackManager(speak_fn=lambda m, p: spoken.append((m, p)))
        fm.submit("obstáculo à frente", FeedbackPriority.NORMAL)
        fm.submit("obstáculo à frente", FeedbackPriority.CRITICAL)
        assert fm.pending == 1
        fm.process()
        assert spoken == [("obstáculo à frente",
                           int(FeedbackPriority.CRITICAL))]

    def test_priority_drain_order(self):
        spoken = []
        fm = FeedbackManager(speak_fn=lambda m, p: spoken.append(m))
        fm.submit("info", FeedbackPriority.LOW)
        fm.submit("ALERTA", FeedbackPriority.CRITICAL)
        fm.process(max_messages=2)
        assert spoken == ["ALERTA", "info"]

    def test_recently_spoken_suppressed(self):
        fm = FeedbackManager(speak_fn=lambda m, p: None,
                             dedup_window_s=10.0)
        fm.submit("mesmo aviso")
        fm.process()
        assert not fm.submit("mesmo aviso")  # inside window
        assert fm.submit("mesmo aviso", FeedbackPriority.CRITICAL)


class TestCommandParser:
    def test_intents(self):
        p = CommandParser()
        assert p.parse("o que você vê?").intent == "describe_scene"
        assert p.parse("pare tudo agora").intent == "emergency_stop"
        assert p.parse("what do you see").intent == "describe_scene"
        assert p.parse("repete por favor").intent == "repeat"

    def test_slot_extraction(self):
        p = CommandParser()
        cmd = p.parse("onde está minha xícara")
        assert cmd.intent == "find_object"
        assert cmd.slots["object"] == "xicara"

    def test_no_match(self):
        assert CommandParser().parse("xyzzy plugh") is None

    def test_custom_intent(self):
        p = CommandParser()
        p.add_intent("volume_up", (("aumenta", "volume"),))
        assert p.parse("aumenta o volume").intent == "volume_up"


# --- what the port adds or changes ---------------------------------------------

class TestDeviceMetrics:
    def test_device_is_empty_for_a_cpu_caller(self):
        m = MetricsCollector(device="cpu")
        assert m._device() == {}
        assert not any(k.startswith("device_") for k in m.collect())

    @pytest.mark.skipif(torch.cuda.is_available(), reason="a card is here")
    def test_default_reads_no_device_without_a_card(self):
        assert MetricsCollector().device is None
        assert MetricsCollector()._device() == {}


class TestDeviceTrace:
    def test_cpu_trace_file_holds_the_ops(self, tmp_path):
        import json

        from trackiellm_tpu_torch.services.profiling import device_trace
        a = torch.ones((8, 8))
        with device_trace(str(tmp_path / "traces")) as prof:
            (a @ a).sum()
        with open(prof.trace_path) as f:
            events = json.load(f)["traceEvents"]
        assert prof.trace_path.startswith(str(tmp_path / "traces"))
        assert any("aten::mm" in e.get("name", "") for e in events)

    def test_a_failing_block_raises_and_writes_nothing(self, tmp_path):
        from trackiellm_tpu_torch.services.profiling import device_trace
        with pytest.raises(ValueError):
            with device_trace(str(tmp_path)):
                raise ValueError("inside")
        assert list(tmp_path.iterdir()) == []


class TestAgainstTheJaxPackage:
    def test_each_reads_the_others_encrypted_state(self, tmp_path):
        from trackiellm_tpu.services.security import AuthManager as JAuth
        for write, read in ((AuthManager, JAuth), (JAuth, AuthManager)):
            path = str(tmp_path / f"{write.__module__}.bin")
            a = write(state_path=path)
            a.set_pin("2468")
            a.save_state("2468")
            b = read(state_path=path)
            b.load_state("2468")
            assert b.device_id == a.device_id and b.verify_pin("2468")

    @pytest.mark.parametrize("payload,kind", [({"op": "ping", "n": 3}, None),
                                              (b"\x00\x01\xff", "blob")])
    def test_frames_are_the_jax_packages_bytes(self, payload, kind):
        from trackiellm_tpu.services import networking as jnet
        kw = {} if kind is None else {"kind": KIND_BLOB}
        assert encode_frame(payload, **kw) == jnet.encode_frame(payload, **kw)
