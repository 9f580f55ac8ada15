"""The port's runtime (event bus, task manager, watchdog, the feeder, the
inference scheduler and the workers) on the CPU: twins of
tests/test_runtime.py's cases, the scheduler's completion barrier, and its
host logic held to the JAX package's (the same syntax tree, docstrings
aside).

Every threaded case waits on events with a deadline of a few seconds and
joins with a timeout.
"""

import ast
import inspect
import threading
import time

import numpy as np
import pytest
import torch

from trackiellm_tpu.runtime import scheduler as jscheduler
from trackiellm_tpu.runtime import workers as jworkers
from trackiellm_tpu_torch.runtime import (
    DoubleBufferedFeeder,
    EventBus,
    InferenceScheduler,
    JobKind,
    TaskManager,
)
from trackiellm_tpu_torch.runtime import scheduler as tscheduler
from trackiellm_tpu_torch.runtime import workers as tworkers
from trackiellm_tpu_torch.runtime.event_bus import EventKind
from trackiellm_tpu_torch.runtime.scheduler import SKIPPED, _block
from trackiellm_tpu_torch.runtime.watchdog import Watchdog

CPU = torch.device("cpu")


class TestEventBus:
    def test_broadcast_to_all_subscribers(self):
        bus = EventBus()
        a, b = bus.subscribe(), bus.subscribe()
        assert bus.publish(EventKind.SPEAK, "olá") == 2
        assert a.recv(0.1).payload == "olá"
        assert b.recv(0.1).payload == "olá"

    def test_lagging_subscriber_drops_oldest(self):
        bus = EventBus(capacity=4)
        sub = bus.subscribe()
        for i in range(10):
            bus.publish(EventKind.VISION_RESULT, i)
        events = sub.drain()
        assert [e.payload for e in events] == [6, 7, 8, 9]
        assert sub.lagged == 6

    def test_sync_callbacks(self):
        bus = EventBus()
        got = []
        bus.on(EventKind.SHUTDOWN, lambda e: got.append(e.kind))
        bus.publish(EventKind.SPEAK)
        bus.shutdown()
        assert got == [EventKind.SHUTDOWN]

    def test_unsubscribe(self):
        bus = EventBus()
        sub = bus.subscribe()
        bus.unsubscribe(sub)
        assert bus.publish(EventKind.SPEAK) == 0


class TestTaskManager:
    def test_spawn_and_cooperative_cancel(self):
        tm = TaskManager()
        ran = threading.Event()

        def task(stop):
            ran.set()
            stop.wait(5.0)

        tm.spawn("t", task)
        assert ran.wait(2.0)
        assert tm.status()["t"]
        assert tm.cancel("t")
        assert tm.join_all(timeout=2.0) == []

    def test_crash_captured_at_join(self):
        tm = TaskManager()

        def bad(stop):
            raise RuntimeError("worker panic")

        tm.spawn("bad", bad)
        tm.join_all(timeout=1.0)
        assert "worker panic" in str(tm.errors()["bad"])

    def test_duplicate_name_rejected(self):
        tm = TaskManager()
        tm.spawn("x", lambda stop: stop.wait(2.0))
        with pytest.raises(ValueError):
            tm.spawn("x", lambda stop: None)
        tm.join_all(1.0)


class TestFeeder:
    def test_put_get(self):
        f = DoubleBufferedFeeder(depth=2, device=CPU)
        f.put(np.ones((4, 4), np.float32))
        out = f.get(timeout=1.0)
        assert isinstance(out, torch.Tensor) and out.shape == (4, 4)

    def test_realtime_get_takes_newest(self):
        f = DoubleBufferedFeeder(depth=2, device=CPU)
        f.put(np.full((2,), 1.0, np.float32))
        f.put(np.full((2,), 2.0, np.float32))
        assert float(f.get(timeout=1.0)[0]) == 2.0
        assert f.dropped >= 1

    def test_overflow_drops(self):
        f = DoubleBufferedFeeder(depth=2, device=CPU)
        for i in range(5):
            f.put(np.full((2,), float(i), np.float32))
        assert f.dropped == 3
        assert f.transferred == 5

    def test_fifo_variant(self):
        f = DoubleBufferedFeeder(depth=4, device=CPU)
        f.put(np.full((2,), 1.0, np.float32))
        f.put(np.full((2,), 2.0, np.float32))
        assert float(f.get_in_order(1.0)[0]) == 1.0
        assert float(f.get_in_order(1.0)[0]) == 2.0

    def test_copies_and_preprocesses_on_its_device(self):
        """The host buffer may be reused after put; preprocess runs on the
        staged tensor."""
        host = np.arange(6, dtype=np.float32)
        f = DoubleBufferedFeeder(depth=2, device=CPU,
                                 preprocess=lambda t: t * 2)
        f.put(host)
        host[:] = -1
        assert f.get(timeout=1.0).tolist() == [0, 2, 4, 6, 8, 10]
        assert f.get(timeout=0.01) is None

    def test_needs_a_card_or_the_cpu(self, monkeypatch):
        from trackiellm_tpu_torch.utils.errors import TrackieError
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(TrackieError, match="DoubleBufferedFeeder"):
            DoubleBufferedFeeder()


class TestScheduler:
    def test_run_returns_result(self):
        s = InferenceScheduler()
        assert s.run(JobKind.OTHER, lambda x: x + 1, 41, timeout=5.0) == 42
        s.close()

    def test_priority_ordering(self):
        s = InferenceScheduler()
        order = []
        gate = threading.Event()

        def job(tag):
            order.append(tag)
            return tag

        s.submit(JobKind.OTHER, lambda: gate.wait(2.0))
        time.sleep(0.05)
        futs = [s.submit(JobKind.LLM_DECODE, job, "decode"),
                s.submit(JobKind.VISION, job, "vision"),
                s.submit(JobKind.VAD, job, "vad")]
        gate.set()
        for f in futs:
            f.result(timeout=5.0)
        assert order == ["vad", "decode", "vision"]
        s.close()

    def test_stats_recorded(self):
        s = InferenceScheduler()
        s.run(JobKind.VISION, lambda: time.sleep(0.01), timeout=5.0)
        assert s.stats["vision"]["count"] == 1
        assert s.stats["vision"]["ema_ms"] > 0
        s.close()

    def test_exception_propagates(self):
        s = InferenceScheduler()
        fut = s.submit(JobKind.ASR, lambda: 1 / 0)
        with pytest.raises(ZeroDivisionError):
            fut.result(timeout=5.0)
        s.close()

    def test_tensor_results_pass_the_barrier(self):
        s = InferenceScheduler()
        x = torch.arange(4.0)
        out = s.run(JobKind.VISION, lambda: (x * 2, {"y": [x]}, "text"),
                    timeout=5.0)
        assert out[0].tolist() == [0, 2, 4, 6] and out[2] == "text"
        s.close()


class TestBarrier:
    def test_cpu_tensor_string_numpy_generator_pass_through(self):
        t = torch.ones(3)
        assert _block(t) is t
        assert _block("olá") == "olá"
        a = np.zeros(2)
        assert _block(a) is a
        gen = iter([1, 2])
        assert _block(gen) is gen
        assert _block(SKIPPED) is SKIPPED
        nested = (t, [t, {"k": t}])
        assert _block(nested) is nested

    def test_waits_for_every_card_of_the_result(self, monkeypatch):
        """A CUDA tensor anywhere in a tuple, list or dict makes the barrier
        wait for the current stream of its card (stubbed here: no card)."""
        waited = []

        class Stream:
            def __init__(self, dev):
                self.dev = dev

            def synchronize(self):
                waited.append(self.dev)

        class CardTensor(torch.Tensor):
            is_cuda = True

            @property
            def device(self):
                return torch.device("cuda", 1)

        t = torch.ones(2).as_subclass(CardTensor)
        monkeypatch.setattr(torch.cuda, "current_stream", Stream)
        _block({"a": [torch.ones(1), (t,)], "b": t})
        assert waited == [torch.device("cuda", 1)]

    def test_an_error_at_the_barrier_fails_the_future(self, monkeypatch):
        """A device error surfaces where the barrier waits; it reaches the
        job's future instead of vanishing."""
        def broken(result):
            if isinstance(result, torch.Tensor):
                raise RuntimeError("CUDA error: an illegal memory access")
            return result
        monkeypatch.setattr(tscheduler, "_block", broken)
        s = InferenceScheduler()
        fut = s.submit(JobKind.VISION, lambda: torch.ones(1))
        with pytest.raises(RuntimeError, match="illegal memory access"):
            fut.result(timeout=5.0)
        # the dispatch thread lives on
        assert s.run(JobKind.OTHER, lambda: "next", timeout=5.0) == "next"
        s.close()


class TestSchedulerFocus:
    def test_focus_skips_vision_at_admission(self):
        s = InferenceScheduler()
        s.run(JobKind.VISION, lambda: None, timeout=5.0)
        s.focus(5.0)
        t0 = time.monotonic()
        assert s.run_or_skip(JobKind.VISION, lambda: "ran") is SKIPPED
        assert time.monotonic() - t0 < 0.1
        assert s.run_or_skip(JobKind.TTS, lambda: "tts") == "tts"
        s.close()

    def test_staleness_bound_overrides_focus(self):
        s = InferenceScheduler(focus_max_stale_s=0.15)
        s.run(JobKind.VISION, lambda: None, timeout=5.0)
        s.focus(5.0)
        assert s.run_or_skip(JobKind.VISION, lambda: "ran") is SKIPPED
        time.sleep(0.2)
        assert s.run_or_skip(JobKind.VISION, lambda: "ran") == "ran"
        assert s.run_or_skip(JobKind.VISION, lambda: "ran") is SKIPPED
        s.close()

    def test_never_run_kind_is_not_gated(self):
        s = InferenceScheduler()
        s.focus(5.0)
        assert s.run_or_skip(JobKind.VISION, lambda: "ran") == "ran"
        s.close()

    def test_focus_expired_is_noop(self):
        s = InferenceScheduler()
        assert not s.focus_active
        s.focus(0.05)
        assert s.focus_active
        time.sleep(0.1)
        assert not s.focus_active
        s.run(JobKind.VISION, lambda: None, timeout=5.0)
        assert s.run_or_skip(JobKind.VISION, lambda: 7) == 7
        s.close()


def _code(obj) -> str:
    """The syntax tree of ``obj``'s source, docstrings dropped (comments
    are not in the tree)."""
    tree = ast.parse(inspect.getsource(obj).lstrip())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(getattr(body[0], "value", None), ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("name", ["JobKind", "_Job", "InferenceScheduler"])
def test_scheduler_host_logic_is_the_reference(name):
    """Priorities, focus windows, run_or_skip, the staleness bound and the
    dispatch loop are the reference's code; only _block differs."""
    assert _code(getattr(tscheduler, name)) == _code(
        getattr(jscheduler, name))
    assert tscheduler.DEFAULT_PRIORITIES == {
        tscheduler.JobKind(k.value): v
        for k, v in jscheduler.DEFAULT_PRIORITIES.items()}


@pytest.mark.parametrize("name", ["mock_camera_source",
                                  "mock_microphone_source",
                                  "mock_imu_source", "audio_worker",
                                  "sensor_worker"])
def test_host_workers_are_the_reference(name):
    assert _code(getattr(tworkers, name)) == _code(getattr(jworkers, name))


class TestWatchdog:
    def test_restarts_crashed_worker_then_gives_up(self):
        tm = TaskManager()
        crashes = {"n": 0}

        def flaky(stop):
            crashes["n"] += 1
            raise RuntimeError(f"crash {crashes['n']}")

        tm.spawn("flaky", flaky)
        wd = Watchdog(tm, interval_s=0.01, max_restarts=2)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and "flaky" not in wd.gave_up:
            wd.check_once()
            time.sleep(0.02)
        assert crashes["n"] == 3
        assert wd.restarts["flaky"] == 2
        assert "flaky" in wd.gave_up
        tm.join_all(1.0)

    def test_healthy_worker_untouched(self):
        tm = TaskManager()
        tm.spawn("ok", lambda stop: stop.wait(5.0))
        wd = Watchdog(tm, interval_s=0.01)
        wd.check_once()
        assert wd.restarts == {}
        tm.join_all(1.0)


class _Cortex:
    def __init__(self, n, stop):
        self.frames, self.n, self.stop = [], n, stop

    def inject_video_frame(self, frame):
        self.frames.append(frame)
        if len(self.frames) == self.n:
            self.stop.set()


def test_camera_worker_uploads_each_frame_to_its_device():
    """Each captured frame reaches the cortex as a tensor on the worker's
    device (a copy: the camera may reuse its buffer), and the bus hears of
    it."""
    stop = threading.Event()
    shots = []
    camera = tworkers.mock_camera_source(32, 24)

    def shoot():
        shots.append(camera())
        return shots[-1]
    cortex, bus = _Cortex(3, stop), EventBus()
    sub = bus.subscribe()
    t = threading.Thread(target=tworkers.vision_worker,
                         args=(stop, cortex, shoot, bus),
                         kwargs={"fps": 100.0, "device": CPU})
    t.start()
    t.join(timeout=5.0)
    assert not t.is_alive() and len(cortex.frames) == 3
    for shot, frame in zip(shots, cortex.frames):
        assert isinstance(frame, torch.Tensor) and frame.dtype == torch.uint8
        assert np.array_equal(frame.numpy(), shot)
        assert frame.numpy().ctypes.data != shot.ctypes.data
    assert [e.payload for e in sub.drain()][0] == {"frame_shape": (24, 32, 3)}


def test_camera_worker_raises_when_the_upload_fails(monkeypatch):
    """No host-frame fallback: a failed upload crashes the worker, where
    the task manager and the watchdog see it."""
    def broken(frame, device):
        raise RuntimeError("CUDA error: out of memory")
    monkeypatch.setattr(tworkers, "to_device_async", broken)
    tm = TaskManager()
    stop = threading.Event()
    cortex = _Cortex(1, stop)
    tm.spawn("vision", lambda s: tworkers.vision_worker(
        s, cortex, tworkers.mock_camera_source(8, 8), device=CPU))
    tm.join_all(timeout=2.0)
    assert "out of memory" in str(tm.errors()["vision"])
    assert cortex.frames == []


def test_camera_worker_needs_a_card_or_the_cpu(monkeypatch):
    from trackiellm_tpu_torch.utils.errors import TrackieError
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(TrackieError, match="upload camera frames"):
        tworkers.vision_worker(threading.Event(), None, lambda: None)
