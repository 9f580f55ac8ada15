"""Hardware workers: camera / microphone / IMU loops feeding the cortex.

Parity target: the Rust workers (reference: src/workers/src/*.rs):
  - vision worker: camera loop -> process_frame -> VisionResult events
    (vision_worker.rs:36-80, camera mocked),
  - audio worker: 100 ms mic chunks at 16 kHz (mocked as silence,
    audio_worker.rs:188-199), Speak events -> TTS,
  - sensor worker: 50 ms tick publishing fused state
    (sensor_worker.rs:112).

Each worker is a cooperative task (TaskManager) pushing into the cortex
injection API and the event bus.

Port of ``trackiellm_tpu/runtime/workers.py``: the camera loop uploads
each frame to the card (``runtime/buffers.py:to_device_async``) and,
unlike the reference, lets a failed upload raise in the worker (the
watchdog sees the crash) instead of handing on the host frame. The microphone and IMU loops and
the mock sources are the reference's.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import numpy as np

from trackiellm_tpu_torch.ops.backend import default_device
from trackiellm_tpu_torch.runtime.buffers import to_device_async
from trackiellm_tpu_torch.runtime.event_bus import EventBus, EventKind
from trackiellm_tpu_torch.utils.logging import get_logger

log = get_logger("runtime.workers")


def mock_camera_source(width: int = 640, height: int = 480,
                       ) -> Callable[[], np.ndarray]:
    """Synthetic camera (parity: the mocked camera loop,
    vision_worker.rs:36-80): a drifting gradient so consecutive frames
    differ."""
    state = {"t": 0}

    def read() -> np.ndarray:
        t = state["t"]
        state["t"] += 1
        x = np.linspace(0, 255, width, dtype=np.float32)
        y = np.linspace(0, 255, height, dtype=np.float32)
        frame = (x[None, :] + y[:, None] + 7 * t) % 256
        return np.repeat(frame[..., None], 3, axis=2).astype(np.uint8)

    return read


def mock_microphone_source(sample_rate: int = 16_000, chunk_ms: int = 100,
                           ) -> Callable[[], np.ndarray]:
    """Silence chunks (parity: audio_worker.rs:188-199)."""
    n = sample_rate * chunk_ms // 1000

    def read() -> np.ndarray:
        return np.zeros(n, np.float32)

    return read


def mock_imu_source() -> Callable[[], tuple]:
    def read() -> tuple:
        return ([0.0, 0.0, 0.0], [0.0, 0.0, 9.81])

    return read


def vision_worker(stop: threading.Event, cortex, camera: Callable,
                  bus: Optional[EventBus] = None, fps: float = 10.0,
                  device=None) -> None:
    """Camera loop. Each captured frame is staged onto ``device`` (the CUDA
    card unless the CPU is given) ON THIS THREAD (the CUDA-upload-stream
    analogue, reference tk_cuda_dispatch.cu:51-55): the 0.9 MB
    host-to-device copy rides the continuous 10 Hz capture loop, so when
    the cortex (or an end-of-speech reply) grabs the latest frame it is
    ALREADY on the card — the upload is never on the reply's critical
    path. A failed upload raises here (no host-frame fallback)."""
    period = 1.0 / fps
    dev = default_device(device, "upload camera frames")
    while not stop.is_set():
        t0 = time.monotonic()
        frame = camera()
        if frame is not None:
            frame = to_device_async(frame, dev)
            cortex.inject_video_frame(frame)
            if bus:
                bus.publish(EventKind.VISION_RESULT,
                            {"frame_shape": tuple(frame.shape)})
        stop.wait(max(period - (time.monotonic() - t0), 0.0))


def audio_worker(stop: threading.Event, cortex, microphone: Callable,
                 chunk_ms: int = 100) -> None:
    period = chunk_ms / 1000.0
    while not stop.is_set():
        t0 = time.monotonic()
        chunk = microphone()
        if chunk is not None:
            cortex.inject_audio_chunk(chunk)
        stop.wait(max(period - (time.monotonic() - t0), 0.0))


def sensor_worker(stop: threading.Event, fusion, imu: Callable,
                  cortex=None, bus: Optional[EventBus] = None,
                  tick_ms: int = 50) -> None:
    """50 ms tick (parity: sensor_worker.rs:112); IMU samples are
    ingested at the tick rate and the fused state is published."""
    period = tick_ms / 1000.0
    last_motion = None
    while not stop.is_set():
        t0 = time.monotonic()
        gyro, accel = imu()
        fusion.ingest_imu(gyro, accel, dt=period)
        state = fusion.get_world_state()
        if bus:
            bus.publish(EventKind.SENSOR_FUSION_RESULT, state)
        if cortex is not None and state.motion_state.value != last_motion:
            last_motion = state.motion_state.value
            cortex.reasoner.update_motion_context(last_motion)
        stop.wait(max(period - (time.monotonic() - t0), 0.0))
