"""IMU sensor fusion: Madgwick orientation + motion-state estimation.

Parity target: ``tk_sensors_fusion`` (reference:
src/sensors/tk_sensors_fusion.c/h:114-189): identity-quaternion init
(:60), IMU ingestion, VAD-state injection (:98), periodic update (:108),
and a ``tk_world_state_t`` output with motion state STATIONARY / WALKING
/ RUNNING / FALLING. The Madgwick algorithm is the one the cortex config
selects (tk_cortex_main.c:760-763).

Host-side numpy by design: the state is 10 floats at 100 Hz — a device
round trip per sample would cost ~1000x the arithmetic.
"""

from __future__ import annotations

import dataclasses
import enum
import math
import time
from typing import Optional, Tuple

import numpy as np

GRAVITY = 9.81


class MotionState(enum.Enum):
    """Parity: the reference's motion states."""

    UNKNOWN = "unknown"
    STATIONARY = "stationary"
    WALKING = "walking"
    RUNNING = "running"
    FALLING = "falling"


@dataclasses.dataclass
class WorldState:
    """Parity: tk_world_state_t."""

    orientation_wxyz: Tuple[float, float, float, float]
    motion_state: MotionState
    accel_magnitude: float
    is_speaking: bool
    timestamp: float


@dataclasses.dataclass
class SensorFusionConfig:
    sample_rate_hz: float = 100.0    # tk_cortex_main.c:761
    madgwick_beta: float = 0.1
    # Motion-state thresholds on accel-magnitude variance (m/s^2).
    walking_var: float = 0.5
    running_var: float = 4.0
    falling_accel: float = 3.0       # near free-fall magnitude
    motion_window: int = 50          # 0.5 s @ 100 Hz


class SensorFusion:
    """Madgwick AHRS (gyro + accel) + motion classification."""

    def __init__(self, config: Optional[SensorFusionConfig] = None,
                 clock=time.monotonic):
        self.config = config or SensorFusionConfig()
        self._clock = clock
        self.q = np.array([1.0, 0.0, 0.0, 0.0])  # identity (fusion.c:60)
        self._accel_mags: list = []
        self._is_speaking = False
        self._motion = MotionState.UNKNOWN
        self._last_accel = np.zeros(3)

    # ------------------------------------------------------------------
    # Ingestion
    # ------------------------------------------------------------------

    def ingest_imu(self, gyro_rad_s, accel_m_s2,
                   dt: Optional[float] = None) -> None:
        """One IMU sample: gyro (rad/s) + accel (m/s^2), body frame."""
        dt = dt if dt is not None else 1.0 / self.config.sample_rate_hz
        g = np.asarray(gyro_rad_s, np.float64)
        a = np.asarray(accel_m_s2, np.float64)
        self._last_accel = a
        self._madgwick_update(g, a, dt)

        mag = float(np.linalg.norm(a))
        self._accel_mags.append(mag)
        self._accel_mags = self._accel_mags[-self.config.motion_window:]
        self._update_motion_state()

    def ingest_vad_state(self, is_speaking: bool) -> None:
        """Parity: VAD-state injection (tk_sensors_fusion.c:98)."""
        self._is_speaking = bool(is_speaking)

    # ------------------------------------------------------------------
    # Madgwick AHRS update (IMU-only form)
    # ------------------------------------------------------------------

    def _madgwick_update(self, g: np.ndarray, a: np.ndarray,
                         dt: float) -> None:
        q0, q1, q2, q3 = self.q
        # Quaternion derivative from gyro.
        q_dot = 0.5 * np.array([
            -q1 * g[0] - q2 * g[1] - q3 * g[2],
            q0 * g[0] + q2 * g[2] - q3 * g[1],
            q0 * g[1] - q1 * g[2] + q3 * g[0],
            q0 * g[2] + q1 * g[1] - q2 * g[0],
        ])
        norm_a = np.linalg.norm(a)
        if norm_a > 1e-9:
            ax, ay, az = a / norm_a
            # Gradient-descent corrective step toward gravity alignment.
            f = np.array([
                2 * (q1 * q3 - q0 * q2) - ax,
                2 * (q0 * q1 + q2 * q3) - ay,
                2 * (0.5 - q1 * q1 - q2 * q2) - az,
            ])
            J = np.array([
                [-2 * q2, 2 * q3, -2 * q0, 2 * q1],
                [2 * q1, 2 * q0, 2 * q3, 2 * q2],
                [0.0, -4 * q1, -4 * q2, 0.0],
            ])
            step = J.T @ f
            n = np.linalg.norm(step)
            if n > 1e-12:
                q_dot -= self.config.madgwick_beta * step / n
        self.q = self.q + q_dot * dt
        self.q /= np.linalg.norm(self.q)

    # ------------------------------------------------------------------
    # Motion state
    # ------------------------------------------------------------------

    def _update_motion_state(self) -> None:
        cfg = self.config
        mag = self._accel_mags[-1]
        if mag < cfg.falling_accel:
            self._motion = MotionState.FALLING
            return
        if len(self._accel_mags) < 10:
            self._motion = MotionState.UNKNOWN
            return
        var = float(np.var(self._accel_mags))
        if var >= cfg.running_var:
            self._motion = MotionState.RUNNING
        elif var >= cfg.walking_var:
            self._motion = MotionState.WALKING
        else:
            self._motion = MotionState.STATIONARY

    # ------------------------------------------------------------------
    # Output (parity: tk_sensors_fusion_get_world_state / _get_orientation)
    # ------------------------------------------------------------------

    def get_orientation(self) -> Tuple[float, float, float, float]:
        return tuple(float(v) for v in self.q)

    def get_world_state(self) -> WorldState:
        return WorldState(
            orientation_wxyz=self.get_orientation(),
            motion_state=self._motion,
            accel_magnitude=float(np.linalg.norm(self._last_accel)),
            is_speaking=self._is_speaking,
            timestamp=self._clock(),
        )

    def euler_deg(self) -> Tuple[float, float, float]:
        """Roll/pitch/yaw in degrees (diagnostics)."""
        w, x, y, z = self.q
        roll = math.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
        pitch = math.asin(max(-1.0, min(1.0, 2 * (w * y - z * x))))
        yaw = math.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
        return tuple(math.degrees(v) for v in (roll, pitch, yaw))
