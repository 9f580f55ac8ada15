"""Sensor fusion: IMU orientation + motion state. Replacement for the
reference's src/sensors (C fusion + Rust filters crate)."""

from trackiellm_tpu_torch.sensors.fusion import (  # noqa: F401
    MotionState,
    SensorFusion,
    SensorFusionConfig,
    WorldState,
)
from trackiellm_tpu_torch.sensors.filters import LowPassFilter, MedianFilter  # noqa: F401
