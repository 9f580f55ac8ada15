"""Streaming signal filters for sensor channels.

Parity target: the Rust sensor_filters module (reference:
src/sensors/src/sensor_filters.rs). Host-side numpy — these run per IMU
sample (100 Hz on 3-vectors); device dispatch would cost more than the
math.
"""

from __future__ import annotations

import collections
from typing import Optional

import numpy as np


class LowPassFilter:
    """First-order exponential low-pass: y += alpha * (x - y)."""

    def __init__(self, alpha: float = 0.2):
        assert 0.0 < alpha <= 1.0
        self.alpha = alpha
        self._y: Optional[np.ndarray] = None

    def __call__(self, x) -> np.ndarray:
        x = np.asarray(x, np.float64)
        if self._y is None:
            self._y = x.copy()
        else:
            self._y += self.alpha * (x - self._y)
        return self._y.copy()

    def reset(self) -> None:
        self._y = None


class MedianFilter:
    """Sliding-window median (spike rejection for accelerometer taps)."""

    def __init__(self, window: int = 5):
        assert window % 2 == 1
        self._buf: collections.deque = collections.deque(maxlen=window)

    def __call__(self, x) -> np.ndarray:
        self._buf.append(np.asarray(x, np.float64))
        return np.median(np.stack(self._buf), axis=0)

    def reset(self) -> None:
        self._buf.clear()
