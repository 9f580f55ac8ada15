"""Double-buffered host->device transfer.

Port of ``trackiellm_tpu/runtime/buffers.py``. Parity target: the
reference's 3-stream CUDA dispatcher overlapping upload / compute /
download (reference: src/gpu/cuda/tk_cuda_dispatch.cu:51-55, 116-132).
Here each ``put`` starts an asynchronous copy from a fresh pinned host
buffer on the producer thread's current stream (the legacy default stream,
shared by every thread, so a consumer's kernels are ordered after the
copy), so while the card computes on frame N, frame N+1 is already in
flight; the feeder's job is pipelining the *handoff* and keeping at most
``depth`` frames resident (bounded staging, like the reference's staging
buffers).
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch

from trackiellm_tpu_torch.ops.backend import default_device


def to_device_async(host_array: Any, device: torch.device) -> torch.Tensor:
    """``host_array`` as a tensor on ``device``: to a card through a fresh
    pinned copy with ``non_blocking=True`` (the caching host allocator
    keeps the pinned block until the copy has run); to the CPU a copy."""
    t = (host_array if isinstance(host_array, torch.Tensor)
         else torch.from_numpy(np.ascontiguousarray(host_array)))
    if device.type == "cuda":
        if t.is_cuda:
            return t.to(device)
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device, copy=True)


class DoubleBufferedFeeder:
    """Producer/consumer frame feeder with device-side staging.

    Producer thread calls ``put(host_array)`` — the transfer starts
    immediately (asynchronous copy). Consumer calls ``get()`` and receives
    a device tensor whose transfer overlaps the consumer's previous
    compute. Bounded depth: when full, the oldest staged frame is dropped
    (real-time semantics — the reference's frame ring does the same,
    tk_cortex_main.c:542). The feeder runs on ``device``: the CUDA card by
    default, the CPU when asked for.
    """

    def __init__(self, depth: int = 2,
                 device: Optional[torch.device] = None,
                 preprocess: Optional[Callable] = None):
        self.depth = depth
        self.device = default_device(device, "build a DoubleBufferedFeeder")
        self.preprocess = preprocess
        self._staged: collections.deque = collections.deque(maxlen=depth)
        self._cv = threading.Condition()
        self.dropped = 0
        self.transferred = 0

    def put(self, host_array: Any) -> None:
        dev = to_device_async(host_array, self.device)  # async start
        if self.preprocess is not None:
            dev = self.preprocess(dev)  # on the device; also async
        with self._cv:
            if len(self._staged) == self._staged.maxlen:
                self.dropped += 1
            self._staged.append(dev)
            self.transferred += 1
            self._cv.notify()

    def get(self, timeout: Optional[float] = None):
        """Newest staged frame (real-time: intermediate frames are
        skipped), or None on timeout."""
        with self._cv:
            if not self._staged:
                self._cv.wait(timeout=timeout)
            if not self._staged:
                return None
            # Take newest, drop older (they're stale for a live loop).
            newest = self._staged.pop()
            self.dropped += len(self._staged)
            self._staged.clear()
            return newest

    def get_in_order(self, timeout: Optional[float] = None):
        """FIFO variant for offline processing."""
        with self._cv:
            if not self._staged:
                self._cv.wait(timeout=timeout)
            return self._staged.popleft() if self._staged else None
