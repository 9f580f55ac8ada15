"""Monitoring: system/device metrics collection + telemetry shipping.

Parity target: the Rust ``monitoring`` crate — MetricsCollector
(CPU/mem/GPU) + TelemetrySender with endpoint/auth config whose HTTP
POST is simulated (reference: src/monitoring/src/telemetry.rs:79-191,
metrics_collector.rs). Here the device metrics are the CUDA card's memory
(``torch.cuda``'s allocator, and ``cudaMemGetInfo``'s free and total) and
the sender batches into a local spool — actual transport is injectable
(the reference's POST is simulated too). Port of
``trackiellm_tpu/services/monitoring.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from trackiellm_tpu_torch.utils.logging import get_logger

log = get_logger("services.monitoring")


class MetricsCollector:
    """CPU / memory / accelerator metrics snapshots. ``device``: the card
    to read (by default the current one when there is a card); a CPU
    device reads none."""

    def __init__(self, device=None):
        self._last_cpu: Optional[tuple] = None
        if device is None and torch.cuda.is_available():
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = torch.device(device) if device is not None else None

    def collect(self) -> Dict[str, float]:
        out: Dict[str, float] = {"ts": time.time()}
        out.update(self._cpu())
        out.update(self._memory())
        out.update(self._process())
        out.update(self._device())
        return out

    def _cpu(self) -> Dict[str, float]:
        try:
            with open("/proc/stat") as f:
                parts = f.readline().split()[1:8]
            vals = list(map(int, parts))
            idle, total = vals[3], sum(vals)
            if self._last_cpu is not None:
                d_idle = idle - self._last_cpu[0]
                d_total = total - self._last_cpu[1]
                usage = 1.0 - d_idle / max(d_total, 1)
            else:
                usage = 0.0
            self._last_cpu = (idle, total)
            return {"cpu_usage": round(usage, 4)}
        except OSError:
            return {}

    def _memory(self) -> Dict[str, float]:
        try:
            info = {}
            with open("/proc/meminfo") as f:
                for line in f:
                    k, v = line.split(":", 1)
                    info[k] = int(v.strip().split()[0]) * 1024
            total = info.get("MemTotal", 0)
            avail = info.get("MemAvailable", 0)
            return {"mem_total_bytes": float(total),
                    "mem_used_bytes": float(total - avail)}
        except OSError:
            return {}

    def _process(self) -> Dict[str, float]:
        try:
            with open(f"/proc/{os.getpid()}/statm") as f:
                pages = int(f.read().split()[1])
            return {"rss_bytes": float(pages * os.sysconf("SC_PAGE_SIZE"))}
        except (OSError, ValueError):
            return {}

    def _device(self) -> Dict[str, float]:
        """The card's memory: bytes the allocator holds in tensors and in
        its pools, its peak, and the card's used and total bytes
        (``cudaMemGetInfo``). ``{}`` for a CPU caller. A failed reading
        raises: a silent gap would hide the card."""
        if self.device is None or self.device.type != "cuda":
            return {}
        free, total = torch.cuda.mem_get_info(self.device)
        return {
            "device_mem_used": float(torch.cuda.memory_allocated(self.device)),
            "device_mem_reserved": float(
                torch.cuda.memory_reserved(self.device)),
            "device_mem_peak": float(
                torch.cuda.max_memory_allocated(self.device)),
            "device_mem_card_used": float(total - free),
            "device_mem_limit": float(total),
        }


@dataclasses.dataclass
class TelemetryConfig:
    endpoint: str = "https://telemetry.invalid/v1/metrics"
    auth_token: str = ""
    batch_size: int = 16
    flush_interval_s: float = 30.0


class TelemetrySender:
    """Batching sender. Transport is injectable; the default spools to a
    local buffer (parity: the reference's simulated HTTP POST)."""

    def __init__(self, config: Optional[TelemetryConfig] = None,
                 transport: Optional[Callable[[str, Dict, List[Dict]],
                                              bool]] = None):
        self.config = config or TelemetryConfig()
        self._transport = transport
        self._batch: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self.sent_batches = 0
        self.spool: List[List[Dict[str, Any]]] = []  # simulated sink

    def record(self, metrics: Dict[str, Any]) -> None:
        with self._lock:
            self._batch.append(metrics)
            if len(self._batch) >= self.config.batch_size:
                self._flush_locked()

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        if not self._batch:
            return
        batch, self._batch = self._batch, []
        headers = {"authorization": f"Bearer {self.config.auth_token}"}
        if self._transport is not None:
            ok = self._transport(self.config.endpoint, headers, batch)
            if not ok:
                log.warning("telemetry transport failed; %d points dropped",
                            len(batch))
                return
        else:
            self.spool.append(batch)  # simulated send
        self.sent_batches += 1


class MonitoringService:
    """Periodic collector -> sender loop on a background thread."""

    def __init__(self, interval_s: float = 5.0,
                 collector: Optional[MetricsCollector] = None,
                 sender: Optional[TelemetrySender] = None):
        self.interval_s = interval_s
        self.collector = collector or MetricsCollector()
        self.sender = sender or TelemetrySender()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.last_metrics: Dict[str, float] = {}

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="monitoring")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.last_metrics = self.collector.collect()
            self.sender.record(self.last_metrics)
            self._stop.wait(self.interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)
        self.sender.flush()

    def snapshot(self) -> str:
        return json.dumps(self.last_metrics or self.collector.collect())
