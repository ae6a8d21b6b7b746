"""Invoke statistics (L3 observability).

Reference analog: per-filter latency/throughput tracking in
``tensor_filter.c:366-510`` — a 10-sample sliding window
(``GST_TF_STAT_MAX_RECENT``, tensor_filter_common.h:78) plus lifetime
totals (``total_invoke_num``/``total_invoke_latency``,
nnstreamer_plugin_api_filter.h:170-175).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Optional

STAT_WINDOW = 10  # reference GST_TF_STAT_MAX_RECENT


class InvokeStats:
    """Two latency channels with distinct semantics on an async device:

    * ``record`` — DISPATCH time (host-side call, returns before the device
      finishes under async execution). Cheap, measured every invoke.
    * ``record_device`` — DEVICE time (dispatch + a wait for the device to
      finish). This is the number comparable to the reference's synchronous
      invoke latency (tensor_filter.c:366-510); sampled, since waiting on
      every frame would serialize the pipeline.
    """

    def __init__(self, window: int = STAT_WINDOW):
        self._recent: Deque[float] = deque(maxlen=window)
        self._recent_device: Deque[float] = deque(maxlen=window)
        self._lock = threading.Lock()
        self.total_invokes = 0
        self.total_latency_s = 0.0
        self._first_ts: Optional[float] = None
        self._last_ts: Optional[float] = None

    def record(self, latency_s: float) -> None:
        now = time.monotonic()
        with self._lock:
            self.total_invokes += 1
            self.total_latency_s += latency_s
            self._recent.append(latency_s)
            if self._first_ts is None:
                self._first_ts = now
            self._last_ts = now

    def record_device(self, latency_s: float) -> None:
        with self._lock:
            self._recent_device.append(latency_s)

    @property
    def recent_device_latency_s(self) -> float:
        """Sliding-window average of sampled device-complete latencies
        (0.0 until the first sample)."""
        with self._lock:
            if not self._recent_device:
                return 0.0
            return sum(self._recent_device) / len(self._recent_device)

    @property
    def recent_latency_s(self) -> float:
        """Sliding-window average latency (the reference's `latency` prop,
        reported in µs there)."""
        with self._lock:
            if not self._recent:
                return 0.0
            return sum(self._recent) / len(self._recent)

    @property
    def avg_latency_s(self) -> float:
        with self._lock:
            if self.total_invokes == 0:
                return 0.0
            return self.total_latency_s / self.total_invokes

    @property
    def throughput_fps(self) -> float:
        with self._lock:
            if not self._first_ts or self.total_invokes < 2:
                return 0.0
            span = (self._last_ts or 0) - self._first_ts
            if span <= 0:
                return 0.0
            return (self.total_invokes - 1) / span

    def snapshot(self) -> dict:
        return {
            "total_invokes": self.total_invokes,
            "avg_dispatch_latency_ms": self.avg_latency_s * 1e3,
            "recent_dispatch_latency_ms": self.recent_latency_s * 1e3,
            # reference-comparable number (synchronous invoke semantics)
            "recent_device_latency_ms": self.recent_device_latency_s * 1e3,
            "throughput_fps": self.throughput_fps,
        }


class LatencyReservoir:
    """Bounded sample ring for percentile estimates (p50/p99) — the
    serving scheduler and bench tools need tail latency, which the
    sliding averages above cannot express. Keeps the most recent
    ``cap`` samples (a ring, not a random reservoir: serving snapshots
    should reflect CURRENT load, not the whole lifetime mix)."""

    def __init__(self, cap: int = 4096):
        self._cap = cap
        self._ring: list = []
        self._idx = 0
        self._lock = threading.Lock()
        self.count = 0

    def add(self, value_s: float) -> None:
        with self._lock:
            self.count += 1
            if len(self._ring) < self._cap:
                self._ring.append(value_s)
            else:
                self._ring[self._idx] = value_s
                self._idx = (self._idx + 1) % self._cap

    def snapshot(self) -> dict:
        with self._lock:
            data = sorted(self._ring)
            n = self.count
        if not data:
            return {"count": n, "p50_ms": 0.0, "p99_ms": 0.0, "max_ms": 0.0}

        def pick(q):
            return data[min(len(data) - 1,
                            max(0, int(round(q / 100.0 * (len(data) - 1)))))]
        return {"count": n, "p50_ms": pick(50) * 1e3,
                "p99_ms": pick(99) * 1e3, "max_ms": data[-1] * 1e3}


class Timer:
    """Context manager recording wall time into an InvokeStats."""

    def __init__(self, stats: InvokeStats):
        self.stats = stats

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self.stats.record(time.monotonic() - self._t0)
        return False
