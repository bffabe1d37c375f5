"""Render statistics, capacity reporting, playback stats.

reference: src/stats.rs (AudioStats atomics), src/capacity.rs
(AudioRenderCapacity poller + events), src/playback_stats.rs (spec-tracking
1 s cached snapshots).  The online render loop records per-callback wall
time vs budget; pollers emit capacity events on the event loop.  A copy of
`webaudio_tpu/stats.py`, which is framework-free.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional

from .events import EventDispatch, EventType


class AudioStats:
    """Lock-free-in-spirit counters (reference: stats.rs:10-124)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.callbacks = 0
        self.render_ns = 0
        self.budget_ns = 0
        self.underruns = 0
        self.underrun_ns = 0
        self.peak_load_ppm = 0
        self.latency_min_ns = None
        self.latency_max_ns = 0
        self.latency_sum_ns = 0
        self.latency_count = 0

    def record_render_callback(self, duration_s: float, budget_s: float):
        """reference: stats.rs:67-98."""
        with self._lock:
            self.callbacks += 1
            d = int(duration_s * 1e9)
            b = int(budget_s * 1e9)
            self.render_ns += d
            self.budget_ns += b
            load_ppm = int(1e6 * duration_s / budget_s) if budget_s > 0 else 0
            self.peak_load_ppm = max(self.peak_load_ppm, load_ppm)
            if duration_s > budget_s:
                self.underruns += 1
                self.underrun_ns += d - b
            self.latency_min_ns = d if self.latency_min_ns is None else \
                min(self.latency_min_ns, d)
            self.latency_max_ns = max(self.latency_max_ns, d)
            self.latency_sum_ns += d
            self.latency_count += 1

    def snapshot(self) -> dict:
        with self._lock:
            cb = max(self.callbacks, 1)
            return {
                "callbacks": self.callbacks,
                "average_load": self.render_ns / max(self.budget_ns, 1),
                "peak_load": self.peak_load_ppm / 1e6,
                "underruns": self.underruns,
                "underrun_ratio": self.underruns / cb,
                "mean_callback_seconds": self.latency_sum_ns / cb / 1e9,
                "max_callback_seconds": self.latency_max_ns / 1e9,
                "underrun_seconds": self.underrun_ns / 1e9,
                "average_latency_seconds": (
                    self.latency_sum_ns / max(self.latency_count, 1) / 1e9),
                "minimum_latency_seconds": (self.latency_min_ns or 0) / 1e9,
                "maximum_latency_seconds": self.latency_max_ns / 1e9,
            }

    def reset_latency(self):
        """reference: stats.rs reset_latency (playback_stats.rs:92-94)."""
        with self._lock:
            self.latency_min_ns = None
            self.latency_max_ns = 0
            self.latency_sum_ns = 0
            self.latency_count = 0

    def reset_interval(self):
        with self._lock:
            self.callbacks = 0
            self.render_ns = 0
            self.budget_ns = 0
            self.underruns = 0
            self.underrun_ns = 0
            self.peak_load_ppm = 0


@dataclass
class AudioRenderCapacityEvent:
    """reference: capacity.rs:30-60"""

    timestamp: float
    average_load: float
    peak_load: float
    underrun_ratio: float


class AudioRenderCapacity:
    """Interval poller emitting capacity events
    (reference: capacity.rs:65-130)."""

    def __init__(self, context, stats: AudioStats, event_loop):
        self._context = context
        self._stats = stats
        self._event_loop = event_loop
        self._thread: Optional[threading.Thread] = None
        self._running = False

    def start(self, update_interval: float = 1.0):
        self.stop()
        self._running = True

        def run():
            while self._running:
                time.sleep(update_interval)
                if not self._running:
                    break
                snap = self._stats.snapshot()
                ev = AudioRenderCapacityEvent(
                    timestamp=self._context.current_time,
                    average_load=min(snap["average_load"], 1.0),
                    peak_load=min(snap["peak_load"], 1.0),
                    underrun_ratio=snap["underrun_ratio"])
                self._stats.reset_interval()
                self._event_loop.post(EventDispatch(
                    EventType.RENDER_CAPACITY, payload=ev))

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="webaudio-capacity")
        self._thread.start()

    def stop(self):
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def set_onupdate(self, cb):
        self._event_loop.add_handler(EventType.RENDER_CAPACITY, cb)


class AudioPlaybackStats:
    """Spec-tracking playback stats with 1 s cached snapshots
    (reference: playback_stats.rs:7-60)."""

    def __init__(self, stats: AudioStats, sample_rate: float):
        self._stats = stats
        self._sample_rate = sample_rate
        self._cache = None
        self._cache_time = -1.0

    def _snapshot(self):
        now = time.monotonic()
        if self._cache is None or now - self._cache_time >= 1.0:
            self._cache = self._stats.snapshot()
            self._cache_time = now
        return self._cache

    @property
    def fallback_frames_duration(self) -> float:
        s = self._snapshot()
        return s["underruns"] * 128 / self._sample_rate

    @property
    def fallback_frames_events(self) -> int:
        return self._snapshot()["underruns"]

    @property
    def total_frames_duration(self) -> float:
        return self._snapshot()["callbacks"] * 128 / self._sample_rate

    # --- latency interval (reference: playback_stats.rs:73-94) -----------
    @property
    def average_latency(self) -> float:
        return self._snapshot()["average_latency_seconds"]

    @property
    def minimum_latency(self) -> float:
        return self._snapshot()["minimum_latency_seconds"]

    @property
    def maximum_latency(self) -> float:
        return self._snapshot()["maximum_latency_seconds"]

    def reset_latency(self):
        self._stats.reset_latency()
        self._cache = None  # re-read on next access

    def to_json(self) -> dict:
        """Plain snapshot (reference: playback_stats.rs to_json)."""
        s = dict(self._snapshot())
        s["underrun_duration"] = s["underrun_seconds"]
        s["underrun_events"] = s["underruns"]
        s["total_duration"] = self.total_frames_duration
        return s
