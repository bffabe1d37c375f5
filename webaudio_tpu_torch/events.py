"""Event loop: typed events dispatched to user handlers.

reference: src/events.rs.  The reference runs a dedicated event thread for
online contexts and drains pending events between quanta offline
(events.rs:227-255); here events originate from the control-side render
drivers (offline: computed from schedules at segment boundaries; online:
posted by the render loop thread) and are dispatched synchronously or on
the online context's event thread.  A copy of `webaudio_tpu/events.py`,
which is framework-free.
"""

from __future__ import annotations

import enum
import queue
import threading
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Optional


class EventType(str, enum.Enum):
    """reference: events.rs:23-34"""

    ENDED = "ended"
    SINK_CHANGE = "sinkchange"
    STATE_CHANGE = "statechange"
    RENDER_CAPACITY = "rendercapacity"
    PROCESSOR_ERROR = "processorerror"
    MESSAGE = "message"
    COMPLETE = "complete"
    AUDIO_PROCESSING = "audioprocessing"
    DIAGNOSTICS = "diagnostics"


@dataclass
class EventDispatch:
    """reference: events.rs:98-167"""

    type: EventType
    node_id: Optional[int] = None
    payload: Any = None
    callback: Optional[Callable] = None  # direct one-shot target


class OfflineAudioCompletionEvent:
    """reference: src/events.rs:74-80"""

    def __init__(self, rendered_buffer):
        self.rendered_buffer = rendered_buffer


class ErrorEvent:
    """reference: src/render/processor.rs:77-103"""

    def __init__(self, message: str, error: Exception):
        self.message = message
        self.error = error


class EventLoop:
    """Handler registry + dispatch (reference: events.rs:175-255)."""

    def __init__(self):
        self._handlers: dict[tuple, list[Callable]] = {}
        self._queue: "queue.Queue[EventDispatch]" = queue.Queue(maxsize=256)
        self._thread: Optional[threading.Thread] = None
        self._running = False

    def add_handler(self, event_type: EventType, cb: Callable,
                    node_id: Optional[int] = None):
        self._handlers.setdefault((event_type, node_id), []).append(cb)

    def clear_handlers(self, event_type: EventType,
                       node_id: Optional[int] = None):
        self._handlers.pop((event_type, node_id), None)

    def dispatch(self, event: EventDispatch):
        """Synchronous dispatch (offline path, events.rs:227-236)."""
        if event.callback is not None:
            _safe_call(event.callback, event.payload)
        for cb in self._handlers.get((event.type, event.node_id), []):
            _safe_call(cb, event.payload)
        if event.node_id is not None:
            for cb in self._handlers.get((event.type, None), []):
                _safe_call(cb, event.payload)

    # --- online: dedicated thread with bounded, drop-on-full queue
    # (realtime-safety: the render loop must never block on a slow handler,
    # reference: tests/stall_render.rs) -------------------------------------
    def post(self, event: EventDispatch):
        try:
            self._queue.put_nowait(event)
        except queue.Full:
            pass  # drop, never stall the render loop

    def start_thread(self):
        if self._thread is not None:
            return
        self._running = True

        def run():
            while self._running:
                try:
                    ev = self._queue.get(timeout=0.1)
                except queue.Empty:
                    continue
                self.dispatch(ev)

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="webaudio-events")
        self._thread.start()

    def stop_thread(self):
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=1.0)
            self._thread = None


def _safe_call(cb, payload):
    try:
        if payload is None:
            cb()
        else:
            cb(payload)
    except Exception:  # user handler errors must not kill the engine
        traceback.print_exc()
