"""OfflineAudioContext: render a graph as fast as possible into a buffer.

reference: src/context/offline.rs.  The render loop
(thread.rs:260-302 / graph.rs:490-587) becomes: plan the graph once per
suspend segment, run the block loop on the context's device, carry node
states across segments so mid-render graph mutation (the reference's
`suspend_sync` semantics, offline.rs:294-387) composes with the plan.
Ported from `webaudio_tpu/context/offline.py`.
"""

from __future__ import annotations

import math
import time as _time
from typing import Callable, Optional

import numpy as np

from ..buffer import AudioBuffer
from ..constants import (
    RENDER_QUANTUM_SIZE, InvalidStateError, NotSupportedError,
    assert_valid_number_of_channels,
)
from ..diagnostics import span
from ..graph import compiler as _compiler
from .base import AudioContextState, BaseAudioContext


class OfflineAudioContext(BaseAudioContext):
    """reference: src/context/offline.rs:29-653.  `device` is where every
    block of the render runs: the card by default ("cuda"), or "cuda:1",
    "cpu" as the caller asks.  Without a GPU a render on "cuda" fails; it
    never moves to the CPU on its own."""

    def __init__(self, number_of_channels: int, length: int, sample_rate: float,
                 *, device="cuda"):
        assert_valid_number_of_channels(number_of_channels)
        if length <= 0:
            raise NotSupportedError("length must be > 0")
        super().__init__(sample_rate, device)
        self._length = int(length)
        self._number_of_channels = int(number_of_channels)
        self._rendering_started = False
        self._suspend_callbacks: dict[int, Callable] = {}  # quantum -> cb
        self._render_stats = None
        self._pending_resume = None   # the gate a suspend(t) waits on
        self._cg = None               # the last segment's plan

        from ..nodes.destination import AudioDestinationNode

        self._destination = AudioDestinationNode(
            self, channel_count=number_of_channels)

    @property
    def length(self) -> int:
        return self._length

    def set_oncomplete(self, cb: Callable):
        """cb receives an OfflineAudioCompletionEvent with .rendered_buffer
        (reference: offline.rs:404-422)."""
        self._add_event_handler("complete", cb)

    # older name kept as an alias
    oncomplete = set_oncomplete

    def clear_oncomplete(self):
        """reference: offline.rs clear_oncomplete."""
        self._event_handlers.pop("complete", None)

    # --- suspend scheduling (reference: offline.rs:241-387) ----------------
    def _calculate_suspend_frame(self, suspend_time: float) -> int:
        if suspend_time < 0:
            raise InvalidStateError("suspendTime cannot be negative")
        if suspend_time >= self._length / self.sample_rate:
            raise InvalidStateError(
                "suspendTime cannot be >= the total render duration")
        return math.ceil(suspend_time * self.sample_rate / RENDER_QUANTUM_SIZE)

    def suspend_sync(self, suspend_time: float, callback: Callable) -> None:
        quantum = self._calculate_suspend_frame(suspend_time)
        if quantum in self._suspend_callbacks:
            raise InvalidStateError(
                "cannot suspend multiple times at the same render quantum")
        if self._rendering_started and quantum * RENDER_QUANTUM_SIZE <= \
                self._current_time * self.sample_rate:
            raise InvalidStateError("suspendTime is in the past")
        self._suspend_callbacks[quantum] = callback

    # --- rendering -----------------------------------------------------------
    def start_rendering_sync(self) -> AudioBuffer:
        """reference: offline.rs:157-185 -> thread.rs:260-302."""
        if self._rendering_started:
            raise InvalidStateError("rendering already started")
        self._rendering_started = True
        self._set_state(AudioContextState.RUNNING)

        fs = self.sample_rate
        total = self._length
        wall_t0 = _time.perf_counter()

        # segment boundaries: suspend quanta inside (0, total_quanta)
        suspend_frames = sorted(q * RENDER_QUANTUM_SIZE
                                for q in self._suspend_callbacks)
        boundaries = [f for f in suspend_frames if 0 < f] + [total]
        boundaries = sorted(set(b for b in boundaries if b <= total))
        if boundaries[-1] != total:
            boundaries.append(total)

        out = np.zeros((self._number_of_channels, total), dtype=np.float32)
        states: Optional[dict] = None
        cursor = 0
        segments = []

        # callback scheduled at quantum 0 runs before rendering
        if 0 in self._suspend_callbacks:
            self._set_state(AudioContextState.SUSPENDED)
            self._suspend_callbacks.pop(0)(self)
            self._set_state(AudioContextState.RUNNING)

        for boundary in boundaries:
            if boundary <= cursor:
                continue
            seg_len = boundary - cursor
            cg = _compiler.compile_graph(
                dict(self._nodes), list(self._edges), fs, seg_len,
                self._destination.node_id, self._device, start_frame=cursor)
            with span("render.stage"):
                args = _compiler.render_args(
                    cg, _compiler.pack_dense_params(
                        cg, _compiler._pad_len(seg_len, cg.block_frames)),
                    cursor, states)
            states, seg_out = _compiler.scan_render(cg, *args)
            with span("render.fetch"):
                out[:, cursor:boundary] = \
                    seg_out[0, :self._number_of_channels, :seg_len].cpu() \
                    .numpy()
            with span("render.finish"):
                segments.append({"block_frames": cg.block_frames,
                                 "failed": dict(cg.failed)})
                # keep the plan for diagnostics, without its staged
                # resources or its CUDA graphs
                cg.resource_cache = None
                _compiler.drop_graphs(cg)
                self._cg = cg
                cursor = boundary
                self._current_time = cursor / fs
                self._advance_param_state(cursor)
                # publish states (the buffer playhead) so suspend callbacks
                # observe the graph's live state
                self._publish_render_states(_compiler.unbatch_states(states))

            q = cursor // RENDER_QUANTUM_SIZE
            if q in self._suspend_callbacks:
                self._set_state(AudioContextState.SUSPENDED)
                self._suspend_callbacks.pop(q)(self)
                self._set_state(AudioContextState.RUNNING)

        self._render_stats = {
            "wall_seconds": _time.perf_counter() - wall_t0,
            "audio_seconds": total / fs,
            "segments": segments,
        }

        with span("render.finish"):
            # `ended` events: at offline unload the reference fires ended
            # for every source that has started (before_drop, e.g.
            # constant_source.rs:290-296: current_time >= start_time)
            for node in self._nodes.values():
                cb = getattr(node, "_onended", None)
                if cb is None:
                    continue
                start = getattr(node, "_start_time", math.inf)
                if start < math.inf:
                    cb()

            self._set_state(AudioContextState.CLOSED)
            buffer = AudioBuffer.from_array(out, fs)
            from ..events import OfflineAudioCompletionEvent

            self._dispatch_event("complete",
                                 OfflineAudioCompletionEvent(buffer))
        return buffer

    # --- promise-style variants (reference: offline.rs:198-251, 394) -------
    def start_rendering(self):
        """Async variant: render on a thread of its own and return a
        `concurrent.futures.Future[AudioBuffer]` (reference:
        offline.rs:198-230).  Compose with `suspend(t)`/`resume()` from
        another thread (or an event loop via `asyncio.wrap_future`).

        The thread is dedicated (not the shared pool): a render parked in
        `suspend(t)` blocks its thread until `resume()`, and must not
        occupy a worker other futures are waiting on.  It renders on the
        context's device, and its kernels launch on that thread's current
        CUDA stream."""
        from ..futures import submit_dedicated

        return submit_dedicated(self.start_rendering_sync)

    def suspend(self, suspend_time: float):
        """Async suspend (reference: offline.rs:241-251): returns a Future
        that resolves once rendering reaches `suspend_time` and the
        context is suspended; rendering stays paused until `resume()`.
        Requires the render to run off-thread (`start_rendering()`).  The
        parked render waits on a `threading.Event`, which releases the
        GIL."""
        import concurrent.futures
        import threading

        reached: concurrent.futures.Future = concurrent.futures.Future()
        gate = threading.Event()

        def cb(ctx):
            self._pending_resume = gate
            reached.set_result(None)
            gate.wait()
            self._pending_resume = None

        self.suspend_sync(suspend_time, cb)
        return reached

    def resume(self):
        """Release a pending `suspend(t)` (reference: offline.rs:394).
        Returns a completed Future for symmetry with the reference."""
        from ..futures import completed

        gate = self._pending_resume
        if gate is None:
            raise InvalidStateError("context is not suspended")
        gate.set()
        return completed(None)

    @property
    def render_stats(self):
        """Wall-clock/realtime-factor observability for the last render
        (the analog of AudioStats, reference: src/stats.rs), with each
        suspend segment's block size and the nodes that failed in it."""
        if self._render_stats is None:
            return None
        s = dict(self._render_stats)
        s["realtime_factor"] = s["audio_seconds"] / max(s["wall_seconds"], 1e-12)
        return s

    def _advance_param_state(self, frame: int):
        """Advance every param's control-side timeline to `frame` so events
        inserted during a suspend callback see the correct intrinsic value
        (matches the render-side state of the reference)."""
        from ..automation import compile_timeline

        for node in self._nodes.values():
            for p in node.params.values():
                # consume the timeline up to `frame` in place; is_a_rate=True
                # regardless of the param's rate — state evolution is
                # identical and the k-rate path requires quantum-aligned
                # lengths which the final render boundary may not satisfy
                compile_timeline(p._timeline, self.sample_rate,
                                 frame - getattr(p, "_advanced_to", 0),
                                 True,
                                 start_frame=getattr(p, "_advanced_to", 0))
                p._advanced_to = frame
                p._current_value = p._timeline.intrinsic_value

    def _publish_render_states(self, states):
        """Hand final states back to nodes that expose readbacks (the
        buffer source's `position`)."""
        for nid, node in self._nodes.items():
            hook = getattr(node, "_on_render_state", None)
            if hook is not None:
                st = states.get(_compiler._k(nid))
                if st is not None:
                    hook(st)

