"""AudioContext: "real-time" rendering driven by a deadline-paced loop.

reference: src/context/online.rs + src/render/thread.rs:413-532.  A GPU
server has no OS audio device, so the render loop is the analog of the
reference's `none` backend (io/none.rs:45-74): a thread renders one
callback buffer per deadline into a pluggable sink (null / callback / WAV
file).  Control-plane mutations (new nodes, connections, schedules) are
picked up between callbacks by re-planning the graph and carrying node
states across — the compiled-engine equivalent of the reference's control
message drain (thread.rs:475-530).

Ported from `webaudio_tpu/context/online.py`.  Each chunk is a
`RenderSession` step (checkpoint.py): one plan a graph version with a
fixed block of `buffer_frames` frames and every param a dense row, built
per chunk on the host from the live timelines (`AudioParam.advance_dense`),
so scheduling automation while running re-plans nothing.  The block walk
runs on the context's device (the card unless the caller names another),
and each chunk makes one device-to-host copy for the sink.
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Optional

import numpy as np
import torch

from ..constants import RENDER_QUANTUM_SIZE, InvalidStateError, NotSupportedError
from ..convert import batch_states, tree_map, unbatch_states
from ..events import EventDispatch, EventLoop, EventType
from ..graph import compiler as _compiler
from ..io_backends import LATENCY_BUFFER_SIZES, build_backend
from ..stats import AudioPlaybackStats, AudioRenderCapacity, AudioStats
from .base import AudioContextState, BaseAudioContext
from .offline import _same_structure


class AudioContextOptions:
    """reference: online.rs:116-132."""

    def __init__(self, latency_hint: str = "interactive",
                 sample_rate: float = 44100.0, sink_id="",
                 render_size_hint: Optional[int] = None):
        self.latency_hint = latency_hint
        self.sample_rate = sample_rate
        self.sink_id = sink_id
        self.render_size_hint = render_size_hint


class AudioContext(BaseAudioContext):
    """reference: online.rs:138-828.  `device` is where every chunk
    renders: the card by default ("cuda"), or "cuda:1", "cpu" as the
    caller asks.  Without a GPU a chunk on "cuda" fails (the render loop
    posts `processorerror` and plays silence, as for any chunk that
    fails); it never moves to the CPU on its own."""

    def __init__(self, latency_hint: str = "interactive",
                 sample_rate: float = 44100.0, sink_id="",
                 render_size_hint: Optional[int] = None,
                 number_of_channels: int = 2,
                 options: Optional[AudioContextOptions] = None,
                 *, device="cuda"):
        if options is not None or isinstance(latency_hint, AudioContextOptions):
            opts = options if options is not None else latency_hint
            latency_hint = opts.latency_hint
            sample_rate = opts.sample_rate
            sink_id = opts.sink_id
            render_size_hint = opts.render_size_hint
        super().__init__(sample_rate, device)
        if isinstance(latency_hint, (int, float)) and \
                not isinstance(latency_hint, bool):
            # explicit latency in seconds -> frames (callback size honored
            # exactly; the engine renders in whole quanta and drains
            # leftovers, reference: thread.rs:446-472)
            self._callback_frames = max(1, int(latency_hint * sample_rate))
        else:
            if latency_hint not in LATENCY_BUFFER_SIZES:
                raise NotSupportedError(f"invalid latency hint {latency_hint!r}")
            self._callback_frames = LATENCY_BUFFER_SIZES[latency_hint]
        if render_size_hint:
            self._callback_frames = max(self._callback_frames,
                                        int(render_size_hint))
        # internal render chunk: callback size rounded UP to whole quanta
        # (the block walk steps whole 128-frame quanta; arbitrary callback
        # sizes are served from the leftover carry in _render_loop — the
        # reference's render thread does the same)
        self._buffer_frames = max(
            RENDER_QUANTUM_SIZE,
            -(-self._callback_frames // RENDER_QUANTUM_SIZE)
            * RENDER_QUANTUM_SIZE)
        self._number_of_channels = number_of_channels

        from ..nodes.destination import AudioDestinationNode

        self._destination = AudioDestinationNode(
            self, channel_count=number_of_channels, offline=False)

        self._backend = build_backend(sink_id, number_of_channels, sample_rate)
        self._event_loop = EventLoop()
        self._event_loop.start_thread()
        self._stats = AudioStats()
        self._render_capacity = AudioRenderCapacity(
            self, self._stats, self._event_loop)
        self._playback_stats = AudioPlaybackStats(self._stats, sample_rate)

        self._frame = 0
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._states: Optional[dict] = None   # instance axis of 1
        self._cg = None
        self._cg_version = -1
        self._resources = None
        self._lock = threading.Lock()
        self._realtime = True

        self.resume_sync()

    # --- latencies (reference: online.rs:311-333) ---------------------------
    @property
    def base_latency(self) -> float:
        return RENDER_QUANTUM_SIZE / self.sample_rate

    @property
    def output_latency(self) -> float:
        return self._backend.output_latency + \
            self._callback_frames / self.sample_rate

    @property
    def sink_id(self):
        return self._backend.sink_id

    @property
    def render_capacity(self) -> AudioRenderCapacity:
        return self._render_capacity

    @property
    def playback_stats(self) -> AudioPlaybackStats:
        return self._playback_stats

    @property
    def current_time(self) -> float:
        return self._frame / self.sample_rate

    def set_realtime_pacing(self, realtime: bool):
        """Disable deadline pacing (renders as fast as possible) — useful
        for tests and faster-than-realtime streaming deployments."""
        self._realtime = bool(realtime)

    # --- state machine (reference: online.rs:523-784) ----------------------
    def resume_sync(self):
        if self._state == AudioContextState.CLOSED:
            raise InvalidStateError("cannot resume a closed context")
        if self._running:
            return
        self._running = True
        self._set_state(AudioContextState.RUNNING)
        self._thread = threading.Thread(target=self._render_loop, daemon=True,
                                        name="webaudio-render")
        self._thread.start()

    def _stop_render_thread(self):
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def suspend_sync(self):
        if self._state == AudioContextState.CLOSED:
            raise InvalidStateError("cannot suspend a closed context")
        self._stop_render_thread()
        self._set_state(AudioContextState.SUSPENDED)

    def close_sync(self):
        if self._state == AudioContextState.CLOSED:
            return
        self._stop_render_thread()
        self._render_capacity.stop()
        self._backend.close()
        self._event_loop.stop_thread()
        self._set_state(AudioContextState.CLOSED)

    # promise-style variants (reference: online.rs:523-784 async fns):
    # each runs its *_sync counterpart on the shared pool and returns a
    # concurrent.futures.Future (block with .result(), await via
    # asyncio.wrap_future)
    def resume(self):
        from ..futures import submit

        return submit(self.resume_sync)

    def suspend(self):
        from ..futures import submit

        return submit(self.suspend_sync)

    def close(self):
        from ..futures import submit

        return submit(self.close_sync)

    def set_sink_id_sync(self, sink_id):
        """Hot-swap the output backend, keeping the live graph + states
        (the reference migrates the Graph via CloseAndRecycle,
        online.rs:365-453)."""
        was_running = self._running
        if was_running:
            self.suspend_sync()
        self._backend.close()
        self._backend = build_backend(sink_id, self._number_of_channels,
                                      self.sample_rate)
        self._event_loop.post(EventDispatch(EventType.SINK_CHANGE))
        if was_running:
            self.resume_sync()

    def set_onsinkchange(self, cb):
        self._event_loop.add_handler(EventType.SINK_CHANGE, cb)

    def clear_onsinkchange(self):
        """reference: online.rs clear_onsinkchange."""
        self._event_loop.clear_handlers(EventType.SINK_CHANGE)

    def probe_node_state(self, node):
        """Read a node's live render state (e.g. the analyser ring) from
        the running graph as host numpy, without the instance axis — the
        analog of the reference's shared-memory AnalyserRingBuffer reads
        (analysis.rs:74-140).  Copies under the context's lock, so the
        render thread cannot swap the states meanwhile."""
        with self._lock:
            if self._states is None:
                return None
            st = self._states.get(_compiler._k(node.node_id))
            if st is None:
                return None
            return tree_map(lambda x: x.detach().cpu().numpy(),
                            unbatch_states(st))

    # --- diagnostics (reference: online.rs:486-510) -------------------------
    def run_diagnostics(self) -> dict:
        from ..diagnostics import collect_diagnostics

        return collect_diagnostics(self)

    # --- render loop ---------------------------------------------------------
    def _recompile_locked(self):
        version = self._graph_version
        cg = _compiler.compile_graph(
            dict(self._nodes), list(self._edges), self.sample_rate,
            self._buffer_frames, self._destination.node_id, self._device,
            start_frame=self._frame,
            quanta_per_block=self._buffer_frames // RENDER_QUANTUM_SIZE,
            # params stream in per chunk from the live timelines; baking a
            # "constant" would go stale as the timeline advances
            force_dense_params=True)
        init = batch_states(_compiler.zero_states(cg), 1)
        if self._states is not None:
            # states carry across the re-plan for every node whose state
            # keeps its structure (context/offline.py's rule)
            init = {k: old if (old := self._states.get(k)) is not None
                    and _same_structure(old, v) else v
                    for k, v in init.items()}
        self._states = init
        self._cg = cg
        self._cg_version = version
        self._resources = None

    def _render_one_chunk(self) -> np.ndarray:
        B = self._buffer_frames
        if self._device.type == "cuda" and self._device.index is not None:
            # the render thread's current device is the context's ("cuda"
            # with no index is the thread's current device)
            torch.cuda.set_device(self._device)
        with self._lock:
            if self._cg is None or self._cg_version != self._graph_version:
                self._recompile_locked()
            cg = self._cg
            # dense per-chunk params from the live timelines, packed into
            # the plan's row order (cg.dense_params)
            rows = np.zeros((len(cg.dense_params), B), np.float32)
            for i, key in enumerate(cg.dense_params):
                p = cg.param_objects.get(key)
                if p is None:
                    continue
                rows[i] = p.advance_dense(self.sample_rate, B, self._frame)
            states = self._states
        # a cyclic graph plans a delay-bounded block that divides the
        # buffer (compile_graph's clamp): walk nb blocks a chunk
        Bc = cg.block_frames
        nb = B // Bc
        xs = torch.from_numpy(
            _compiler.block_rows(rows, Bc)[None].copy()).to(cg.device)
        if self._resources is None:
            self._resources = _compiler.stage_resources(
                _compiler.collect_resources(cg), cg.device)
        frame0s = [self._frame + b * Bc for b in range(nb)]
        states, out = _compiler.scan_render(cg, states, frame0s, xs,
                                            self._resources)
        chunk = out[0].cpu().numpy()         # the chunk's one host copy
        with self._lock:
            self._states = states
        # upmix to the backend channel count (reference: thread.rs:508-510)
        if chunk.shape[0] != self._number_of_channels:
            from ..ops.mixing import ChannelInterpretation, mix_matrix

            m = mix_matrix(chunk.shape[0], self._number_of_channels,
                           ChannelInterpretation.SPEAKERS)
            chunk = (m @ chunk).astype(np.float32)
        self._frame += B
        self._current_time = self._frame / self.sample_rate
        return chunk

    def _render_loop(self):
        B = self._buffer_frames
        N = self._callback_frames
        budget = N / self.sample_rate
        next_deadline = time.monotonic()
        # leftover carry: the engine renders whole quanta; callbacks of
        # arbitrary size drain from here (reference: thread.rs:446-472)
        carry = np.zeros((self._number_of_channels, 0), np.float32)
        while self._running:
            t0 = time.monotonic()
            while carry.shape[1] < N:
                try:
                    chunk = self._render_one_chunk()
                except Exception as exc:  # keep the loop alive
                    traceback.print_exc()
                    self._event_loop.post(EventDispatch(
                        EventType.PROCESSOR_ERROR, payload=exc))
                    chunk = np.zeros(
                        (self._number_of_channels, B), np.float32)
                    self._frame += B
                carry = chunk if carry.shape[1] == 0 else \
                    np.concatenate([carry, chunk], axis=1)
            out, carry = carry[:, :N], carry[:, N:]
            dur = time.monotonic() - t0
            self._stats.record_render_callback(dur, budget)
            self._backend.write(out, self.current_time)
            self._dispatch_scheduled_events()
            if self._realtime:
                next_deadline += budget
                delay = next_deadline - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                else:
                    next_deadline = time.monotonic()

    def _dispatch_scheduled_events(self):
        """Emit `ended` events for sources whose stop time has passed."""
        t = self.current_time
        for nid, node in list(self._nodes.items()):
            stop = getattr(node, "_stop_time", None)
            if stop is not None and stop <= t and \
                    not getattr(node, "_ended_dispatched", False):
                node._ended_dispatched = True
                if getattr(node, "_onended", None) is not None:
                    self._event_loop.post(EventDispatch(
                        EventType.ENDED, node_id=nid,
                        callback=node._onended))

    # --- media node factories (reference: online.rs:789-828) ----------------
    def create_media_stream_source(self, stream):
        from ..nodes.media_nodes import MediaStreamAudioSourceNode

        return MediaStreamAudioSourceNode(self, stream)

    def create_media_stream_track_source(self, track):
        from ..nodes.media_nodes import MediaStreamTrackAudioSourceNode

        return MediaStreamTrackAudioSourceNode(self, track)

    def create_media_stream_destination(self):
        from ..nodes.media_nodes import MediaStreamAudioDestinationNode

        return MediaStreamAudioDestinationNode(self)

    def create_media_element_source(self, media_element):
        from ..nodes.media_nodes import MediaElementAudioSourceNode

        return MediaElementAudioSourceNode(self, media_element)
