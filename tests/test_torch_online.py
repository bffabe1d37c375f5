"""The real-time AudioContext on the port (webaudio_tpu_torch) against the
JAX package, on the CPU.

Both packages run unpaced AudioContexts (`set_realtime_pacing(False)`)
with a callback sink, the port's with `device="cpu"`, over the graph of
chip_smoke.py's phase zh: a decoded FLAC clip looping through a lowpass
(2,000 Hz, Q 2), a WaveShaper at 4x (tanh, 2,048 points) and a
DynamicsCompressor into the destination, 2 s.  Each context is suspended
right after it starts, the graph built with its source starting at the
context's current time, and the callbacks after the resume compared.

- The callback streams agree within 1e-5 x peak at callback sizes 128,
  441 (the leftover drain of 512-frame chunks) and 1,024.
- A topology change made from the sink callback re-plans once, carries
  every surviving node's state, and the stream still agrees with JAX's.
- Automation scheduled from the sink callback re-plans nothing; the
  resulting a-rate filter sweep agrees with JAX within 1e-4 x peak (the
  f32 sin/cos ulps of ROADMAP's known deviations).
- The state machine, set_sink_id_sync with `sinkchange`, `ended` events,
  render-capacity events and playback stats follow the JAX package's
  semantics; a blocking handler does not stall the render; a file sink's
  WAV holds the callback stream bit for bit; a context left on the card
  without one reports the failed chunks as `processorerror` and never
  moves to the CPU.

Every context closes in a `finally`, and every wait is a loop with a
deadline.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

import webaudio_tpu as wa
import webaudio_tpu_torch as wt
from flac_ref import encode_flac

FS = 48000.0
SECONDS = 2.0
CLIP_RATE = 44100


def _flac_clip(frames=12000):
    t = np.arange(frames)
    x = np.stack([np.sin(t * 0.031) * 0.7 + 0.2 * np.sin(t * 0.0021),
                  np.cos(t * 0.017) * 0.6])
    codes = np.round(x * 32767).astype(np.int64)
    sub = [dict(kind="fixed", order=2, ks=[10])] * 2
    plans, pos = [], 0
    while pos < frames:
        bs = min(4096, frames - pos)
        plans.append((bs, "independent", sub))
        pos += bs
    return encode_flac(codes, CLIP_RATE, 16, plans)


FLAC = _flac_clip()


def _curve(n=2048):
    return np.tanh(3.0 * np.linspace(-1.0, 1.0, n)).astype(np.float32)


def zh_graph(ctx, start=None):
    """The phase-zh graph in `ctx` (either package): returns its nodes."""
    src = ctx.create_buffer_source(loop=True)
    src.buffer = ctx.decode_audio_data_sync(FLAC)
    filt = ctx.create_biquad_filter(type="lowpass", frequency=2000.0, q=2.0)
    shaper = ctx.create_wave_shaper(oversample="4x", curve=_curve())
    comp = ctx.create_dynamics_compressor(threshold=-18.0, ratio=4.0)
    src.connect(filt)
    filt.connect(shaper)
    shaper.connect(comp)
    comp.connect(ctx.destination)
    src.start(ctx.current_time if start is None else start)
    return {"src": src, "filt": filt, "shaper": shaper, "comp": comp}


def _context(mod, sink, latency="playback", **kw):
    if mod is wt:
        kw.setdefault("device", "cpu")
    return mod.AudioContext(latency_hint=latency, sample_rate=FS,
                            sink_id=sink, **kw)


def _wait(cond, seconds=120.0):
    deadline = time.time() + seconds
    while not cond() and time.time() < deadline:
        time.sleep(0.01)
    return cond()


def drive(mod, frames, latency="playback", on_callback=None, ctx_kw=None,
          build=zh_graph):
    """Run `build`'s graph unpaced in an AudioContext of `mod` until the
    callbacks after the resume hold `frames` frames.  `on_callback(k, ctx,
    nodes)` runs on the render thread after callback k (from 1).  Returns
    (the callbacks, the context, the nodes)."""
    chunks, state = [], {}

    def sink(chunk, ts):
        chunks.append(np.array(chunk))
        if on_callback is not None and "nodes" in state:
            on_callback(len(chunks), state["ctx"], state["nodes"])

    ctx = _context(mod, sink, latency, **(ctx_kw or {}))
    try:
        ctx.set_realtime_pacing(False)
        ctx.suspend_sync()
        del chunks[:]
        state["ctx"] = ctx
        state["nodes"] = build(ctx)
        ctx.resume_sync()
        assert _wait(lambda: sum(c.shape[1] for c in chunks) >= frames), \
            "the online loop under-rendered"
        ctx.suspend_sync()
    finally:
        ctx.close_sync()
    return chunks, ctx, state["nodes"]


def _close(got, want, rel, what):
    peak = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape and peak > 0.05
    assert err <= rel * peak, f"{what}: {err} > {rel} x {peak}"


@pytest.mark.parametrize("callback", [128, 441, 1024])
def test_callback_stream_matches_jax(callback):
    frames = int(SECONDS * FS)
    streams = []
    for mod in (wa, wt):
        chunks, ctx, _ = drive(mod, frames, latency=callback / FS)
        assert ctx._callback_frames == callback
        assert all(c.shape == (2, callback) for c in chunks)
        streams.append(np.concatenate(chunks, axis=1)[:, :frames])
    _close(streams[1], streams[0], 1e-5, f"{callback}-frame callbacks")


def _switch_gain(k_switch):
    """From the sink callback: after callback k, put a gain of 0.5
    between the compressor and the destination."""

    def on_callback(k, ctx, nodes):
        if k == k_switch:
            gain = ctx.create_gain(gain=0.5)
            nodes["comp"].disconnect()
            nodes["comp"].connect(gain)
            gain.connect(ctx.destination)

    return on_callback


def test_topology_change_replans_once_and_carries_states(monkeypatch):
    frames = 48 * 1024
    replans = []
    original = wt.AudioContext._recompile_locked

    def recording(self):
        before = self._states
        original(self)
        carried = sorted(k for k in (before or {})
                         if self._states.get(k) is before[k])
        replans.append((self._cg, carried))

    monkeypatch.setattr(wt.AudioContext, "_recompile_locked", recording)
    got, _, nodes = drive(wt, frames, on_callback=_switch_gain(20))
    want, _, _ = drive(wa, frames, on_callback=_switch_gain(20))
    # the graph's plan, then one re-plan for the gain (an earlier plan of
    # the empty graph, if the thread rendered before the suspend, holds
    # no source)
    src = nodes["src"].node_id
    replans = [(cg, c) for cg, c in replans if src in cg.kernels]
    assert len(replans) == 2
    keys = {f"n{nodes[k].node_id}" for k in ("src", "filt", "shaper", "comp")}
    assert keys <= set(replans[1][1]), replans[1][1]
    got = np.concatenate(got, axis=1)[:, :frames]
    want = np.concatenate(want, axis=1)[:, :frames]
    _close(got, want, 1e-5, "topology change")
    # the gain halves the stream from callback 21 on
    assert np.abs(got[:, 21 * 1024:]).max() < 0.6 * np.abs(got[:, :20 * 1024]).max()


def _sweep(k_at):
    def on_callback(k, ctx, nodes):
        if k == k_at:
            f = nodes["filt"].frequency
            f.set_value_at_time(2000.0, ctx.current_time)
            f.exponential_ramp_to_value_at_time(500.0, ctx.current_time + 0.5)

    return on_callback


def test_automation_does_not_replan():
    frames = int(SECONDS * FS)
    plans = []

    def watch(k, ctx, nodes):
        plans.append(ctx._cg)
        _sweep(10)(k, ctx, nodes)

    got, _, _ = drive(wt, frames, on_callback=watch)
    want, _, _ = drive(wa, frames, on_callback=_sweep(10))
    assert len(plans) > 20 and all(p is plans[0] for p in plans)
    got = np.concatenate(got, axis=1)[:, :frames]
    want = np.concatenate(want, axis=1)[:, :frames]
    _close(got, want, 1e-4, "filter sweep")


def test_state_machine_matches_jax():
    seen = {}
    for mod in (wa, wt):
        events = []
        ctx = _context(mod, "none")
        try:
            ctx.set_onstatechange(lambda ev: events.append(ctx.state.value))
            ctx.set_realtime_pacing(False)
            states = [ctx.state.value]
            ctx.suspend_sync()
            t = ctx.current_time
            states.append(ctx.state.value)
            time.sleep(0.05)
            states.append(ctx.current_time == t)
            ctx.resume().result(timeout=30)
            states.append(ctx.state.value)
            assert _wait(lambda: ctx.current_time > t, 30)
            ctx.suspend().result(timeout=30)
            ctx.close().result(timeout=30)
            states.append(ctx.state.value)
            for call in (ctx.resume_sync, ctx.suspend_sync):
                with pytest.raises(mod.InvalidStateError):
                    call()
            ctx.close_sync()           # closing twice is a no-op
        finally:
            ctx.close_sync()
        seen[mod] = (states, events)
    assert seen[wt] == seen[wa]
    assert seen[wt][0] == ["running", "suspended", True, "running", "closed"]


def test_set_sink_id_and_sinkchange_events(tmp_path):
    from webaudio_tpu.constants import NotFoundError as JNotFound
    from webaudio_tpu_torch.constants import NotFoundError

    seen = {}
    for mod, not_found in ((wa, JNotFound), (wt, NotFoundError)):
        changes = []
        ctx = _context(mod, lambda c, t: None)
        try:
            ctx.set_realtime_pacing(False)
            ctx.set_onsinkchange(lambda *a: changes.append(ctx.sink_id))
            ids = [ctx.sink_id]
            ctx.set_sink_id_sync("none")
            ids.append(ctx.sink_id)
            path = str(tmp_path / f"{mod.__name__}.wav")
            ctx.set_sink_id_sync(f"file:{path}")
            ids.append(ctx.sink_id == f"file:{path}")
            with pytest.raises(not_found):
                ctx.set_sink_id_sync("speaker-that-does-not-exist")
            ids.append(ctx.state.value)
            assert _wait(lambda: len(changes) >= 2, 10)
        finally:
            ctx.close_sync()
        assert os.path.getsize(path) > 44
        seen[mod] = (ids, len(changes))
    assert seen[wt] == seen[wa]


def test_file_sink_holds_the_callback_stream(tmp_path):
    """A second context with a file sink writes, after the silence it
    rendered before its graph existed, the first context's callback
    stream bit for bit."""
    frames = 40 * 1024
    chunks, _, _ = drive(wt, frames)
    stream = np.concatenate(chunks, axis=1)[:, :frames]
    path = str(tmp_path / "sink.wav")
    ctx = _context(wt, f"file:{path}")
    try:
        ctx.set_realtime_pacing(False)
        ctx.suspend_sync()
        f0 = int(round(ctx.current_time * FS))
        zh_graph(ctx)
        ctx.resume_sync()
        assert _wait(lambda: ctx.current_time * FS >= f0 + frames)
    finally:
        ctx.close_sync()
    data = ctx.decode_audio_data_sync(path).to_array()
    assert not data[:, :f0].any()
    np.testing.assert_array_equal(data[:, f0:f0 + frames], stream)


def test_ended_events_match_jax():
    fired = {}
    for mod in (wa, wt):
        ended = []

        def build(ctx):
            src = ctx.create_constant_source(offset=0.5)
            src.connect(ctx.destination)
            src.set_onended(lambda *a: ended.append(ctx.current_time))
            src.start(ctx.current_time)
            src.stop(ctx.current_time + 0.05)
            return {"src": src}

        drive(mod, int(0.2 * FS), build=build)
        assert _wait(lambda: ended, 10)
        time.sleep(0.05)
        fired[mod] = len(ended)
    assert fired[wt] == fired[wa] == 1


def test_render_capacity_and_playback_stats_match_jax():
    keys = {}
    for mod in (wa, wt):
        events, chunks = [], []
        ctx = _context(mod, lambda c, t: chunks.append(c.shape[1]),
                       latency="balanced")
        try:
            ctx.set_realtime_pacing(False)
            cap = ctx.render_capacity
            assert cap is ctx.render_capacity
            cap.set_onupdate(events.append)
            cap.start(update_interval=0.05)
            zh_graph(ctx)
            n = len(chunks)
            # the graph's first chunks (its plan; JAX's compile) and three
            # capacity intervals
            assert _wait(lambda: len(chunks) > n + 3 and len(events) >= 3)
            cap.stop()
            # the poller reset the counters each interval; now they grow
            # again (playback stats re-read them once a second)
            stats = ctx.playback_stats
            assert _wait(lambda: stats.total_frames_duration > 0.0)
            snap = stats.to_json()
        finally:
            ctx.close_sync()
        for ev in events:
            assert type(ev).__name__ == "AudioRenderCapacityEvent"
            assert 0.0 <= ev.average_load <= 1.0
            assert 0.0 <= ev.peak_load <= 1.0
            assert 0.0 <= ev.underrun_ratio <= 1.0
            assert ev.timestamp >= 0.0
        # the reference counts 128 frames a callback
        assert snap["total_duration"] == snap["callbacks"] * 128 / FS
        assert snap["underrun_events"] <= snap["callbacks"]
        stats.reset_latency()
        assert stats.average_latency == stats.maximum_latency == 0.0
        keys[mod] = sorted(snap)
    assert keys[wt] == keys[wa]


def test_blocking_handler_does_not_stall_render():
    """tests/stall_render.rs's rule: a handler that blocks far longer
    than the budget does not stall the render loop."""
    release = threading.Event()
    chunks = []
    ctx = _context(wt, lambda c, t: chunks.append(c), latency="interactive")
    try:
        ctx.set_realtime_pacing(False)
        ctx.render_capacity.set_onupdate(lambda ev: release.wait(10.0))
        ctx.render_capacity.start(update_interval=0.05)
        osc = ctx.create_oscillator()
        osc.connect(ctx.destination)
        osc.start()
        assert _wait(lambda: len(chunks) > 10, 30)
        time.sleep(0.3)                # the handler is blocked by now
        n = len(chunks)
        assert _wait(lambda: len(chunks) > n + 20, 10), \
            "render loop stalled behind a blocking event handler"
    finally:
        release.set()
        ctx.close_sync()


def test_default_device_is_the_card():
    errors = []
    ctx = wt.AudioContext(sample_rate=FS, sink_id="none")
    try:
        assert ctx.device == torch.device("cuda")
        if torch.cuda.is_available():
            return
        ctx._event_loop.add_handler(wt.EventType.PROCESSOR_ERROR,
                                    errors.append)
        ctx.set_realtime_pacing(False)
        assert _wait(lambda: errors, 30)
    finally:
        ctx.close_sync()
    # a chunk on a card that is absent fails; it never renders on the CPU
    assert ctx.current_time > 0.0


def test_package_exports_every_lazy_name_of_jax():
    """Every name the JAX package exports lazily resolves on the port, to
    the port's own object."""
    for name in wa._LAZY:
        obj = getattr(wt, name)
        assert obj.__module__.startswith("webaudio_tpu_torch"), name


def online_gap(seconds=10.0):
    """Each package's online callback stream (1,024 and 16,384-frame
    chunks) against its offline render of the zh graph on the CPU:
    {(package, chunk): max |online - offline| / peak}."""
    frames = int(seconds * FS)
    gaps = {}
    for mod in (wa, wt):
        for hint in (None, 16384):
            chunks, _, _ = drive(mod, frames, ctx_kw={"render_size_hint": hint})
            on = np.concatenate(chunks, axis=1)[:, :frames]
            off = mod.OfflineAudioContext(2, frames, FS, **(
                {"device": "cpu"} if mod is wt else {}))
            zh_graph(off, start=0.0)
            want = off.start_rendering_sync().to_array()
            gaps[(mod.__name__, hint or 1024)] = \
                float(np.abs(on - want).max() / np.abs(want).max())
    return gaps


if __name__ == "__main__":
    # python tests/test_torch_online.py: the online-vs-offline gaps at 10 s
    for key, gap in online_gap().items():
        print(key, gap)
