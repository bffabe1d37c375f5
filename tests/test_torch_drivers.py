"""Sessions, time segments and futures on the port (webaudio_tpu_torch)
against the JAX package, on the CPU: RenderSession with checkpoints,
render_time_sharded, the start_rendering / suspend / resume futures,
diagnostics and every ported kernel's tail_frames.

- A port session equals its one-shot render within 5e-6 absolute (the
  session streams every param dense: the biquad's a-rate scan, the
  oscillator's cumsum phase; tests/test_checkpoint.py's bound), and a JAX
  session at the same block within 1e-5 x peak, on the slice graph and on
  config 3 (its block clamped by the feedback delay).
- A restored session continues bit-equal to the uninterrupted one, and a
  checkpoint the JAX session wrote restores in the port's session and
  continues within 1e-5 x peak of the JAX session's continuation.
- R5's 128-frame blocks through the grain bank: a 64-grain session at
  quanta_per_block=1 within 3e-5 absolute of the JAX session.
- Time segments over 8 CPU "devices" (JAX: the 8 virtual devices of
  tests/conftest.py) equal JAX's render within 1e-6 x peak and the
  sequential render within tests/test_segments.py's bounds; graphs with a
  compressor or a feedback cycle refuse.
- The futures as tests/test_async_api.py holds them, each waited on with a
  timeout, and the same mutation through suspend_sync bit-equal.
"""

import json
import os

import numpy as np
import pytest

import jax

import webaudio_tpu as wa
import webaudio_tpu_torch as wt
from webaudio_tpu.checkpoint import RenderSession as JSession
from webaudio_tpu.diagnostics import collect_diagnostics as jdiag
from webaudio_tpu.graph import compiler as jcomp
from webaudio_tpu.parallel.segments import (
    NotTimeShardableError as JNotShardable, render_time_sharded as jsharded,
)
from webaudio_tpu_torch.checkpoint import RenderSession
from webaudio_tpu_torch.diagnostics import collect_diagnostics, profile_render
from webaudio_tpu_torch.graph import compiler as tcomp
from webaudio_tpu_torch.parallel.segments import (
    NotTimeShardableError, render_time_sharded, segment_plan,
)

FS = 48000.0
REVERB_FS = 44100.0


def _context(mod, channels, length, fs=FS):
    if mod is wt:
        return wt.OfflineAudioContext(channels, length, fs, device="cpu")
    return wa.OfflineAudioContext(channels, length, fs)


def _assert_close(got, want, rel=1e-5):
    peak = float(np.abs(want).max())
    assert got.shape == want.shape and peak > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * peak)


def delay_osc(mod, n=4096, fs=FS):
    """tests/test_checkpoint.py's graph: a 440 Hz oscillator through a
    5 ms delay."""
    ctx = _context(mod, 1, n, fs)
    osc = ctx.create_oscillator(frequency=440.0)
    d = ctx.create_delay(max_delay_time=0.01)
    d.delay_time.value = 0.005
    osc.connect(d)
    d.connect(ctx.destination)
    osc.start()
    return ctx


def slice_graph(mod, n):
    """The slice graph: a looping source of bench.py's synthetic buffer ->
    lowpass 2000 Hz, Q 2 -> WaveShaper (tanh, 2048 points)."""
    ctx = _context(mod, 2, n)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = mod.AudioBuffer.from_array(
        np.sin(np.arange(2 * 48000) * 0.03, dtype=np.float32)[None]
        .repeat(2, 0), FS)
    src.start()
    filt = ctx.create_biquad_filter(type="lowpass", frequency=2000.0, q=2.0)
    shaper = ctx.create_wave_shaper(
        curve=np.tanh(np.linspace(-2.0, 2.0, 2048)).astype(np.float32))
    src.connect(filt)
    filt.connect(shaper)
    shaper.connect(ctx.destination)
    return ctx


def reverb_graph(mod, n):
    """BASELINE config 3 at 44.1 kHz with seeded stand-ins: a looping dry
    buffer into a normalized convolver (0.5 s of decaying stereo noise)
    and a 0.31 s delay fed back through 0.4."""
    ctx = _context(mod, 2, n, REVERB_FS)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = mod.AudioBuffer.from_array(
        np.sin(np.arange(88200) * 0.03, dtype=np.float32)[None].repeat(2, 0),
        REVERB_FS)
    src.start()
    rng = np.random.default_rng(7)
    m = int(0.5 * REVERB_FS)
    ir = (rng.standard_normal((2, m)) * np.exp(-np.arange(m) / REVERB_FS
                                               / 0.1)).astype(np.float32)
    verb = ctx.create_convolver()
    verb.set_buffer(mod.AudioBuffer.from_array(ir, REVERB_FS))
    src.connect(verb)
    verb.connect(ctx.destination)
    d = ctx.create_delay(max_delay_time=1.0)
    d.delay_time.value = 0.31
    fb = ctx.create_gain(gain=0.4)
    src.connect(d)
    d.connect(fb)
    fb.connect(d)
    fb.connect(ctx.destination)
    return ctx


def granular(mod, n_grains=64, seconds=1.0):
    """benches/suite.py::case_granular_grains cut to `seconds`: one
    buffer source and one 90 ms gain envelope a grain, 44.1 kHz."""
    fs = 44100.0
    ctx = _context(mod, 2, int(fs * seconds), fs)
    sample = mod.AudioBuffer.from_array(
        np.sin(np.arange(2 * 44100) * 0.05, dtype=np.float32)[None]
        .repeat(2, 0), fs)
    rng = np.random.RandomState(1)
    for i in range(n_grains):
        when = i * (seconds - 0.2) / n_grains
        offset = 0.3 + 2.0 * (i / n_grains) + rng.rand() * 0.05
        src = ctx.create_buffer_source(playback_rate=0.9 + 0.2 * rng.rand())
        src.buffer = sample
        env = ctx.create_gain(gain=0.0)
        env.gain.set_value_at_time(0.0, when)
        env.gain.linear_ramp_to_value_at_time(0.4, when + 0.045)
        env.gain.linear_ramp_to_value_at_time(0.0, when + 0.09)
        src.connect(env)
        env.connect(ctx.destination)
        src.start(when, offset, 0.09)
    return ctx


def _session(mod, make, n_steps, qpb, **kw):
    s = (RenderSession if mod is wt else JSession)(make(mod, **kw),
                                                   quanta_per_block=qpb)
    return s, np.concatenate([s.step(qpb * 128) for _ in range(n_steps)],
                             axis=1)


# --- RenderSession ------------------------------------------------------------

def test_incremental_matches_oneshot(tmp_path):
    """tests/test_checkpoint.py:20 on the port: a session saved after
    2,048 frames and restored into a fresh context continues the render."""
    full = delay_osc(wt).start_rendering_sync().get_channel_data(0)
    s = RenderSession(delay_osc(wt), quanta_per_block=8)
    first = s.step(2048)
    ck = str(tmp_path / "ck.npz")
    s.save(ck)
    s2 = RenderSession(delay_osc(wt), quanta_per_block=8)
    s2.restore(ck)
    assert s2.frame == 2048
    second = s2.step(2048)
    got = np.concatenate([first[0], second[0]])
    np.testing.assert_allclose(got, full, atol=5e-6)
    # and the JAX session, which the port's follows step for step
    js = JSession(delay_osc(wa), quanta_per_block=8)
    want = np.concatenate([js.step(2048)[0], js.step(2048)[0]])
    _assert_close(got, want)


@pytest.mark.parametrize("make,qpb,steps,frames", [
    (slice_graph, 16, 4, 8192), (reverb_graph, 128, 3, 49152)],
    ids=["slice", "config3"])
def test_session_matches_jax_session(make, qpb, steps, frames):
    ts, got = _session(wt, make, steps, qpb, n=frames)
    js, want = _session(wa, make, steps, qpb, n=frames)
    assert ts._cg.block_frames == js._cg.block_frames
    assert sorted(ts._cg.dense_params) == sorted(js._cg.dense_params)
    _assert_close(got, want)
    # against the one-shot render (its constant params fold: the LTI FDL,
    # the constant-delay read), well inside the goldens' bound
    one = make(wt, n=frames).start_rendering_sync().to_array()
    _assert_close(got[:, :frames], one, 1e-4)


def test_config3_session_block_is_clamped_by_the_cycle():
    """An explicit block in a cyclic graph clamps to the largest divisor of
    the request within the feedback delay's bound (0.31 s: 106 quanta), as
    JAX's compile_graph does; a session then steps 2 blocks a step."""
    ctx = reverb_graph(wt, 16384)
    jctx = reverb_graph(wa, 16384)
    for comp, c, extra in ((tcomp, ctx, ("cpu",)), (jcomp, jctx, ())):
        cg = comp.compile_graph(dict(c._nodes), list(c._edges),
                                c.sample_rate, 16384,
                                c._destination.node_id, *extra,
                                quanta_per_block=128,
                                force_dense_params=True)
        assert cg.block_frames == 8192 and cg.two_rate_m == 1
        assert len(cg.dense_params) == sum(len(n.params) for n in
                                           c._nodes.values())


@pytest.mark.parametrize("make,qpb,steps,save_at", [
    (slice_graph, 16, 4, 2), (reverb_graph, 128, 3, 1),
    (granular, 1, 3, 1)], ids=["slice", "config3", "granular"])
def test_restored_session_is_bit_equal(tmp_path, make, qpb, steps, save_at):
    frames = steps * qpb * 128 if make is not granular else None
    kw = {"n": frames} if frames else {}
    _, whole = _session(wt, make, steps, qpb, **kw)
    s = RenderSession(make(wt, **kw), quanta_per_block=qpb)
    for _ in range(save_at):
        s.step(qpb * 128)
    path = str(tmp_path / "s.npz")
    s.save(path)
    with np.load(path) as z:
        header = json.loads(str(z["__header__"]))
    assert header["frame"] == save_at * qpb * 128
    assert "treedef" not in header and len(header["paths"]) == \
        header["n_leaves"]
    r = RenderSession(make(wt, **kw), quanta_per_block=qpb)
    r.restore(path)
    rest = np.concatenate([r.step(qpb * 128)
                           for _ in range(steps - save_at)], axis=1)
    np.testing.assert_array_equal(rest, whole[:, save_at * qpb * 128:])
    assert r._context.current_time == steps * qpb * 128 / \
        r._context.sample_rate


@pytest.mark.parametrize("make,qpb,steps,save_at,n", [
    (slice_graph, 16, 4, 2, 8192), (reverb_graph, 128, 3, 1, 49152)],
    ids=["slice", "config3"])
def test_jax_checkpoint_restores_in_the_port(tmp_path, make, qpb, steps,
                                             save_at, n):
    """The JAX session's npz (its treedef header, JAX's flatten order) is
    the port's state carried across: restored through
    convert.states_from_jax, the port continues as JAX does."""
    js = JSession(make(wa, n=n), quanta_per_block=qpb)
    for _ in range(save_at):
        js.step(qpb * 128)
    path = str(tmp_path / "jax.npz")
    js.save(path)
    want = np.concatenate([js.step(qpb * 128)
                           for _ in range(steps - save_at)], axis=1)
    with np.load(path) as z:
        assert "treedef" in json.loads(str(z["__header__"]))
    ts = RenderSession(make(wt, n=n), quanta_per_block=qpb)
    ts.restore(path)
    assert ts.frame == save_at * qpb * 128
    got = np.concatenate([ts.step(qpb * 128)
                          for _ in range(steps - save_at)], axis=1)
    _assert_close(got, want)


def test_checkpoint_of_another_graph_is_refused(tmp_path):
    s = RenderSession(slice_graph(wt, 4096), quanta_per_block=8)
    s.step(1024)
    path = str(tmp_path / "s.npz")
    s.save(path)
    other = RenderSession(delay_osc(wt), quanta_per_block=8)
    with pytest.raises(ValueError, match="graph"):
        other.restore(path)


def test_granular_128_frame_session_matches_jax():
    """R5: 128-frame blocks through the grain bank (64 grains, lane-packed,
    read mode fused) against the JAX session, within the granular bound."""
    ts, got = _session(wt, granular, 3, 1)
    (fk,) = [k for k in ts._cg.kernels.values()
             if type(k).__name__ == "_FusedVoicesKernel"]
    assert ts._cg.block_frames == 128 and fk.use_lanes
    assert fk.read_mode == "fused"
    _, want = _session(wa, granular, 3, 1)
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-5)
    assert np.sum((got - want) ** 2.0) <= 1e-9 * np.sum(want ** 2.0)


def test_session_advances_live_timelines():
    """After each step the control side's param values follow the
    render position, as JAX's advance_dense keeps them."""
    vals = []
    for mod in (wt, wa):
        ctx = slice_graph(mod, 8192)
        (filt,) = [n for n in ctx._nodes.values()
                   if type(n).__name__ == "BiquadFilterNode"]
        filt.frequency.linear_ramp_to_value_at_time(500.0, 8192 / FS)
        s = (RenderSession if mod is wt else JSession)(ctx, 16)
        s.step(2048)
        vals.append((filt.frequency.value, ctx.current_time))
    assert vals[0] == pytest.approx(vals[1], rel=1e-6)
    assert 500.0 < vals[0][0] < 2000.0


# --- render_time_sharded --------------------------------------------------------

def segments_graph(mod, fs=FS, seconds=2.0):
    """tests/test_segments.py's graph: a sawtooth through a lowpass plus a
    looping buffer source through a gain."""
    ctx = _context(mod, 2, int(fs * seconds), fs)
    osc = ctx.create_oscillator(type="sawtooth", frequency=220.0)
    filt = ctx.create_biquad_filter(type="lowpass", frequency=3000.0, q=4.0)
    buf = ctx.create_buffer(1, 3000, fs)
    buf.copy_to_channel(np.sin(np.arange(3000) * 0.02).astype(np.float32), 0)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = buf
    src.start(0.25)
    g = ctx.create_gain(gain=0.5)
    osc.connect(filt)
    filt.connect(ctx.destination)
    src.connect(g)
    g.connect(ctx.destination)
    osc.start()
    return ctx


def reverb_osc(mod):
    """tests/test_segments.py::test_time_sharded_with_reverb's graph."""
    fs = 44100.0
    ctx = _context(mod, 2, int(fs * 2), fs)
    osc = ctx.create_oscillator(frequency=440.0)
    verb = ctx.create_convolver(disable_normalization=True)
    rng = np.random.RandomState(0)
    ir = ctx.create_buffer(1, 8000, fs)
    ir.copy_to_channel((rng.randn(8000) * np.exp(-np.arange(8000) / 2000)
                        * 0.05).astype(np.float32), 0)
    verb.set_buffer(ir)
    osc.connect(verb)
    verb.connect(ctx.destination)
    osc.start()
    return ctx


@pytest.mark.parametrize("make,rel", [(segments_graph, 5e-5),
                                      (reverb_osc, 1e-4)],
                         ids=["sawtooth_and_loop", "reverb"])
def test_time_sharded_matches_sequential_and_jax(make, rel):
    """tests/test_segments.py:32 and :40: 8 segments (8 CPU devices on the
    port's side, JAX's 8 virtual devices) against the sequential render,
    and against JAX's sharded render."""
    assert len(jax.devices()) == 8
    seq = make(wt).start_rendering_sync().to_array()
    got = render_time_sharded(make(wt), devices=["cpu"] * 8)
    assert got.shape == seq.shape
    _assert_close(got, seq, rel)
    _assert_close(got, jsharded(make(wa)), 1e-6)


def test_segment_plan_matches_jax_halo_and_starts():
    """The block, the halo's whole blocks and each segment's block starts
    are the JAX package's, so the halo's output is dropped at the same
    frames."""
    ctx = segments_graph(wt)
    total = ctx.length
    qpb = max(1, min(-(-total // 128) // 32 or 1, 128))
    cg = tcomp.compile_graph(dict(ctx._nodes), list(ctx._edges), FS, total,
                             ctx._destination.node_id, "cpu",
                             quanta_per_block=qpb)
    jctx = segments_graph(wa)
    jcg = jcomp.compile_graph(dict(jctx._nodes), list(jctx._edges), FS,
                              total, jctx._destination.node_id,
                              quanta_per_block=qpb)
    assert cg.block_frames == jcg.block_frames == qpb * 128
    halo = max(k.tail_frames() for k in cg.kernels.values())
    assert halo == max(k.tail_frames() for k in jcg.kernels.values()) > 0
    B = cg.block_frames
    halo_blocks, nb_net, starts = segment_plan(total, 8, B, halo)
    # JAX's own arithmetic (webaudio_tpu/parallel/segments.py:71-82)
    j_halo_blocks = -(-halo // B)
    j_net = -(-(-(-total // B)) // 8)
    assert (halo_blocks, nb_net) == (j_halo_blocks, j_net)
    for d in range(8):
        np.testing.assert_array_equal(
            starts[d], (d * j_net - j_halo_blocks
                        + np.arange(j_net + j_halo_blocks)) * B)


def test_unbounded_state_refuses():
    """tests/test_segments.py:63: a compressor's detector has unbounded
    history; a feedback cycle renders sequentially."""
    for mod, refuse, error in ((wt, render_time_sharded, NotTimeShardableError),
                               (wa, jsharded, JNotShardable)):
        ctx = _context(mod, 1, int(FS), FS)
        osc = ctx.create_oscillator()
        comp = ctx.create_dynamics_compressor()
        osc.connect(comp)
        comp.connect(ctx.destination)
        osc.start()
        kw = {"devices": ["cpu"] * 8} if mod is wt else {}
        with pytest.raises(error):
            refuse(ctx, **kw)
        with pytest.raises(error):
            refuse(reverb_graph(mod, 8192), **kw)
    assert issubclass(NotTimeShardableError, wt.NotSupportedError)


# --- tail_frames ----------------------------------------------------------------

def spatial_graph(mod):
    """An HRTF and an equal-power panner, a 2x WaveShaper, an analyser, a
    splitter/merger, a constant source and an a-rate biquad."""
    ctx = _context(mod, 2, 4096, 44100.0)
    osc = ctx.create_oscillator(type="sawtooth", frequency=220.0)
    hrtf = ctx.create_panner(panning_model="HRTF", position_z=-2.0)
    ep = ctx.create_panner(panning_model="equalpower", position_x=1.0)
    ws = ctx.create_wave_shaper(curve=np.linspace(-1, 1, 64,
                                                  dtype=np.float32),
                                oversample="2x")
    an = ctx.create_analyser()
    sp = ctx.create_channel_splitter(2)
    mg = ctx.create_channel_merger(2)
    cs = ctx.create_constant_source(offset=0.1)
    bq = ctx.create_biquad_filter(frequency=800.0)
    bq.frequency.linear_ramp_to_value_at_time(3000.0, 0.05)
    iir = ctx.create_iir_filter([0.2, 0.2], [1.0, -0.5])
    sp_pan = ctx.create_stereo_panner(pan=0.3)
    osc.connect(hrtf)
    osc.connect(ep)
    hrtf.connect(ws)
    ws.connect(an)
    an.connect(sp)
    sp.connect(mg, 0, 1)
    sp.connect(mg, 1, 0)
    mg.connect(ctx.destination)
    ep.connect(bq)
    bq.connect(iir)
    iir.connect(sp_pan)
    sp_pan.connect(ctx.destination)
    cs.connect(ctx.destination)
    osc.start()
    cs.start()
    return ctx


def bank_graph(mod):
    """An OscillatorBankNode and 32 auto-fused sines through a lowpass
    each, plus an automated-rate buffer source and a non-cycle delay."""
    ctx = _context(mod, 2, 4096)
    bank = ctx.create_oscillator_bank([110.0, 220.0, 330.0])
    bank.connect(ctx.destination)
    for i in range(32):
        o = ctx.create_oscillator(frequency=200.0 + 10 * i)
        f = ctx.create_biquad_filter(frequency=1000.0)
        g = ctx.create_gain(gain=0.01)
        o.connect(f)
        f.connect(g)
        g.connect(ctx.destination)
        o.start()
    src = ctx.create_buffer_source(loop=True)
    src.buffer = mod.AudioBuffer.from_array(
        np.sin(np.arange(1000) * 0.1, dtype=np.float32)[None], FS)
    src.playback_rate.linear_ramp_to_value_at_time(1.5, 0.05)
    src.start()
    d = ctx.create_delay(max_delay_time=0.02)
    d.delay_time.value = 0.01
    src.connect(d)
    d.connect(ctx.destination)
    return ctx


@pytest.mark.parametrize("make", [
    lambda m: slice_graph(m, 4096), lambda m: reverb_graph(m, 8192),
    segments_graph, reverb_osc, spatial_graph, bank_graph,
    lambda m: delay_osc(m)],
    ids=["slice", "config3", "segments", "reverb_osc", "spatial", "banks",
         "delay"])
def test_tail_frames_equal_jax(make, monkeypatch):
    """Every ported kernel's tail_frames() equals its JAX kernel's on the
    same graph (node ids are creation order in both packages; fused banks
    derive theirs from their members')."""
    monkeypatch.setenv("WEBAUDIO_FUSE_THRESHOLD", "8")
    tails = []
    for mod, comp, extra in ((wt, tcomp, ("cpu",)), (wa, jcomp, ())):
        ctx = make(mod)
        cg = comp.compile_graph(dict(ctx._nodes), list(ctx._edges),
                                ctx.sample_rate, ctx.length,
                                ctx._destination.node_id, *extra)
        tails.append({nid: (type(k).__name__, k.tail_frames())
                      for nid, k in cg.kernels.items()})
    port, jx = tails
    assert port.keys() == jx.keys()
    for nid in port:
        assert port[nid][1] == jx[nid][1], (nid, port[nid], jx[nid])


# --- futures ----------------------------------------------------------------

def test_offline_start_rendering_future():
    """tests/test_async_api.py:23 on the port."""
    ctx = _context(wt, 1, int(FS * 0.25))
    src = ctx.create_constant_source(offset=0.5)
    src.connect(ctx.destination)
    src.start()
    buf = ctx.start_rendering().result(timeout=120)
    assert buf.length == ctx.length
    assert abs(float(buf.get_channel_data(0)[1000]) - 0.5) < 1e-6


def _suspend_graph(mod):
    ctx = _context(mod, 1, int(FS * 0.5))
    src = ctx.create_constant_source(offset=1.0)
    g = ctx.create_gain(gain=0.25)
    src.connect(g)
    g.connect(ctx.destination)
    src.start()
    return ctx, g


def test_offline_suspend_future_resume():
    """tests/test_async_api.py:35 on the port: suspend(t) resolves when the
    render reaches t and holds it until resume(); a mutation made while
    suspended is picked up, as the same mutation through suspend_sync and
    as JAX's futures render it."""
    outs = []
    for mod in (wt, wa):
        ctx, g = _suspend_graph(mod)
        suspended = ctx.suspend(0.25)
        render_fut = ctx.start_rendering()
        suspended.result(timeout=120)
        assert ctx.state.value == "suspended"
        assert not render_fut.done()
        g.gain.value = 1.0
        ctx.resume().result(timeout=10)
        outs.append(render_fut.result(timeout=120).get_channel_data(0))
    ch = outs[0]
    assert abs(float(ch[int(0.1 * FS)]) - 0.25) < 1e-6
    assert abs(float(ch[int(0.4 * FS)]) - 1.0) < 1e-6
    np.testing.assert_array_equal(*outs)
    ctx, g = _suspend_graph(wt)
    ctx.suspend_sync(0.25, lambda c: setattr(g.gain, "value", 1.0))
    np.testing.assert_array_equal(
        ctx.start_rendering_sync().get_channel_data(0), outs[0])


def test_offline_resume_without_suspend_raises():
    """tests/test_async_api.py:60 on the port."""
    ctx = _context(wt, 1, 1024)
    with pytest.raises(wt.InvalidStateError):
        ctx.resume()


def test_start_rendering_error_reaches_the_future():
    ctx = _context(wt, 1, 1024)
    ctx.start_rendering_sync()
    with pytest.raises(wt.InvalidStateError):
        ctx.start_rendering().result(timeout=60)


# --- the structural version, create_audio_param, diagnostics -----------------

def test_graph_and_param_versions_bump_where_jax_bumps():
    """Structural changes bump `_graph_version` and automation bumps
    `_param_version`, call for call as in the JAX package."""
    seen = []
    for mod in (wt, wa):
        ctx = _context(mod, 2, 1024)
        v = [(ctx._graph_version, ctx._param_version)]
        osc = ctx.create_oscillator()
        v.append((ctx._graph_version, ctx._param_version))
        g = ctx.create_gain()
        osc.connect(g)
        g.connect(ctx.destination)
        osc.start()
        osc.stop(0.01)
        osc.type = "square"
        g.channel_count = 1
        g.channel_count_mode = "explicit"
        g.channel_interpretation = "discrete"
        v.append((ctx._graph_version, ctx._param_version))
        g.gain.set_value_at_time(0.5, 0.001)
        g.gain.linear_ramp_to_value_at_time(0.1, 0.01)
        g.gain.value = 0.3
        v.append((ctx._graph_version, ctx._param_version))
        sh = ctx.create_wave_shaper()
        sh.curve = np.zeros(4, np.float32)
        sh.oversample = "2x"
        bq = ctx.create_biquad_filter()
        bq.type = "highpass"
        src = ctx.create_buffer_source()
        src.buffer = mod.AudioBuffer.from_array(np.zeros((1, 8), np.float32),
                                                FS)
        src.loop_start = 0.0
        src.loop_end = 0.0001
        cv = ctx.create_convolver()
        cv.buffer = mod.AudioBuffer.from_array(np.ones((1, 8), np.float32),
                                               FS)
        pn = ctx.create_panner()
        pn.panning_model = "HRTF"
        g.disconnect()
        v.append((ctx._graph_version, ctx._param_version))
        seen.append(v)
    assert seen[0] == seen[1]


def test_create_audio_param():
    d = wt.AudioParamDescriptor("p", wt.AutomationRate.K, 0.5, 0.0, 1.0)
    p = _context(wt, 1, 128).create_audio_param(d)
    q = _context(wa, 1, 128).create_audio_param(
        wa.AudioParamDescriptor("p", wa.AutomationRate.K, 0.5, 0.0, 1.0))
    assert (p.value, p.min_value, p.max_value, p.automation_rate.value) == \
        (q.value, q.min_value, q.max_value, q.automation_rate.value)
    for x in (p, q):
        x.automation_rate = "a-rate"
        x.linear_ramp_to_value_at_time(1.0, 128 / FS)
    got = p.advance_dense(FS, 256, 0)
    np.testing.assert_array_equal(got, q.advance_dense(FS, 256, 0))
    assert got[0] == 0.5 and got[-1] == 1.0 and p.value == q.value == 1.0


def test_collect_diagnostics_reports_the_plan(tmp_path):
    ctx = slice_graph(wt, 4096)
    before = collect_diagnostics(ctx)
    assert "compiled" not in before and before["device"] == "cpu"
    jd = jdiag(slice_graph(wa, 4096))
    with profile_render(str(tmp_path / "trace")) as prof:
        ctx.start_rendering_sync()
    diag = collect_diagnostics(ctx)
    assert diag["compiled"]["block_frames"] == \
        ctx.render_stats["segments"][-1]["block_frames"]
    assert [n["type"] for n in diag["graph"]["nodes"]] == \
        [n["type"] for n in before["graph"]["nodes"]]
    assert diag["graph"]["edges"] == jd["graph"]["edges"]
    assert diag["fusion"] == jd["fusion"]
    with open(prof.path) as f:
        events = json.load(f)["traceEvents"]
    assert events and os.path.dirname(prof.path) == str(tmp_path / "trace")
    assert len(prof.profiler.key_averages()) > 0
