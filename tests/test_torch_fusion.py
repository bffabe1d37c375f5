"""Source fusion and granular synthesis on the port
(webaudio_tpu_torch/graph/fusion.py) against the JAX package, on the CPU.

Each graph is built twice by one function, once per package, from the same
seeded numpy buffer.  The JAX package renders with WEBAUDIO_GRAIN_READ set
to the read mode the port resolves, so both take the same path; on the CPU
its Pallas kernels run in interpret mode.

Tolerance for whole granular renders: 3e-5 absolute with an error energy
at most 1e-9 of the signal's, the JAX suite's own bound between its read
modes (tests/test_grain_read.py:370-381): XLA may contract a lerp's
product and sum, or the envelope multiply and the lane sum, into FMAs,
which the port never does, and the ulps add up over the lanes of a
sample.  A wrong grain would be off by ~0.1.
"""

import numpy as np
import pytest

import webaudio_tpu as wa
import webaudio_tpu_torch as wt
from webaudio_tpu.graph import compiler as jcomp
from webaudio_tpu.graph import fusion as jfusion
from webaudio_tpu.parallel.batch import MixedGraphBatch as JMixedGraphBatch
from webaudio_tpu_torch.graph import compiler as tcomp
from webaudio_tpu_torch.graph import fusion as tfusion
from webaudio_tpu_torch.ops import grain_read as tgr

FS = 44100.0


def _context(mod, channels, seconds):
    if mod is wt:
        return wt.OfflineAudioContext(channels, int(FS * seconds), FS,
                                      device="cpu")
    return wa.OfflineAudioContext(channels, int(FS * seconds), FS)


def _noise(channels=2, length=30000, seed=11):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((channels, length)) * 0.4).astype(np.float32)


def grains(mod, n=40, seconds=0.8, channels=2, gain=True, edge=False,
           seed=3, rates=(0.9, 0.2), ramp=0.4, offsets=None, length=30000):
    """tests/test_grain_read.py's grain cloud: n grains of 90 ms with
    linear attack/release envelopes (or none) at rates from `rates`;
    with `edge`, every 5th grain starts 50 ms before the buffer's end, so
    its playhead crosses L."""
    ctx = _context(mod, 2, seconds)
    data = _noise(channels, length)
    buf = mod.AudioBuffer.from_array(data, FS)
    L = data.shape[1]
    rs = np.random.RandomState(seed)
    for i in range(n):
        when = i * (seconds - 0.2) / n
        src = ctx.create_buffer_source(
            playback_rate=float(rates[0] + rates[1] * rs.rand()))
        src.buffer = buf
        if gain:
            g = ctx.create_gain(gain=0.0)
            g.gain.set_value_at_time(0.0, when)
            g.gain.linear_ramp_to_value_at_time(ramp, when + 0.045)
            g.gain.linear_ramp_to_value_at_time(0.0, when + 0.09)
            src.connect(g)
            g.connect(ctx.destination)
        else:
            src.connect(ctx.destination)
        if offsets is not None:
            off = offsets[i]
        elif edge and i % 5 == 0:
            off = L / FS - 0.05
        else:
            off = 0.1 + i * 0.002
        src.start(when, off, 0.09)
    return ctx


def overlapping(mod, n=32):
    """tests/test_torch_render.py's bank: 32 sources of a 64-sample buffer
    starting one frame apart, all overlapping, so the lanes would not pay
    (K * 4 > V) and the bank renders as one (V, B) closed-form playhead."""
    ctx = _context(mod, 1, 1024 / FS)
    data = np.linspace(-1.0, 1.0, 64, dtype=np.float32)[None]
    buf = mod.AudioBuffer.from_array(data, FS)
    for i in range(n):
        s = ctx.create_buffer_source(playback_rate=0.75 + 0.01 * i)
        s.buffer = buf
        g = ctx.create_gain(gain=0.5 + 0.01 * i)
        s.connect(g)
        g.connect(ctx.destination)
        s.start(i / FS)
    return ctx


def _plan(comp, ctx, **kw):
    return comp.compile_graph(dict(ctx._nodes), list(ctx._edges),
                              ctx.sample_rate, ctx.length,
                              ctx._destination.node_id, **kw)


def _fused(cg):
    return [k for k in cg.kernels.values()
            if type(k).__name__ == "_FusedVoicesKernel"]


def _assert_render_close(got, want):
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert np.abs(want).max() > 0.01
    np.testing.assert_allclose(got, want, rtol=0.0, atol=3e-5)
    num = float(np.sum((got.astype(np.float64) - want) ** 2))
    assert num <= 1e-9 * float(np.sum(want.astype(np.float64) ** 2))


def _render_both(monkeypatch, build, port_mode=None, **kw):
    """Render build(wt) with WEBAUDIO_GRAIN_READ=port_mode (unset: auto)
    and build(wa) with the mode the port resolved; return (got, want, the
    port's fused kernel or None)."""
    if port_mode is None:
        monkeypatch.delenv("WEBAUDIO_GRAIN_READ", raising=False)
    else:
        monkeypatch.setenv("WEBAUDIO_GRAIN_READ", port_mode)
    tcg = _plan(tcomp, build(wt, **kw), device="cpu")
    fused = _fused(tcg)
    got = build(wt, **kw).start_rendering_sync().to_array()
    if fused:
        monkeypatch.setenv("WEBAUDIO_GRAIN_READ", fused[0].read_mode)
    jcg = _plan(jcomp, build(wa, **kw))
    assert tcg.block_frames == jcg.block_frames
    assert tcg.order == jcg.order
    assert tcg.dense_params == jcg.dense_params
    # a (V, B) bank has no read mode in the JAX package: it gathers
    assert [k.read_mode for k in fused] == \
        [getattr(k, "read_mode", "gather") for k in _fused(jcg)]
    want = build(wa, **kw).start_rendering_sync().to_array()
    return got, want, (fused[0] if fused else None)


def test_lane_plan_matches_jax():
    tnode = tfusion._plan_grain_lanes
    jnode = jfusion._plan_grain_lanes
    for kw in ({}, {"edge": True}, {"n": 48, "seconds": 1.0, "seed": 5}):
        ts = [n for n in grains(wt, **kw)._nodes.values()
              if type(n).__name__ == "AudioBufferSourceNode"]
        js = [n for n in grains(wa, **kw)._nodes.values()
              if type(n).__name__ == "AudioBufferSourceNode"]
        tp, jp = tnode(ts, FS), jnode(js, FS)
        assert tp.use_lanes and jp.use_lanes and jp.aligned
        assert tp.K == jp.K and tp.lanes == jp.lanes
        for name in ("lane_start", "lane_end", "lane_voice", "dur_end",
                     "offset_pos", "starts", "stops", "rates", "ends"):
            np.testing.assert_array_equal(getattr(tp, name),
                                          getattr(jp, name), err_msg=name)


def test_full_width_lane_plan_matches_jax():
    """benches/suite.py::case_granular_grains at full width (10 s,
    44.1 kHz, the suite's synthetic 2 s stereo buffer), planned only: the
    lane packing and the geometry the kernels run at."""
    def sources(mod, n):
        ctx = _context(mod, 2, 10.0)
        sample = mod.AudioBuffer.from_array(
            np.sin(np.arange(2 * 44100) * 0.05, dtype=np.float32)[None]
            .repeat(2, 0), FS)
        rng = np.random.RandomState(1)
        out = []
        for i in range(n):
            when = i * (10.0 - 0.2) / n
            offset = 0.3 + 2.0 * (i / n) + rng.rand() * 0.05
            src = ctx.create_buffer_source(
                playback_rate=float(0.9 + 0.2 * rng.rand()))
            src.buffer = sample
            src.start(when, float(offset), 0.09)
            out.append(src)
        return out

    for n, K, G in ((400, 5, 149), (800, 9, 219)):
        tp = tfusion._plan_grain_lanes(sources(wt, n), FS)
        jp = jfusion._plan_grain_lanes(sources(wa, n), FS)
        assert (tp.K, tp.lane_start.shape[1]) == (jp.K, jp.lane_start.shape[1]) \
            == (K, G)
        np.testing.assert_array_equal(tp.lane_start, jp.lane_start)
        np.testing.assert_array_equal(tp.lane_voice, jp.lane_voice)
        rmax = float(np.max(np.abs(tp.rates)))
        assert tgr.pick_group(rmax, 2, 88200, 441088, wide=True) == (32, 39)
        assert tgr.pick_group(rmax, 2, 88200, 441088) == (16, 21)
        assert tgr.pick_window(rmax, 441088) == (128, 192)


@pytest.mark.parametrize("mode", ("auto", "fused"))
def test_fused_render_matches_jax(monkeypatch, mode):
    """K2's path, with grains that run past the buffer end and grains
    masked before their start."""
    got, want, k = _render_both(
        monkeypatch, grains, None if mode == "auto" else mode, edge=True)
    assert k.read_mode == "fused" and (k.win_Qs, k.win_W) == (32, 39)
    _assert_render_close(got, want)


@pytest.mark.parametrize("kw", [{"gain": False}, {"channels": 3}],
                         ids=["no-gain-stage", "three-channels"])
def test_grouped_v_render_matches_jax(monkeypatch, kw):
    """Banks K2 does not take (no envelope stage; more than 2 channels)
    resolve to the grouped two-tap lerp (K3) under auto."""
    got, want, k = _render_both(monkeypatch, grains, edge=True, **kw)
    assert k.read_mode == "grouped_v" and (k.win_Qs, k.win_W) == (16, 21)
    _assert_render_close(got, want)


@pytest.mark.parametrize("mode,geometry", [("window", (128, 192)),
                                           ("grouped_pl", (16, 21)),
                                           ("grouped_t", (16, 21)),
                                           ("gather", (0, 0))])
def test_forced_read_modes_match_jax(monkeypatch, mode, geometry):
    got, want, k = _render_both(monkeypatch, grains, mode, edge=True)
    assert k.read_mode == mode and (k.win_Qs, k.win_W) == geometry
    _assert_render_close(got, want)


def test_forced_modes_fall_back_as_jax():
    """grouped_pl takes at most 2 channels and fused needs per-lane
    envelopes: the JAX package falls back to grouped_t for both, and so
    does the port (its K3 route)."""
    import os

    for mode, kw in (("grouped_pl", {"channels": 3}),
                     ("fused", {"gain": False})):
        os.environ["WEBAUDIO_GRAIN_READ"] = mode
        try:
            tk = _fused(_plan(tcomp, grains(wt, **kw), device="cpu"))[0]
            jk = _fused(_plan(jcomp, grains(wa, **kw)))[0]
        finally:
            os.environ.pop("WEBAUDIO_GRAIN_READ")
        assert tk.read_mode == jk.read_mode == "grouped_t"


@pytest.mark.parametrize("kw,mode", [
    ({}, "fused"), ({"gain": False}, "grouped_v"),
    ({"channels": 3}, "grouped_v"),
    ({"rates": (4.0, 1.0), "length": 90000}, "gather")],
    ids=["envelopes", "no-gain", "3ch", "rates-4-5"])
def test_auto_resolves_by_the_jax_tpu_rule(monkeypatch, kw, mode):
    """`auto` resolves as the JAX package does on a TPU whose probes pass:
    fused, else grouped_v when a narrow group fits, else gather.  Rates
    in (3.6, 5.6] fit only the wide group, and the JAX rule then gathers
    even with envelopes."""
    from webaudio_tpu.ops import grain_read as jgr

    monkeypatch.delenv("WEBAUDIO_GRAIN_READ", raising=False)
    monkeypatch.setattr(jgr, "grain_fused_supported", lambda: True)
    monkeypatch.setattr(jgr, "grouped_v_supported", lambda: True)
    tk = _fused(_plan(tcomp, grains(wt, **kw), device="cpu"))[0]
    jk = _fused(_plan(jcomp, grains(wa, **kw)))[0]
    assert tk.use_lanes
    assert (tk.read_mode, tk.win_Qs, tk.win_W) == \
        (jk.read_mode, jk.win_Qs, jk.win_W)
    assert tk.read_mode == mode


def test_dense_bank_matches_jax(monkeypatch):
    """All grains overlap: K * 4 > V, so the bank renders as one (V, B)
    closed-form playhead with per-voice gains."""
    got, want, k = _render_both(monkeypatch, lambda mod: overlapping(mod))
    assert not k.use_lanes
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_bank_below_threshold_stays_unfused(monkeypatch):
    got, want, k = _render_both(monkeypatch, grains, n=20, seconds=0.5)
    assert k is None
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("mode", ("auto", "grouped_v", "window", "gather"))
@pytest.mark.parametrize("kw", [{"edge": True}, {"gain": False}],
                         ids=["envelopes", "no-gain"])
def test_fused_matches_unfused_on_the_port(monkeypatch, mode, kw):
    monkeypatch.setenv("WEBAUDIO_GRAIN_READ", mode)
    fused = grains(wt, **kw).start_rendering_sync().to_array()
    monkeypatch.setenv("WEBAUDIO_FUSE_THRESHOLD", "1000")
    ctx = grains(wt, **kw)
    assert not _fused(_plan(tcomp, ctx, device="cpu"))
    _assert_render_close(fused, ctx.start_rendering_sync().to_array())


def single_source(mod, loop, rate=0.73, channels=2, frames=20000,
                  offset=0.0):
    ctx = _context(mod, 2, frames / FS)
    src = ctx.create_buffer_source(playback_rate=rate, loop=loop)
    src.buffer = mod.AudioBuffer.from_array(_noise(channels, 5000, seed=4), FS)
    src.connect(ctx.destination)
    src.start(0.0, offset)
    return ctx


@pytest.mark.parametrize("mode", ("grouped", "grouped_v", "grouped_pl",
                                  "window"))
@pytest.mark.parametrize("loop", (True, False), ids=["whole-loop", "one-shot"])
def test_single_source_grouped_modes_match_gather(monkeypatch, mode, loop):
    """A single source forced to a grouped or window read (a whole-buffer
    loop wraps the group start mod L; a one-shot source runs past the
    buffer's end) equals its pair-gather render and the JAX package's
    render in the same mode."""
    offset = 0.0 if loop else 0.05
    monkeypatch.setenv("WEBAUDIO_GRAIN_READ", "gather")
    ref = single_source(wt, loop, offset=offset).start_rendering_sync() \
        .to_array()
    monkeypatch.setenv("WEBAUDIO_GRAIN_READ", mode)
    ctx = single_source(wt, loop, offset=offset)
    kern = [k for k in _plan(tcomp, ctx, device="cpu").kernels.values()
            if hasattr(k, "win_W")][0]
    assert kern.read_mode == mode and kern.win_W
    got = ctx.start_rendering_sync().to_array()
    peak = np.abs(ref).max()
    assert peak > 0.1
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * peak)
    want = single_source(wa, loop, offset=offset).start_rendering_sync() \
        .to_array()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * peak)


def test_single_source_auto_keeps_the_gathers(monkeypatch):
    monkeypatch.delenv("WEBAUDIO_GRAIN_READ", raising=False)
    cg = _plan(tcomp, single_source(wt, True), device="cpu")
    (kern,) = [k for k in cg.kernels.values() if hasattr(k, "win_W")]
    assert kern.read_mode == "gather" and not kern.win_W
    # grouped_pl takes at most 2 channels, as in the JAX package
    monkeypatch.setenv("WEBAUDIO_GRAIN_READ", "grouped_pl")
    cg = _plan(tcomp, single_source(wt, True, channels=3), device="cpu")
    (kern,) = [k for k in cg.kernels.values() if hasattr(k, "win_W")]
    assert kern.read_mode == "gather"


def test_suspend_halfway_equals_the_whole_render(monkeypatch):
    monkeypatch.delenv("WEBAUDIO_GRAIN_READ", raising=False)
    whole = grains(wt, edge=True).start_rendering_sync().to_array()
    ctx = grains(wt, edge=True)
    seen = []
    ctx.suspend_sync(0.4, lambda c: seen.append(c.current_time))
    got = ctx.start_rendering_sync().to_array()
    assert len(seen) == 1 and len(ctx.render_stats["segments"]) == 2
    np.testing.assert_allclose(got, whole, rtol=0,
                               atol=1e-6 * np.abs(whole).max())


def test_graph_batch_lanes_equal_the_context_render(monkeypatch):
    monkeypatch.delenv("WEBAUDIO_GRAIN_READ", raising=False)
    want = grains(wt, edge=True).start_rendering_sync().to_array()
    gb = wt.GraphBatch(grains(wt, edge=True), batch=3)
    assert _fused(gb.cg)[0].read_mode == "fused"
    out = gb.render().numpy()[:, :, :want.shape[1]]
    for lane in out:
        np.testing.assert_allclose(lane, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


def test_override_of_a_fused_envelope_raises():
    ctx = grains(wt)
    env = next(n for n in ctx._nodes.values()
               if type(n).__name__ == "GainNode")
    gb = wt.GraphBatch(ctx, batch=2)
    assert (env.node_id, "gain") in gb.cg.param_alias
    with pytest.raises(ValueError, match="grain bank"):
        gb.override_param(env, "gain", np.zeros((2, ctx.length), np.float32))


def test_mixed_batch_buckets_banks_that_differ_in_offsets(monkeypatch):
    """Three grain clouds that differ only in each grain's buffer offset
    share one plan: the offsets ride the staged resources, stacked per
    instance."""
    monkeypatch.delenv("WEBAUDIO_GRAIN_READ", raising=False)
    rng = np.random.default_rng(8)
    offs = [rng.uniform(0.05, 0.4, 40) for _ in range(3)]
    mb = wt.MixedGraphBatch([grains(wt, offsets=o) for o in offs])
    assert mb.num_buckets == 1
    outs = mb.render()
    for o, out in zip(offs, outs):
        want = grains(wt, offsets=o).start_rendering_sync().to_array()
        np.testing.assert_allclose(out, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


def test_lane_env_mixed_batch_and_override_error(monkeypatch):
    """The port's counterpart of tests/test_fusion.py:917, on a synthetic
    buffer: two grain clouds whose envelopes peak at 0.4 and 0.7 batch
    together, each output equals its own render and the JAX package's
    MixedGraphBatch, and a grain envelope refuses a batch override."""
    monkeypatch.setenv("WEBAUDIO_GRAIN_READ", "fused")
    kw = [dict(n=48, seconds=1.0, seed=3),
          dict(n=48, seconds=1.0, seed=3, ramp=0.7)]
    outs = wt.MixedGraphBatch([grains(wt, **k) for k in kw]).render()
    jouts = JMixedGraphBatch([grains(wa, **k) for k in kw]).render()
    for k, out, jout in zip(kw, outs, jouts):
        own = grains(wt, **k).start_rendering_sync().to_array()
        np.testing.assert_allclose(out, own, atol=2e-5)
        _assert_render_close(out, np.asarray(jout))

    ctx = grains(wt, n=48, seconds=1.0)
    env0 = next(n for n in ctx._nodes.values()
                if type(n).__name__ == "GainNode")
    gb = wt.GraphBatch(ctx, batch=2)
    with pytest.raises(ValueError, match="per-lane spliced"):
        gb.override_param(env0, "gain", np.zeros((2, ctx.length), np.float32))


def test_unfused_envelope_override_reaches_its_dense_row():
    """A dense (V, B) bank keeps per-voice envelope rows: override_param
    on a member's gain node lands on its fused row through param_alias."""
    ctx = overlapping(wt)
    env = [n for n in ctx._nodes.values()
           if type(n).__name__ == "GainNode"][3]
    env.gain.set_value_at_time(0.5, 0.0)
    env.gain.linear_ramp_to_value_at_time(0.9, 0.01)
    gb = wt.GraphBatch(ctx, batch=2)
    key = gb.cg.param_alias[(env.node_id, "gain")]
    assert key[1] == "v3.gain" and key in gb.cg.dense_params
    base = gb.render().numpy()
    gb.override_param(env, "gain", np.zeros((2, ctx.length), np.float32))
    muted = gb.render().numpy()
    assert np.abs(base - muted).max() > 0.01
    # muting voice 3 is the same as leaving it out
    ctx2 = overlapping(wt)
    src3 = [n for n in ctx2._nodes.values()
            if type(n).__name__ == "AudioBufferSourceNode"][3]
    src3.disconnect()
    np.testing.assert_allclose(
        muted[0, :, :ctx.length],
        wt.GraphBatch(ctx2, batch=1).render().numpy()[0, :, :ctx.length],
        rtol=0, atol=1e-5 * np.abs(muted).max())


@pytest.mark.parametrize("mode,build", [
    ("auto", "grains"), ("grouped_v", "grains"), ("gather", "grains"),
    ("auto", "dense")])
def test_mixed_batch_stacks_per_instance_buffers(monkeypatch, mode, build):
    """Banks that differ only in their buffer's samples share one plan:
    each instance reads its own buffer (stacked along the batch axis) in
    every read path, and equals its own render."""
    monkeypatch.setenv("WEBAUDIO_GRAIN_READ", mode)

    def make(seed):
        if build == "dense":
            ctx = overlapping(wt)
            data = np.random.default_rng(seed).uniform(
                -1, 1, (1, 64)).astype(np.float32)
        else:
            ctx = grains(wt)
            data = _noise(seed=seed)
        buf = next(n for n in ctx._nodes.values()
                   if type(n).__name__ == "AudioBufferSourceNode").buffer
        for c in range(data.shape[0]):
            buf.copy_to_channel(data[c], c)
        return ctx

    mb = wt.MixedGraphBatch([make(s) for s in (1, 2, 3)])
    assert mb.num_buckets == 1
    for s, out in zip((1, 2, 3), mb.render()):
        want = make(s).start_rendering_sync().to_array()
        np.testing.assert_allclose(out, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
