"""Oscillator and constant-source voice banks on the port
(webaudio_tpu_torch/graph/fusion.py, nodes/oscillator_bank.py) against the
JAX package, on the CPU.

The oscillator cases of tests/test_fusion.py and tests/test_oscillator_bank.py
as port-against-JAX parity: each graph is built by one function for both
packages, fused with the same WEBAUDIO_FUSE_THRESHOLD, and the port's render
is held to the JAX package's at the goldens' 1e-5 x peak (where a test
states another, it says why), its plan to the JAX plan (block size, node
order, dense rows, the fused aliases), and its fused render to its own
unfused one at the JAX suite's 2e-5 x peak (tests/test_fusion.py:64).
"""

import numpy as np
import pytest
import torch

import jax

import webaudio_tpu as wa
import webaudio_tpu_torch as wt
from webaudio_tpu.graph import compiler as jcomp
from webaudio_tpu.parallel.batch import GraphBatch as JGraphBatch
from webaudio_tpu_torch import convert
from webaudio_tpu_torch.graph import compiler as tcomp
from webaudio_tpu_torch.graph import fusion as tfusion

FS = 48000.0


def _context(mod, channels, length, fs=FS):
    if mod is wt:
        return wt.OfflineAudioContext(channels, length, fs, device="cpu")
    return wa.OfflineAudioContext(channels, length, fs)


def _args(ctx):
    return (dict(ctx._nodes), list(ctx._edges), ctx.sample_rate, ctx.length,
            ctx._destination.node_id)


def _plans(graph_fn, *args, **kw):
    jcg = jcomp.compile_graph(*_args(graph_fn(wa, *args, **kw)))
    tcg = tcomp.compile_graph(*_args(graph_fn(wt, *args, **kw)), "cpu")
    assert tcg.block_frames == jcg.block_frames
    assert tcg.order == jcg.order
    assert tcg.dense_params == jcg.dense_params
    assert tcg.param_alias == jcg.param_alias
    assert not tcg.failed and not jcg.failed
    return tcg


def _fused(cg):
    return [k for k in cg.kernels.values()
            if type(k).__name__ == "_FusedVoicesKernel"]


def _close(got, want, rel):
    assert got.shape == want.shape and np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    peak = max(float(np.abs(want).max()), 1e-9)
    assert err <= rel * peak, f"{err} > {rel} x {peak}"


def _render(mod, graph_fn, *args, **kw):
    return graph_fn(mod, *args, **kw).start_rendering_sync().to_array()


def _check(monkeypatch, graph_fn, threshold, *args, rel=1e-5, **kw):
    """Fused port vs fused JAX (rel x peak), fused port vs unfused port
    (2e-5 x peak, the JAX suite's bound, whatever rel is); returns the
    port's fused plan and render."""
    monkeypatch.setenv("WEBAUDIO_FUSE_THRESHOLD", str(threshold))
    cg = _plans(graph_fn, *args, **kw)
    got = _render(wt, graph_fn, *args, **kw)
    _close(got, _render(wa, graph_fn, *args, **kw), rel)
    monkeypatch.setenv("WEBAUDIO_FUSE_THRESHOLD", "0")
    _close(got, _render(wt, graph_fn, *args, **kw), 2e-5)
    return cg, got


# --- tests/test_fusion.py's graphs ------------------------------------------


def synth(mod, n_osc=48, seconds=0.25, dense_freq=False, typ="sawtooth",
          chain=True, fs=FS, seed=42):
    """tests/test_fusion.py::_build: detuned oscillators through ADSR-ish
    envelopes (or none) into a mix gain; every 7th voice stops early and
    every 3rd has a frequency ramp when `dense_freq`."""
    ctx = _context(mod, 2, int(fs * seconds), fs)
    rng = np.random.RandomState(seed)
    mix = ctx.create_gain(gain=1.0 / n_osc)
    mix.connect(ctx.destination)
    for i in range(n_osc):
        o = ctx.create_oscillator(type=typ,
                                  frequency=float(80 + rng.rand() * 2000),
                                  detune=float(rng.randn() * 15))
        if dense_freq and i % 3 == 0:
            o.frequency.linear_ramp_to_value_at_time(float(200 + i), 0.2)
        t0 = float(rng.rand() * 0.1)
        if chain:
            env = ctx.create_gain(gain=0.0)
            env.gain.set_value_at_time(0.0, t0)
            env.gain.linear_ramp_to_value_at_time(1.0, t0 + 0.02)
            env.gain.set_target_at_time(0.6, t0 + 0.02, 0.05)
            o.connect(env)
            env.connect(mix)
        else:
            o.connect(mix)
        o.start(t0)
        if i % 7 == 0:
            o.stop(t0 + 0.15)
    return ctx


@pytest.mark.parametrize("kw,rel", [
    (dict(), 1e-5),                           # const-freq chains (closed form)
    (dict(dense_freq=True), 2e-4),            # automated freqs (cumsum path)
    (dict(dense_freq=True, typ="triangle"), 1e-5),
    (dict(typ="square", chain=False), 1e-5),  # plain bank, no gain stage
    (dict(typ="sine"), 1e-5),
], ids=["closed-form", "dense-freq", "dense-freq-triangle", "plain-bank",
        "sine"])
def test_fused_matches_jax_and_unfused(monkeypatch, kw, rel):
    """Every bank holds to its own unfused render at 2e-5 x peak.  The
    dense-frequency sawtooth is held at 2e-4 x peak to the JAX render: in
    the cumsum path an automated voice's f32 frequency f * 2^(d/1200)
    comes from the framework's exp2 (XLA's exp(d ln 2) polynomial in the
    JAX package, torch's here), and a constant voice's from numpy on the
    host, as an unfused oscillator takes it (voice 40's is an ulp off
    torch's); an ulp moves the phase ~1e-6 cycles over the render, and the
    sawtooth's polyBLEP step (slope 2/incr at 80-2,080 Hz) turns that into
    1.1e-4 x peak at a few edges.  The same graph as a triangle, which has
    no step, agrees at 1e-5."""
    cg, _ = _check(monkeypatch, synth, 8, rel=rel, **kw)
    (fused,) = _fused(cg)
    assert fused.V == 48 and fused.all_const_freq == ("dense_freq" not in kw)
    assert len(cg.kernels) == 3           # dest + mix + fused bank
    assert len(cg.param_alias) == 48 * (3 if kw.get("chain", True) else 2)


def custom_and_constant(mod):
    """tests/test_fusion.py:188: custom PeriodicWave oscillators and
    constant sources through envelopes, two banks."""
    ctx = _context(mod, 1, 4096)
    mix = ctx.create_gain(gain=0.05)
    mix.connect(ctx.destination)
    rng = np.random.RandomState(5)
    for i in range(10):
        pw = ctx.create_periodic_wave(
            real=np.array([0, 1, 0.5 * (i + 1) / 10], np.float32),
            imag=np.array([0, 0.3, 0.1 * i], np.float32))
        o = ctx.create_oscillator(frequency=float(100 + 60 * i))
        o.set_periodic_wave(pw)
        o.connect(mix)
        o.start(float(rng.rand() * 0.01))
    for i in range(10):
        c = ctx.create_constant_source(offset=0.1 * (i + 1))
        env = ctx.create_gain(gain=0.0)
        env.gain.set_value_at_time(0.0, 0.0)
        env.gain.linear_ramp_to_value_at_time(0.02 * (i + 1), 0.05)
        c.connect(env)
        env.connect(mix)
        c.start(float(i) * 0.002)
        c.stop(0.06 + float(i) * 0.002)
    return ctx


def test_fused_custom_wave_and_constant_sources(monkeypatch):
    cg, _ = _check(monkeypatch, custom_and_constant, 8)
    assert len(cg.kernels) == 4          # dest + mix + 2 fused banks
    kinds = sorted(str(getattr(k, "kind", "")) for k in _fused(cg))
    assert kinds == ["OscillatorType.CUSTOM", "const_src"]


def subtractive(mod):
    """tests/test_fusion.py:421: osc -> biquad (constant) -> envelope."""
    ctx = _context(mod, 1, int(FS * 0.4))
    mix = ctx.create_gain(gain=1.0 / 12)
    mix.connect(ctx.destination)
    for i in range(12):
        o = ctx.create_oscillator(type="sawtooth",
                                  frequency=float(80 + 50 * i))
        f = ctx.create_biquad_filter(
            type=["lowpass", "bandpass", "highpass"][i % 3],
            frequency=float(400 + 200 * i), q=float(1 + i % 5))
        env = ctx.create_gain(gain=0.0)
        t0 = i * 0.02
        env.gain.set_value_at_time(0.0, t0)
        env.gain.linear_ramp_to_value_at_time(1.0, t0 + 0.03)
        o.connect(f)
        f.connect(env)
        env.connect(mix)
        o.start(t0)
    return ctx


def test_fused_subtractive_synth_chains(monkeypatch):
    cg, _ = _check(monkeypatch, subtractive, 8)
    (fused,) = _fused(cg)
    assert len(cg.kernels) == 3 and fused.has_filter


def panned(mod):
    """tests/test_fusion.py:492: osc -> gain -> constant stereo panner."""
    ctx = _context(mod, 2, 2048)
    rng = np.random.RandomState(4)
    for i in range(10):
        o = ctx.create_oscillator(frequency=float(220 + 30 * i))
        env = ctx.create_gain(gain=float(0.05 + 0.01 * i))
        p = ctx.create_stereo_panner(pan=float(-1 + 2 * i / 9))
        o.connect(env)
        env.connect(p)
        p.connect(ctx.destination)
        o.start(float(rng.rand() * 0.005))
    return ctx


def test_fused_panned_voice_spread(monkeypatch):
    cg, got = _check(monkeypatch, panned, 8)
    assert len(cg.kernels) == 2          # dest + fused spread bank
    assert float(np.abs(got[0] - got[1]).max()) > 0.01


def shaped(mod, oversample="none", n=8, curve_points=128):
    """tests/test_fusion.py:530: osc -> WaveShaper (a curve per voice) ->
    gain, into a mix."""
    ctx = _context(mod, 1, 2048)
    mix = ctx.create_gain(gain=0.1)
    mix.connect(ctx.destination)
    for i in range(n):
        o = ctx.create_oscillator(frequency=float(200 + 40 * i))
        ws = ctx.create_wave_shaper(oversample=oversample)
        drive = 1.0 + i
        ws.set_curve(np.tanh(np.linspace(-drive, drive, curve_points))
                     .astype(np.float32))
        g = ctx.create_gain(gain=0.2)
        o.connect(ws)
        ws.connect(g)
        g.connect(mix)
        o.start()
    return ctx


def test_fused_waveshaper_voices_launch_one_table_lookup(monkeypatch):
    from webaudio_tpu_torch.graph import fusion

    calls = []
    orig = fusion.curve_lookup

    def spy(curve, x):
        calls.append((tuple(curve.shape), tuple(x.shape)))
        return orig(curve, x)

    monkeypatch.setattr(fusion, "curve_lookup", spy)
    cg, _ = _check(monkeypatch, shaped, 4)
    assert len(cg.kernels) == 3          # dest + mix + fused bank
    # one table lookup a block: the (V, n) per-voice curves over (V, B)
    B = cg.block_frames
    assert calls and set(calls) == {((8, 128), (8, B))}


def test_oversampled_waveshaper_not_fused(monkeypatch):
    """An oversampled shaper stays out of the bank (the bank's shaper stage
    has no resamplers, as in JAX); the voices then render unfused, each
    through its own 4x shaper, and equal the JAX render."""
    from webaudio_tpu_torch.nodes.waveshaper import WaveShaperNode

    monkeypatch.setenv("WEBAUDIO_FUSE_THRESHOLD", "4")
    ctx = shaped(wt, oversample="4x", n=6, curve_points=64)
    nodes2, _, _ = tfusion.fuse_sources(dict(ctx._nodes), list(ctx._edges),
                                        ctx._destination.node_id, FS)
    shapers = [nid for nid, n in ctx._nodes.items()
               if isinstance(n, WaveShaperNode)]
    assert all(s in nodes2 for s in shapers)
    assert not any(type(n).__name__ == "_FusedVoicesNode"
                   for n in nodes2.values())
    _plans(shaped, oversample="4x", n=6, curve_points=64)
    _close(ctx.start_rendering_sync().to_array(),
           _render(wa, shaped, oversample="4x", n=6, curve_points=64), 1e-5)


def explicit_gain(mod):
    """tests/test_fusion.py:383: gains with an explicit channel count."""
    ctx = _context(mod, 2, 1024)
    for i in range(6):
        o = ctx.create_oscillator(frequency=200.0 + i)
        g = ctx.create_gain(gain=0.1)
        g.channel_count = 2
        g.channel_count_mode = "explicit"
        o.connect(g)
        g.connect(ctx.destination)
        o.start()
    return ctx


def explicit_panner(mod):
    """tests/test_fusion.py:636: panners with an explicit count of 2."""
    ctx = _context(mod, 2, 2048)
    for i in range(8):
        o = ctx.create_oscillator(frequency=float(200 + 25 * i))
        p = ctx.create_stereo_panner(pan=float(-1 + 2 * i / 7))
        p.channel_count = 2
        p.channel_count_mode = "explicit"
        o.connect(p)
        p.connect(ctx.destination)
        o.start()
    return ctx


@pytest.mark.parametrize("graph_fn,cls", [(explicit_gain, "GainNode"),
                                          (explicit_panner, "StereoPannerNode")])
def test_explicit_channel_stage_not_fused(monkeypatch, graph_fn, cls):
    cg, _ = _check(monkeypatch, graph_fn, 4)
    ctx = graph_fn(wt)
    kept = [nid for nid, n in ctx._nodes.items() if type(n).__name__ == cls]
    assert kept and all(k in cg.kernels for k in kept)


def soup(mod, seed):
    """tests/test_fusion.py:237: a random graph soup of oscillators and
    constant sources, chains sharing gains, fan-outs, filters, shaper ->
    panner chains and gains into a mix's gain param."""
    rng = np.random.RandomState(seed)
    ctx = _context(mod, 1, 2048)
    mixes = [ctx.create_gain(gain=0.1) for _ in range(3)]
    for m in mixes:
        m.connect(ctx.destination)
    for i in range(rng.randint(4, 14)):
        kind = rng.randint(0, 3)
        if kind == 0:
            o = ctx.create_oscillator(
                type=["sine", "square", "sawtooth"][rng.randint(3)],
                frequency=float(100 + rng.rand() * 1000))
        elif kind == 1:
            o = ctx.create_constant_source(offset=float(rng.randn()))
        else:
            o = ctx.create_oscillator(frequency=float(200 + i))
        shape = rng.randint(0, 6)
        if shape == 0:
            o.connect(mixes[rng.randint(3)])
        elif shape == 1:
            g = ctx.create_gain(gain=float(rng.rand()))
            if rng.rand() < 0.5:
                g.gain.linear_ramp_to_value_at_time(0.2, 0.04)
            o.connect(g)
            g.connect(mixes[rng.randint(3)])
        elif shape == 2:
            o.connect(mixes[0])
            o.connect(mixes[1])
        elif shape == 4:
            f = ctx.create_biquad_filter(
                frequency=float(300 + rng.rand() * 3000),
                q=float(0.5 + rng.rand() * 6))
            g = ctx.create_gain(gain=float(rng.rand()))
            o.connect(f)
            f.connect(g)
            g.connect(mixes[rng.randint(3)])
        elif shape == 5:
            ws = ctx.create_wave_shaper()
            ws.set_curve(np.tanh(np.linspace(
                -2, 2, [64, 256][rng.randint(2)])).astype(np.float32))
            p = ctx.create_stereo_panner(pan=float(rng.uniform(-1, 1)))
            o.connect(ws)
            ws.connect(p)
            p.connect(mixes[rng.randint(3)])
        else:
            g = ctx.create_gain(gain=0.2)
            o.connect(g)
            g.connect(mixes[2].params["gain"])
        t0 = float(rng.rand() * 0.01)
        o.start(t0)
        if rng.rand() < 0.3:
            o.stop(t0 + float(rng.rand() * 0.03))
    return ctx


@pytest.mark.parametrize("seed", range(10))
def test_fusion_random_topologies(monkeypatch, seed):
    """Fusion at threshold 2 never changes the output: the port's fused
    render within the JAX suite's 3e-5 x peak of its unfused render, and
    within 1e-5 x peak of the JAX package's fused render."""
    monkeypatch.setenv("WEBAUDIO_FUSE_THRESHOLD", "2")
    _plans(soup, seed)
    got = _render(wt, soup, seed)
    _close(got, _render(wa, soup, seed), 1e-5)
    monkeypatch.setenv("WEBAUDIO_FUSE_THRESHOLD", "0")
    _close(got, _render(wt, soup, seed), 3e-5)


def _enveloped(mod):
    """tests/test_fusion.py:84: 8 oscillators, each through a dense gain
    envelope, into a mix."""
    ctx = _context(mod, 1, 2048)
    mix = ctx.create_gain(gain=1.0)
    mix.connect(ctx.destination)
    envs = []
    for i in range(8):
        o = ctx.create_oscillator(frequency=440.0)
        env = ctx.create_gain(gain=0.0)
        env.gain.set_value_at_time(0.001 * (i + 1), 0.0)
        env.gain.linear_ramp_to_value_at_time(0.001 * (i + 1), 1.0)
        o.connect(env)
        env.connect(mix)
        o.start()
        envs.append(env)
    return ctx, envs


def test_graph_batch_override_param_through_fusion(monkeypatch):
    """override_param on a fused-away envelope gain reaches the bank's
    v{i}.gain row through cg.param_alias, as in the JAX package."""
    monkeypatch.setenv("WEBAUDIO_FUSE_THRESHOLD", "8")
    n, batch = 2048, 3
    outs = []
    for mod, gb_cls in ((wa, JGraphBatch), (wt, wt.GraphBatch)):
        ctx, envs = _enveloped(mod)
        gb = gb_cls(ctx, batch=batch)
        assert len(_fused(gb.cg)) == 1
        dense = np.zeros((batch, n), np.float32)
        dense[:] = np.arange(1, batch + 1, dtype=np.float32)[:, None]
        gb.override_param(envs[0], "gain", dense)
        for env in envs[1:]:
            gb.override_param(env, "gain", np.zeros((batch, n), np.float32))
        out = np.asarray(gb.render())[:, :, :n]
        for b in range(1, batch):
            np.testing.assert_allclose(out[b], out[0] * (b + 1), atol=1e-5)
        outs.append(out)
    _close(outs[1], outs[0], 1e-5)
    assert np.abs(outs[1][0]).max() > 0.5


# --- tests/test_oscillator_bank.py ------------------------------------------


def individual(mod, n=8192, freqs=(220.0, 331.0, 442.5)):
    ctx = _context(mod, 1, n)
    for f in freqs:
        o = ctx.create_oscillator(frequency=f)
        g = ctx.create_gain(gain=1.0 / 3)
        o.connect(g)
        g.connect(ctx.destination)
        o.start()
    return ctx


def bank(mod, n=8192, freqs=(220.0, 331.0, 442.5), **kw):
    ctx = _context(mod, 2 if kw.get("stereo") else 1, n)
    kw = {"volumes": 1.0 / 3, "attacks": 0.0, "sustains": 1.0} | kw
    ctx.create_oscillator_bank(frequencies=list(freqs), **kw).connect(
        ctx.destination)
    return ctx


def test_bank_matches_individual_oscillators():
    naive = _render(wt, individual)[0]
    fused = _render(wt, bank)[0]
    np.testing.assert_allclose(fused, naive, atol=2e-5)
    _close(fused, _render(wa, bank)[0], 1e-5)


def test_bank_adsr_and_stereo():
    kw = dict(freqs=[440.0], n=48000, starts=[0.1], stops=[0.5],
              attacks=0.05, decays=0.1, sustains=0.5, releases=0.05,
              stereo=True, pans=[-1.0], volumes=1.0)
    out = _render(wt, bank, **kw)
    _close(out, _render(wa, bank, **kw), 1e-5)
    l, r = out
    assert np.all(l[: int(0.1 * FS)] == 0.0)            # before start
    assert np.abs(l[int(0.44 * FS):int(0.5 * FS)]).max() == \
        pytest.approx(0.5, abs=0.03)                     # sustain level
    assert np.abs(l[int(0.9 * FS):]).max() < 1e-3        # released
    assert np.abs(r).max() < 1e-6                        # hard-left pan


@pytest.mark.parametrize("typ", ["sine", "sawtooth", "square", "triangle"])
def test_bank_types_match_jax(typ):
    rng = np.random.RandomState(9)
    v = 24
    kw = dict(freqs=80 + rng.rand(v) * 2000, n=24000, type=typ,
              starts=rng.rand(v) * 0.2, stops=rng.rand(v) * 0.2 + 0.3,
              attacks=0.02, decays=0.05, sustains=0.6, releases=0.03,
              volumes=1.0 / v, stereo=True, pans=rng.rand(v) * 2 - 1)
    _close(_render(wt, bank, **kw), _render(wa, bank, **kw), 1e-5)


# --- the plan, states and resources ------------------------------------------


def many_oscillators(mod, n_osc=500, seconds=10.0, envelopes=True):
    """benches/suite.py::case_many_oscillators (BASELINE config 2); without
    `envelopes` each voice's gain is a constant 0.6 instead (the same
    nodes and edges, so the same block plan, without dense rows)."""
    ctx = _context(mod, 2, int(FS * seconds))
    rng = np.random.RandomState(42)
    mix = ctx.create_gain(gain=1.0 / n_osc)
    mix.connect(ctx.destination)
    for _ in range(n_osc):
        o = ctx.create_oscillator(frequency=float(80 + rng.rand() * 2000),
                                  detune=float(rng.randn() * 15))
        env = ctx.create_gain(gain=0.0 if envelopes else 0.6)
        t0 = float(rng.rand() * 2.0)
        if envelopes:
            env.gain.set_value_at_time(0.0, t0)
            env.gain.linear_ramp_to_value_at_time(1.0, t0 + 0.05)
            env.gain.set_target_at_time(0.6, t0 + 0.05, 0.1)
            env.gain.set_target_at_time(0.0, t0 + 4.0, 0.3)
        o.connect(env)
        env.connect(mix)
        o.start(t0)
    return ctx


@pytest.mark.parametrize("seconds,envelopes,blocks", [(2.0, True, 6),
                                                      (10.0, False, 30)])
def test_500_voice_plan_matches_jax(seconds, envelopes, blocks):
    """Config 2's plan (no render) equals the JAX planner's:
    compile_weight 4 V = 2,000 caps a block at 130 quanta, so 2 s (750
    quanta) split into 6 blocks of 125 and 10 s (3,750) into 30, the plan
    chip_smoke.py's phase o asserts on the card.  The 10 s plan is taken
    without the envelopes' 500 dense rows of 480,000 frames, which do not
    move it."""
    cg = _plans(many_oscillators, seconds=seconds, envelopes=envelopes)
    (fused,) = _fused(cg)
    assert fused.V == 500 and fused.has_gain and fused.all_const_freq
    assert cg.block_frames == 16000
    assert tcomp._pad_len(cg.total_frames, cg.block_frames) \
        == blocks * cg.block_frames
    assert len(cg.dense_params) == (500 if envelopes else 0)
    np.testing.assert_array_equal(
        fused.computed_const,
        jcomp.compile_graph(*_args(many_oscillators(
            wa, seconds=seconds, envelopes=envelopes)))
        .kernels[min(cg.kernels)].computed_const)


def resumable(mod, length):
    """Subtractive chains (a filter stage with FDL state) whose voices'
    frequencies ramp (the cumsum path's f64 phase carry)."""
    ctx = _context(mod, 1, length)
    mix = ctx.create_gain(gain=1.0 / 9)
    mix.connect(ctx.destination)
    for i in range(9):
        o = ctx.create_oscillator(type="square", frequency=float(90 + 70 * i))
        o.frequency.linear_ramp_to_value_at_time(float(300 + 40 * i),
                                                 length / FS)
        f = ctx.create_biquad_filter(frequency=float(900 + 300 * i), q=2.0)
        o.connect(f)
        f.connect(mix)
        o.start(i * 0.003 + 0.4 / FS)
    return ctx


def test_port_resumes_a_jax_render_at_a_block_boundary(monkeypatch):
    """JAX renders the first segment and hands its states (the bank's f64
    `phase`, `fdl_spectra`, `fdl_tail`) to the port, which renders the
    second; the result matches the JAX render of both."""
    monkeypatch.setenv("WEBAUDIO_FUSE_THRESHOLD", "8")
    length, split = 32768, 16384
    jctx = resumable(wa, length)
    args = (dict(jctx._nodes), list(jctx._edges), FS)
    dest = jctx._destination.node_id
    jcg0 = jcomp.compile_graph(*args, split, dest)
    out0, jst = jcomp.render_compiled(jcg0, jctx._nodes, split)
    jcg1 = jcomp.compile_graph(*args, length - split, dest, start_frame=split)
    want1, _ = jcomp.render_compiled(jcg1, jctx._nodes, length - split,
                                     start_frame=split, init_states=jst)

    states = convert.states_from_jax(
        jax.tree_util.tree_map(np.asarray, jst), "cpu")
    tctx = resumable(wt, length)
    tcg1 = tcomp.compile_graph(dict(tctx._nodes), list(tctx._edges), FS,
                               length - split, tctx._destination.node_id,
                               "cpu", start_frame=split)
    (fid,) = [nid for nid, k in tcg1.kernels.items()
              if type(k).__name__ == "_FusedVoicesKernel"]
    st = states[tcomp._k(fid)]
    assert st["phase"].dtype == torch.float64 and st["phase"].shape == (9,)
    assert st["fdl_spectra"].dtype == torch.complex64
    zero = tcomp.zero_states(tcg1)[tcomp._k(fid)]
    assert {k: v.shape for k, v in zero.items()} == \
        {k: v.shape for k, v in st.items()}
    assert float(st["phase"].abs().max()) > 0.0
    got1, _ = tcomp.render_compiled(tcg1, length - split, start_frame=split,
                                    init_states=states)
    got1 = got1[:, :length - split].numpy()
    _close(got1, np.asarray(want1)[:, :length - split], 1e-5)


@pytest.mark.parametrize("graph_fn", [custom_and_constant, subtractive,
                                      panned, shaped])
def test_resources_convert_from_jax(monkeypatch, graph_fn):
    """The banks' staged resources (schedules, ratios, constants, the
    custom `tables`, IR spectra `h`, pan gains, `curves`) equal the JAX
    package's, dtypes included."""
    monkeypatch.setenv("WEBAUDIO_FUSE_THRESHOLD", "4")
    jcg = jcomp.compile_graph(*_args(graph_fn(wa)))
    tcg = tcomp.compile_graph(*_args(graph_fn(wt)), "cpu")
    jres = jax.tree_util.tree_map(np.asarray, jcomp.collect_resources(jcg))
    from_jax = convert.resources_from_jax(jres, "cpu")
    ours = convert.to_torch_tree(tcomp.collect_resources(tcg), "cpu")
    assert from_jax.keys() == ours.keys()
    for nk in ours:
        assert from_jax[nk].keys() == ours[nk].keys(), nk
        for name, t in ours[nk].items():
            assert from_jax[nk][name].dtype == t.dtype, name
            assert torch.equal(from_jax[nk][name], t), name


def test_mixed_batch_buckets_banks(monkeypatch):
    """Banks differing only in staged per-voice values (frequencies,
    schedules, pans) share a bucket; a different wave type or a value the
    kernel keeps (the bank's stereo switch) splits it.  Every output equals
    its own start_rendering_sync."""
    rng = np.random.RandomState(2)

    def one(typ="sine", stereo=True):
        v = 16
        return bank(wt, n=4096, freqs=80 + rng.rand(v) * 2000, type=typ,
                    starts=rng.rand(v) * 0.02, attacks=0.01, decays=0.02,
                    sustains=0.5, releases=0.01, stereo=stereo,
                    pans=rng.rand(v) * 2 - 1, volumes=1.0 / v)

    ctxs = [one(), one(), one("square"), one(stereo=False), one()]
    mb = wt.MixedGraphBatch(ctxs)
    assert mb.num_buckets == 3
    for got, ctx in zip(mb.render(), ctxs):
        want = ctx.start_rendering_sync().to_array()
        _close(got, want, 1e-6)

    # fused oscillator banks: per-voice frequencies and envelopes stack
    monkeypatch.setenv("WEBAUDIO_FUSE_THRESHOLD", "8")
    seeds = [synth(wt, n_osc=12, seconds=0.1, seed=s) for s in (1, 2)]
    other = synth(wt, n_osc=12, seconds=0.1, typ="square")
    mb = wt.MixedGraphBatch(seeds + [other])
    assert mb.num_buckets == 2
    for got, ctx in zip(mb.render(), seeds + [other]):
        _close(got, ctx.start_rendering_sync().to_array(), 1e-6)
