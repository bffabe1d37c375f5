"""Oscillators, sources and simple nodes on the port (webaudio_tpu_torch)
against the JAX package, on the CPU.

Inputs come from seeded numpy data and go through both packages.  The
tolerance is the goldens' 1e-5 x peak (tests/test_goldens.py) unless a test
states another: the phase accumulator is held tighter (its f32 prefix sums
run in XLA's order, so they agree to an ulp), the PeriodicWave table bit for
bit (both build it in numpy).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import webaudio_tpu as wa
import webaudio_tpu_torch as wt
from webaudio_tpu.graph import compiler as jcomp
from webaudio_tpu.ops import oscillator as josc
from webaudio_tpu_torch.graph import compiler as tcomp
from webaudio_tpu_torch.ops import oscillator as tosc

FS = 48000.0
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens.npz")
TYPES = ("sine", "square", "sawtooth", "triangle", "custom")


def _context(mod, channels, length, fs=FS):
    if mod is wt:
        return wt.OfflineAudioContext(channels, length, fs, device="cpu")
    return wa.OfflineAudioContext(channels, length, fs)


def _assert_close(got, want, rel=1e-5):
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want,
                               atol=rel * max(np.abs(want).max(), 1e-6))


def _render_both(graph_fn, *args, rel=1e-5, **kw):
    want = graph_fn(wa, *args, **kw).start_rendering_sync().to_array()
    got = graph_fn(wt, *args, **kw).start_rendering_sync().to_array()
    _assert_close(got, want, rel)
    return got, want


def _wrap_err(a, b):
    """Phase difference in cycles, modulo 1."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return np.minimum(d, 1.0 - d)


# --- ops/oscillator.py ------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_accumulate_phase_matches_jax(seed):
    """Random increments (negative ones included), masks, carries and start
    corrections over blocks of 1 and 40 quanta: the phases agree to an f32
    ulp of 1, the carries to f64 rounding."""
    import jax

    rng = np.random.RandomState(seed)
    V, B = 5, 128 * (1 if seed == 0 else 40)
    incr = rng.uniform(-0.02, 0.06, (V, B))
    mask = rng.rand(V, B) > 0.2
    mask[1, : B // 2] = False                    # a voice starting mid-block
    carry = rng.uniform(0.0, 1.0, V) * (seed + 1) * 37.0
    corr = rng.uniform(0.0, 0.05, V)
    pj, cj = jax.vmap(josc.accumulate_phase)(
        jnp.asarray(carry), jnp.asarray(incr), jnp.asarray(mask),
        jnp.asarray(corr))
    pt, ct = tosc.accumulate_phase(
        torch.from_numpy(carry), torch.from_numpy(incr),
        torch.from_numpy(mask), torch.from_numpy(corr))
    assert pt.dtype == torch.float32 and ct.dtype == torch.float64
    assert _wrap_err(pj, pt.numpy()).max() <= 1.2e-7
    assert _wrap_err(cj, ct.numpy()).max() <= 1e-12


def test_cumsum_f32_is_xlas_order():
    rng = np.random.RandomState(7)
    x = rng.uniform(0.0, 0.05, (64, 3, 128)).astype(np.float32)
    want = np.asarray(jnp.cumsum(jnp.asarray(x), axis=-1))
    np.testing.assert_array_equal(tosc.cumsum_f32(torch.from_numpy(x)).numpy(),
                                  want)


@pytest.mark.parametrize("kind", TYPES)
def test_waveforms_match_jax(kind):
    rng = np.random.RandomState(3)
    phase = rng.uniform(0.0, 1.0, (4, 4096)).astype(np.float32)
    phase[:, :4] = [0.0, 0.5, np.float32(1.0 - 2**-24), 0.25]
    incr = rng.uniform(1e-4, 0.3, (4, 1)).astype(np.float32)
    table = wa.OfflineAudioContext(1, 128, FS).create_periodic_wave(
        real=rng.randn(9), imag=rng.randn(9)).as_array()
    jfn = {"sine": lambda: josc.sine(phase),
           "square": lambda: josc.square(phase, incr),
           "sawtooth": lambda: josc.sawtooth(phase, incr),
           "triangle": lambda: josc.triangle(phase),
           "custom": lambda: josc.wavetable_lookup(phase[0], table)}[kind]
    from webaudio_tpu_torch.nodes.oscillator import OscillatorType, waveform

    got = waveform(OscillatorType(kind), torch.from_numpy(phase),
                   torch.from_numpy(incr), torch.from_numpy(table)[None])
    want = np.asarray(jfn())
    got = got.numpy()[0] if kind == "custom" else got.numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_periodic_wave_table_is_jax_bit_for_bit():
    rng = np.random.RandomState(11)
    for kw in (dict(), dict(real=rng.randn(5)), dict(imag=rng.randn(33)),
               dict(real=rng.randn(16), imag=rng.randn(16)),
               dict(real=rng.randn(4), imag=rng.randn(4),
                    disable_normalization=True)):
        want = _context(wa, 1, 128).create_periodic_wave(**kw).as_array()
        got = _context(wt, 1, 128).create_periodic_wave(**kw).as_array()
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


# --- whole renders ----------------------------------------------------------


def oscillator(mod, kind, automation, start=0.0, stop=None, length=6000,
               freq=440.0, fs=FS):
    """One oscillator into the destination: a constant frequency, or one
    whose frequency or detune ramps, starting `start` s in."""
    ctx = _context(mod, 1, length, fs)
    o = ctx.create_oscillator(type="sine" if kind == "custom" else kind,
                              frequency=freq, detune=7.0)
    if kind == "custom":
        rng = np.random.RandomState(5)
        o.set_periodic_wave(ctx.create_periodic_wave(
            real=rng.randn(6), imag=rng.randn(6)))
    if automation == "frequency":
        o.frequency.set_value_at_time(freq, 0.01)
        o.frequency.exponential_ramp_to_value_at_time(freq * 5.3, 0.1)
    elif automation == "detune":
        o.detune.linear_ramp_to_value_at_time(-1900.0, 0.12)
    o.connect(ctx.destination)
    o.start(start)
    if stop is not None:
        o.stop(stop)
    return ctx


@pytest.mark.parametrize("automation", ["constant", "frequency", "detune"])
@pytest.mark.parametrize("kind", TYPES)
def test_oscillator_matches_jax(kind, automation):
    """Every type with a constant, ramped-frequency or ramped-detune
    frequency, a sub-sample start and stop.  Tolerance 1e-4 x peak for the
    ramped detune of the square and the sawtooth: the per-sample
    frequency f * 2^(d/1200) takes XLA's exp2 (its exp(d ln 2) polynomial)
    in the JAX package and torch's here, one f32 ulp apart for ~0.4% of
    detunes; the phase drifts by that ulp's share of the cycles run, and
    the polyBLEP step (slope 2/incr) turns the drift into up to 6e-5."""
    edge = automation == "detune" and kind in ("square", "sawtooth")
    _render_both(oscillator, kind, automation, start=0.0011 + 1.3 / FS,
                 stop=0.1 + 0.4 / FS, rel=1e-4 if edge else 1e-5)


def suspended_oscillator(mod, kind, freq):
    """oscillator(..., "frequency") over 1.5 s with a suspend at 0.5 s: the
    cumsum path's f64 carry crosses the segment boundary."""
    ctx = oscillator(mod, kind, "frequency", start=0.3 / FS, length=72000,
                     freq=freq)
    ctx.suspend_sync(0.5, lambda c: None)
    return ctx


@pytest.mark.parametrize("kind", ["sine", "sawtooth", "custom"])
def test_oscillator_across_segments_and_above_nyquist(kind):
    """A frequency ramp past Nyquist mutes the voice while the phase runs
    on; a constant frequency at Nyquist is silent throughout."""
    got, _ = _render_both(suspended_oscillator, kind, 2000.0)
    assert np.abs(got[0, 24000:24100]).max() > 0.5     # heard after the suspend
    muted, _ = _render_both(oscillator, kind, "frequency", freq=5000.0)
    assert np.abs(muted[0, 4900:]).max() == 0.0        # 26.5 kHz: muted
    assert np.abs(muted[0, :1000]).max() > 0.5
    silent, _ = _render_both(oscillator, kind, "constant", freq=-24000.0)
    assert not silent.any()


def _args(ctx):
    return (dict(ctx._nodes), list(ctx._edges), ctx.sample_rate, ctx.length,
            ctx._destination.node_id, "cpu")


def constant_source(mod):
    """A constant source with an automated offset, started and stopped
    off the sample grid, and a plain one into a second channel."""
    ctx = _context(mod, 2, 4096)
    merger = ctx.create_channel_merger(2)
    c = ctx.create_constant_source(offset=0.25)
    c.offset.linear_ramp_to_value_at_time(-0.75, 0.05)
    c.connect(merger, 0, 0)
    c.start(0.0013)
    c.stop(0.07 + 0.3 / FS)
    d = ctx.create_constant_source()
    d.connect(merger, 0, 1)
    d.start(512 / FS)
    merger.connect(ctx.destination)
    return ctx


def stereo_panner(mod, stereo_input, automated):
    """A sine (or a stereo pair of a sine and a square through a merger)
    into a panner whose pan is constant or sweeps -1 -> 1."""
    ctx = _context(mod, 2, 4096)
    pan = ctx.create_stereo_panner(pan=-0.3)
    if automated:
        pan.pan.set_value_at_time(-1.0, 0.0)
        pan.pan.linear_ramp_to_value_at_time(1.0, 4096 / FS)
    a = ctx.create_oscillator(frequency=330.0)
    a.start()
    if stereo_input:
        b = ctx.create_oscillator(type="square", frequency=97.0)
        b.start()
        m = ctx.create_channel_merger(2)
        a.connect(m, 0, 0)
        b.connect(m, 0, 1)
        m.connect(pan)
    else:
        a.connect(pan)
    pan.connect(ctx.destination)
    return ctx


def splitter(mod):
    """A stereo pair split, its channels swapped and the left halved."""
    ctx = _context(mod, 2, 4096)
    m = ctx.create_channel_merger(2)
    a = ctx.create_oscillator(frequency=330.0)
    b = ctx.create_oscillator(type="triangle", frequency=97.0)
    a.connect(m, 0, 0)
    b.connect(m, 0, 1)
    s = ctx.create_channel_splitter(3)
    m.connect(s)
    out = ctx.create_channel_merger(2)
    half = ctx.create_gain(gain=0.5)
    s.connect(half, 1)
    half.connect(out, 0, 0)
    s.connect(out, 0, 1)
    s.connect(out, 2, 1)                  # the silent third output
    out.connect(ctx.destination)
    a.start()
    b.start(0.01)
    return ctx


def lfo(mod):
    """An LFO (sine, 5 Hz, depth 0.4) into a carrier gain's a-rate gain."""
    ctx = _context(mod, 1, 12000)
    carrier = ctx.create_oscillator(type="sawtooth", frequency=220.0)
    amp = ctx.create_gain(gain=0.5)
    lfo_osc = ctx.create_oscillator(frequency=5.0)
    depth = ctx.create_gain(gain=0.4)
    lfo_osc.connect(depth)
    depth.connect(amp.gain)
    carrier.connect(amp)
    amp.connect(ctx.destination)
    carrier.start()
    lfo_osc.start(0.01)
    return ctx


def test_constant_source_matches_jax():
    got, _ = _render_both(constant_source)
    assert got[1, 511] == 0.0 and got[1, 512] == 1.0


@pytest.mark.parametrize("stereo_input", [False, True])
@pytest.mark.parametrize("automated", [False, True])
def test_stereo_panner_matches_jax(stereo_input, automated):
    got, _ = _render_both(stereo_panner, stereo_input, automated)
    assert np.abs(got[0] - got[1]).max() > 0.1


def test_splitter_and_merger_match_jax():
    got, _ = _render_both(splitter)
    assert np.abs(got).min(axis=1).max() < 1e-3 and np.abs(got).max() > 0.4


def test_lfo_into_gain_matches_jax():
    _render_both(lfo)


def _golden_cases(mod):
    """tests/test_goldens.py's `square_osc` and `env_pan` graphs."""
    ctx = _context(mod, 1, 2048)
    osc = ctx.create_oscillator(type="square", frequency=441.0)
    osc.connect(ctx.destination)
    osc.start(0.5 / FS)
    cases = {"square_osc": ctx}
    ctx = _context(mod, 2, 2048)
    src = ctx.create_constant_source(offset=1.0)
    g = ctx.create_gain()
    g.gain.set_value_at_time(0.0, 0.0)
    g.gain.set_target_at_time(1.0, 256 / FS, 0.005)
    pan = ctx.create_stereo_panner()
    pan.pan.linear_ramp_to_value_at_time(1.0, 2048 / FS)
    src.connect(g)
    g.connect(pan)
    pan.connect(ctx.destination)
    src.start()
    cases["env_pan"] = ctx
    return cases


@pytest.mark.skipif(not os.path.exists(GOLDENS), reason="no golden fixtures")
@pytest.mark.parametrize("name", ["square_osc", "env_pan"])
def test_goldens(name):
    with np.load(GOLDENS) as z:
        ref = z[name]
    got = _golden_cases(wt)[name].start_rendering_sync().to_array()
    _assert_close(got, ref)


def test_disable_polyblep_switch(monkeypatch):
    """The reference's cfg!(test) switch: with polyBLEP off the square is
    exactly +-1, as in the JAX package."""
    monkeypatch.setattr(tosc, "DISABLE_POLYBLEP", True)
    monkeypatch.setattr(josc, "DISABLE_POLYBLEP", True)
    got, _ = _render_both(oscillator, "square", "constant")
    assert set(np.unique(got)) <= {-1.0, 0.0, 1.0}


# --- the spec's errors ------------------------------------------------------


@pytest.mark.parametrize("mod", [wa, wt], ids=["jax", "torch"])
def test_spec_errors(mod):
    ctx = _context(mod, 2, 1024)
    o = ctx.create_oscillator()
    with pytest.raises(mod.InvalidStateError):
        o.set_type("custom")
    o.type = "square"
    assert o.type == "square"
    o.set_periodic_wave(ctx.create_periodic_wave())
    assert o.type == "custom"
    with pytest.raises(mod.InvalidStateError):
        o.type = "sine"
    with pytest.raises(ValueError):
        ctx.create_oscillator(type="noise")
    with pytest.raises(mod.IndexSizeError):
        ctx.create_periodic_wave(real=[0.0])
    with pytest.raises(mod.IndexSizeError):
        ctx.create_periodic_wave(real=[0.0, 1.0], imag=[0.0, 1.0, 2.0])
    with pytest.raises(mod.InvalidStateError):
        o.stop()                                       # before start
    o.start()
    with pytest.raises(mod.InvalidStateError):
        o.start()
    p = ctx.create_stereo_panner()
    with pytest.raises(mod.NotSupportedError):
        p.channel_count = 3
    with pytest.raises(mod.NotSupportedError):
        p.channel_count_mode = "max"
    s = ctx.create_channel_splitter(4)
    assert s.number_of_outputs == 4 and s.channel_count == 4
    for bad in (lambda: setattr(s, "channel_count", 2),
                lambda: setattr(s, "channel_count_mode", "max"),
                lambda: setattr(s, "channel_interpretation", "speakers")):
        with pytest.raises(mod.InvalidStateError):
            bad()
    m = ctx.create_channel_merger(3)
    assert m.number_of_inputs == 3
    with pytest.raises(mod.InvalidStateError):
        m.channel_count = 2
    with pytest.raises(mod.InvalidStateError):
        m.channel_count_mode = "clamped-max"
    with pytest.raises(mod.NotSupportedError):
        ctx.create_channel_merger(0)


def test_plans_match_jax():
    for ctx_fn in (lambda m: constant_source(m), lambda m: splitter(m),
                   lambda m: lfo(m),
                   lambda m: oscillator(m, "custom", "detune")):
        jctx, tctx = ctx_fn(wa), ctx_fn(wt)
        jcg = jcomp.compile_graph(*_args(jctx)[:-1])
        tcg = tcomp.compile_graph(*_args(tctx))
        assert tcg.block_frames == jcg.block_frames
        assert tcg.order == jcg.order
        assert tcg.dense_params == jcg.dense_params
        assert tcg.out_counts == jcg.out_counts


def test_package_root_exports():
    """PeriodicWave at the root, EventType and OscillatorBankNode lazily,
    as webaudio_tpu/__init__.py has them."""
    from webaudio_tpu_torch import EventType, OscillatorBankNode, PeriodicWave
    from webaudio_tpu_torch.events import EventType as E
    from webaudio_tpu_torch.nodes.oscillator_bank import OscillatorBankNode as O
    from webaudio_tpu_torch.periodic_wave import PeriodicWave as P

    assert (EventType, OscillatorBankNode, PeriodicWave) == (E, O, P)


def test_custom_periodic_wave():
    """tests/test_oscillator.py::test_custom_periodic_wave on the port: a
    pure second harmonic through the 8,192-entry table."""
    from webaudio_tpu_torch import PeriodicWave

    fs, n = 48000.0, 4800
    ctx = wt.OfflineAudioContext(1, n, fs, device="cpu")
    wave = ctx.create_periodic_wave(real=[0, 0, 0], imag=[0, 0, 1])
    assert isinstance(wave, PeriodicWave)
    osc = ctx.create_oscillator(periodic_wave=wave, frequency=100.0)
    osc.connect(ctx.destination)
    osc.start()
    out = ctx.start_rendering_sync().get_channel_data(0)
    phase = (100.0 / fs) * np.arange(n, dtype=np.float64) % 1.0
    expected = np.sin(2 * np.pi * 2 * phase)
    np.testing.assert_allclose(out, expected, atol=5e-3)
    assert osc.type.value == "custom"
