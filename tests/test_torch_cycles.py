"""Feedback cycles and the two-rate compiler on the port
(webaudio_tpu_torch) against the JAX package, on the CPU.

- The plan (block, inner sub-steps m, inner block, order with roles, cycle
  groups, muted nodes) equals `webaudio_tpu.graph.compiler.compile_graph`'s
  field for field, by default and under the switches both packages read
  (WEBAUDIO_CYCLE_BLOCKS, WEBAUDIO_TWO_RATE).
- Within the port, a two-rate render is bit-equal to the single-rate one
  (WEBAUDIO_TWO_RATE=0) and to one-quantum stepping
  (WEBAUDIO_CYCLE_BLOCKS=1), as in tests/test_two_rate.py; against JAX the
  bound is 1e-5 x peak (the goldens' rule).
- The reverb (a convolver plus a feedback delay, BASELINE config 3 with a
  synthetic dry buffer and IR) widens its blocks and holds to its single-
  rate render at 3e-6 (the convolver partition changes with the block).
- The random feedback networks of tests/test_graph_fuzz_cycles.py hold to
  its per-sample numpy oracle at 2e-4 x peak, and two-rate to flat bit for
  bit; the golden `modulated_feedback_delay` to tests/goldens.npz at
  1e-5 x peak.
- Batches: a lane equals its own render (1e-6 x peak), and a batch
  rendered twice gives the same output (the ring is written out of place).
- A JAX half-render's states (the delay's `ring`, the convolver's FDL
  `spectra` and `tail`) carried through `convert.py` and finished on the
  port match JAX's whole render at 1e-5 x peak.
"""

import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import webaudio_tpu as wa
import webaudio_tpu_torch as wt
from webaudio_tpu.graph import compiler as jcomp
from webaudio_tpu.graph import ir as jir
from webaudio_tpu.nodes.delay import DelayNode as JDelay
from webaudio_tpu_torch import convert
from webaudio_tpu_torch.graph import compiler as tcomp

from test_graph_fuzz_cycles import _oracle as fuzz_oracle
from test_graph_fuzz_cycles import _random_spec

FS = 48000.0
REVERB_FS = 44100.0
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens.npz")


def _context(mod, channels, length, fs=FS):
    if mod is wt:
        return wt.OfflineAudioContext(channels, length, fs, device="cpu")
    return wa.OfflineAudioContext(channels, length, fs)


def delay_net(mod, seconds=2.0, automate_fb=False, drive_delay=False,
              modulate=False, delay=0.2, frames=None):
    """tests/test_two_rate.py's delay network: a 330 Hz burst into a
    delay (0.2 s) with a 0.6 feedback gain."""
    ctx = _context(mod, 2, frames or int(FS * seconds))
    o = ctx.create_oscillator(frequency=330.0)
    o.start()
    o.stop(0.25)
    d = ctx.create_delay(max_delay_time=0.5)
    d.delay_time.value = delay
    if modulate:
        d.delay_time.set_value_at_time(0.05, 0.0)
        d.delay_time.linear_ramp_to_value_at_time(0.12, seconds)
    fb = ctx.create_gain(gain=0.6)
    if automate_fb:
        fb.gain.set_value_at_time(0.7, 0.0)
        fb.gain.linear_ramp_to_value_at_time(0.2, seconds)
    o.connect(d)
    d.connect(fb)
    fb.connect(d)
    fb.connect(ctx.destination)
    o.connect(ctx.destination)
    if drive_delay:
        lfo = ctx.create_constant_source(offset=0.01)
        lfo.start()
        lfo.connect(d.delay_time)
    return ctx


def synthetic_ir(fs, seconds, seed=3):
    """A stereo decaying-noise IR (the stand-in for the parking garage)."""
    rng = np.random.default_rng(seed)
    n = int(fs * seconds)
    t = np.arange(n) / fs
    return (rng.standard_normal((2, n)) * np.exp(-t / 0.4)).astype(np.float32)


def reverb(mod, seconds=1.0, ir_seconds=0.25, fs=REVERB_FS, frames=None):
    """benches/suite.py::case_convolution_reverb (BASELINE config 3) with
    bench.py's synthetic 2 s buffer for `sample.wav` and a synthetic IR for
    `parking-garage-response.wav`: a looping source into a convolver and a
    0.31 s delay with a 0.4 feedback gain."""
    ctx = _context(mod, 2, frames or int(fs * seconds), fs)
    dry = np.sin(np.arange(2 * int(fs)) * 0.03, dtype=np.float32)[None]
    src = ctx.create_buffer_source(loop=True)
    src.buffer = mod.AudioBuffer.from_array(dry.repeat(2, 0), fs)
    src.start()
    verb = ctx.create_convolver()
    verb.set_buffer(mod.AudioBuffer.from_array(synthetic_ir(fs, ir_seconds),
                                               fs))
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


def golden_feedback(mod, length=2048):
    """tests/test_goldens.py's `modulated_feedback_delay`: an impulse into
    a delay swept from 10.5 to 40.25 frames, fed back through 0.6."""
    ctx = _context(mod, 1, length)
    imp = ctx.create_buffer(1, 8, FS)
    imp.copy_to_channel(np.array([1, 0, 0, 0, 0, 0, 0, 0], np.float32), 0)
    s = ctx.create_buffer_source()
    s.buffer = imp
    d = ctx.create_delay(max_delay_time=0.01)
    d.delay_time.set_value_at_time(10.5 / FS, 0.0)
    d.delay_time.linear_ramp_to_value_at_time(40.25 / FS, length / FS)
    fb = ctx.create_gain(gain=0.6)
    s.connect(d)
    d.connect(fb)
    fb.connect(d)
    d.connect(ctx.destination)
    s.start()
    return ctx


def _plan(comp, ctx):
    args = (dict(ctx._nodes), list(ctx._edges), ctx.sample_rate, ctx.length,
            ctx._destination.node_id)
    return comp.compile_graph(*args, "cpu") if comp is tcomp \
        else comp.compile_graph(*args)


def _jax_groups(ctx):
    ids = {nid for nid, n in ctx._nodes.items() if isinstance(n, JDelay)}
    return jir.order_graph(list(ctx._nodes), list(ctx._edges), ids)


def _close(got, want, rel):
    assert got.shape == want.shape and np.isfinite(got).all()
    peak = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * peak)


PLANS = {
    # name: (graph function, kwargs, (block, m, inner) the JAX planner picks)
    "delay_net": (delay_net, {}, (96000, 15, 6400)),
    "reverb": (reverb, {}, (45056, 4, 11264)),
    "audio_driven_delay": (delay_net, {"drive_delay": True}, (128, 1, 0)),
    "modulated_delay": (delay_net, {"modulate": True}, (128, 1, 0)),
    "delay_net_10s": (delay_net, {"seconds": 10.0}, None),
    "reverb_2s": (reverb, {"seconds": 2.0, "ir_seconds": 2.0},
                  (90112, 8, 11264)),
}
SWITCHES = [
    {},
    {"WEBAUDIO_TWO_RATE": "0"},
    {"WEBAUDIO_CYCLE_BLOCKS": "1"},
]


@pytest.mark.parametrize("switch", SWITCHES,
                         ids=lambda s: ",".join(f"{k}={v}" for k, v in
                                                s.items()) or "default")
@pytest.mark.parametrize("name", list(PLANS))
def test_plan_equals_jax(monkeypatch, name, switch):
    for k, v in switch.items():
        monkeypatch.setenv(k, v)
    build, kw, expect = PLANS[name]
    jctx, tctx = build(wa, **kw), build(wt, **kw)
    jcg, tcg = _plan(jcomp, jctx), _plan(tcomp, tctx)
    got = (tcg.block_frames, tcg.two_rate_m, tcg.inner_frames)
    assert got == (jcg.block_frames, jcg.two_rate_m, jcg.inner_frames)
    if not switch and expect is not None:
        assert got == expect
    if switch.get("WEBAUDIO_CYCLE_BLOCKS") == "1":
        assert got == (128, 1, 0)
    assert tcg.order == jcg.order
    assert tcg.muted == jcg.muted
    assert tcg.cycle_groups == _jax_groups(jctx).cycle_groups
    assert tcg.dense_params == jcg.dense_params
    for nid, k in tcg.kernels.items():
        jk = jcg.kernels[nid]
        for attr in ("R", "in_cycle", "partition", "k", "n_conv"):
            if hasattr(jk, attr):
                assert getattr(k, attr) == getattr(jk, attr), (nid, attr)
    assert not tcg.failed and not jcg.failed


CHOOSER_CASES = [
    # (cycle-delay bound in quanta, total quanta, weights, FFT kernels)
    (49, 750, (1, 1, 1), False),
    (49, 750, (1, 8, 1), True),
    (88, 3446, (1, 1, 1, 4), True),
    (88, 704, (1, 1, 1, 4), True),
    (1, 750, (1, 1), False),
    (2, 7, (1, 1), False),
    (500, 3446, (64, 64), True),
    (37, 1201, (2, 3), False),
]


@pytest.mark.parametrize("bound,total,weights,fft", CHOOSER_CASES)
def test_cycle_block_choosers_equal_jax(monkeypatch, bound, total, weights,
                                        fft):
    """The cyclic block choosers (`_cycle_safe_qpb`, `_two_rate_plan`)
    pick the JAX package's blocks for a given delay bound, render length
    and node weights, with and without partitioned-FFT nodes."""
    nodes = {i: SimpleNamespace(compile_weight=w,
                                wants_pow2_partitions=fft and i == 0)
             for i, w in enumerate(weights)}
    for mod in (jcomp, tcomp):
        monkeypatch.setattr(mod, "_cycle_delay_bound",
                            lambda *a, **k: bound)
    args = (nodes, [], set(), FS, total)
    assert tcomp._cycle_safe_qpb(*args) == jcomp._cycle_safe_qpb(*args)
    assert tcomp._two_rate_plan(*args) == jcomp._two_rate_plan(*args)


def _render(mod, build, monkeypatch=None, env=None, **kw):
    if env:
        for k, v in env.items():
            monkeypatch.setenv(k, v)
    try:
        return build(mod, **kw).start_rendering_sync().to_array()
    finally:
        if env:
            for k in env:
                monkeypatch.delenv(k)


STEPPINGS = [{"WEBAUDIO_TWO_RATE": "0"}, {"WEBAUDIO_CYCLE_BLOCKS": "1"}]


@pytest.mark.parametrize("other", STEPPINGS, ids=["flat", "one_quantum"])
@pytest.mark.parametrize("kw", [{}, {"automate_fb": True}],
                         ids=["delay_net", "automated_in_cycle_param"])
def test_two_rate_is_bit_equal_to_other_stepping(monkeypatch, kw, other):
    ctx = delay_net(wt, **kw)
    cg = _plan(tcomp, ctx)
    assert cg.two_rate_m > 1 and cg.block_frames > int(0.2 * FS)
    got = ctx.start_rendering_sync().to_array()
    ref = _render(wt, delay_net, monkeypatch, other, **kw)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kw", [{}, {"automate_fb": True},
                                {"drive_delay": True}, {"modulate": True}],
                         ids=["delay_net", "automated_in_cycle_param",
                              "audio_driven_delay", "modulated_delay"])
def test_cycle_render_matches_jax(kw):
    got = _render(wt, delay_net, **kw)
    want = _render(wa, delay_net, **kw)
    assert np.abs(want).max() > 0.1
    _close(got, want, 1e-5)


def test_audio_driven_delay_falls_back_single_rate():
    ctx = delay_net(wt, drive_delay=True)
    cg = _plan(tcomp, ctx)
    assert (cg.block_frames, cg.two_rate_m) == (128, 1)
    assert np.isfinite(ctx.start_rendering_sync().to_array()).all()


def test_reverb_two_rate_runs_big_blocks(monkeypatch):
    """tests/test_two_rate.py::test_reverb_two_rate_runs_big_blocks on the
    port, with the synthetic dry buffer and IR (the WAV files are not in
    the repository)."""
    ref = _render(wt, reverb, monkeypatch, {"WEBAUDIO_TWO_RATE": "0"})
    ctx = reverb(wt)
    cg = _plan(tcomp, ctx)
    assert cg.block_frames // 128 > 64          # acyclic part widened
    got = ctx.start_rendering_sync().to_array()
    assert np.abs(ref).max() > 0.1
    # the convolver's FFT partition grows with the block: f32 rounding only
    np.testing.assert_allclose(got, ref, atol=3e-6)
    _close(got, _render(wa, reverb), 1e-5)


@pytest.mark.parametrize("seed", range(8))
def test_random_feedback_networks_match_per_sample_oracle(seed):
    length, loops = _random_spec(seed)
    got = fuzz_build(wt, length, loops).start_rendering_sync() \
        .get_channel_data(0)
    ref = fuzz_oracle(length, loops)
    scale = max(float(np.abs(ref).max()), 1e-3)
    np.testing.assert_allclose(got, ref, atol=2e-4 * scale, rtol=0)


@pytest.mark.parametrize("seed", range(4))
def test_random_feedback_networks_two_rate_equal_flat(monkeypatch, seed):
    length, loops = _random_spec(seed)
    two = fuzz_build(wt, length, loops).start_rendering_sync() \
        .get_channel_data(0)
    monkeypatch.setenv("WEBAUDIO_TWO_RATE", "0")
    flat = fuzz_build(wt, length, loops).start_rendering_sync() \
        .get_channel_data(0)
    np.testing.assert_array_equal(two, flat)


def fuzz_build(mod, length, loops):
    """tests/test_graph_fuzz_cycles.py::_build_ctx for either package."""
    ctx = _context(mod, 1, length)
    for lp in loops:
        if lp.src_kind == "osc":
            src = ctx.create_oscillator(type="sine", frequency=lp.src_val)
        else:
            src = ctx.create_constant_source(offset=lp.src_val)
        src.start(lp.start_frame / FS)
        mix = ctx.create_gain(gain=lp.mix_gain)
        src.connect(mix)
        delay = ctx.create_delay(max_delay_time=0.05, delay_time=lp.delay_s)
        fb = ctx.create_gain(gain=lp.fb_gain)
        mix.connect(delay)
        delay.connect(fb)
        fb.connect(mix)
        mix.connect(ctx.destination)
    return ctx


@pytest.mark.skipif(not os.path.exists(GOLDENS),
                    reason="golden fixtures not generated")
def test_golden_modulated_feedback_delay():
    got = golden_feedback(wt).start_rendering_sync().to_array()
    with np.load(GOLDENS) as z:
        _close(got, z["modulated_feedback_delay"], 1e-5)


def test_delay_free_cycle_is_muted_as_jax():
    outs = []
    for mod in (wt, wa):
        ctx = _context(mod, 1, 2048)
        src = ctx.create_constant_source(offset=0.5)
        a, b = ctx.create_gain(), ctx.create_gain(gain=0.5)
        src.connect(a)
        a.connect(b)
        b.connect(a)
        b.connect(ctx.destination)
        src.connect(ctx.destination)
        src.start()
        cg = _plan(jcomp if mod is wa else tcomp, ctx)
        assert cg.muted == {a.node_id, b.node_id}
        outs.append(ctx.start_rendering_sync().to_array())
    np.testing.assert_array_equal(outs[0], outs[1])
    assert np.all(outs[0] == 0.5)


def test_graph_batch_lane_matches_own_render_and_repeats():
    ctx = delay_net(wt, automate_fb=True)
    cg = _plan(tcomp, ctx)
    assert cg.two_rate_m > 1
    gb = wt.GraphBatch(ctx, batch=3)
    (gain,) = [n for n in ctx._nodes.values()
               if type(n).__name__ == "GainNode"]
    # lane 0 carries the context's own automation row, the others ramps
    # of their own
    own_row = cg.param_plan[(gain.node_id, "gain")].dense[:ctx.length]
    rows = np.stack([own_row] + [np.linspace(0.7, g, ctx.length,
                                             dtype=np.float32)
                                 for g in (0.5, 0.9)])
    gb.override_param(gain, "gain", rows)
    first = gb.render().numpy()[..., :ctx.length]
    second = gb.render().numpy()[..., :ctx.length]
    np.testing.assert_array_equal(first, second)
    own = delay_net(wt, automate_fb=True).start_rendering_sync().to_array()
    _close(first[0], own, 1e-6)
    assert np.abs(first[2] - first[0]).max() > 0.05


def test_mixed_batch_of_two_rate_plans_matches_own_renders():
    """tests/test_two_rate.py::test_two_rate_graph_batch_lane_matches_own_
    render on the port, plus two delay networks that differ only in the
    constant delay: they must bucket apart (the read offset is baked)."""
    ctxs = [delay_net(wt, automate_fb=True), delay_net(wt),
            delay_net(wt, delay=0.21)]
    mb = wt.MixedGraphBatch(ctxs)
    assert mb.num_buckets == 3
    outs = mb.render()
    owns = [delay_net(wt, automate_fb=True), delay_net(wt),
            delay_net(wt, delay=0.21)]
    for got, ctx in zip(outs, owns):
        _close(got, ctx.start_rendering_sync().to_array(), 1e-6)


def loop_net(mod, kind, automate=False, seconds=None):
    """A source into a constant feedback-delay loop, one of `LOOPS`: the
    delay (0.2 s) feeding itself directly ("k0"), through 0.6 ("k1"),
    through 0.9 then 0.7 ("k2"), or config 3's loop ("stereo": a looping
    stereo buffer into 0.31 s and 0.4 at 44.1 kHz, no convolver); the
    chain's tail into the destination.  The rest change one thing each, so
    the group steps: "biquad" puts a lowpass in the loop, "two_inputs" adds
    a second outside signal at the delay, "two_delays" a second delay in
    the loop, "mix_inside" a gain mixing the stereo loop to mono,
    "inner_heard" k2's first gain into the destination too.  "long", a
    2.75 s delay (132,000 frames) rendered 6 s, is fused too: a run of
    shift - 1 frames a launch walks is no limit.  `automate` gives the first gain one automation event that
    keeps its value: a dense row, so the loop steps with the same
    numbers."""
    fs = REVERB_FS if kind in ("stereo", "mix_inside") else FS
    if seconds is None:
        seconds = 6.0 if kind == "long" else 1.0
    ctx = _context(mod, 2, int(fs * seconds), fs)
    if kind in ("stereo", "mix_inside"):
        dry = np.sin(np.arange(int(fs)) * 0.03, dtype=np.float32)
        src = ctx.create_buffer_source(loop=True)
        src.buffer = mod.AudioBuffer.from_array(np.stack([dry, -0.5 * dry]),
                                                fs)
    else:
        src = ctx.create_oscillator(frequency=330.0)
    src.start()
    if kind not in ("stereo", "mix_inside"):
        src.stop(0.25)
    d = ctx.create_delay(max_delay_time=4.0 if kind == "long" else 1.0)
    d.delay_time.value = {"long": 2.75, "stereo": 0.31,
                          "mix_inside": 0.31}.get(kind, 0.2)
    src.connect(d)
    gains = {"k0": (), "k1": (0.6,), "k2": (0.9, 0.7), "stereo": (0.4,),
             "inner_heard": (0.9, 0.7)}.get(kind, (0.6,))
    chain = [d]
    for g in gains:
        chain.append(ctx.create_gain(gain=g))
    if kind == "biquad":
        chain.insert(1, ctx.create_biquad_filter(type="lowpass"))
    if kind == "two_delays":
        chain.append(ctx.create_delay(max_delay_time=1.0, delay_time=0.05))
    if kind == "mix_inside":
        chain[1].channel_count_mode = "explicit"
        chain[1].channel_count = 1
    if automate:
        chain[1].gain.set_value_at_time(gains[0], 0.01)
    for a, b in zip(chain, chain[1:]):
        a.connect(b)
    chain[-1].connect(d)
    chain[-1].connect(ctx.destination)
    if kind == "two_inputs":
        o2 = ctx.create_oscillator(frequency=550.0)
        o2.start()
        o2.stop(0.1)
        o2.connect(d)
    if kind == "inner_heard":
        chain[1].connect(ctx.destination)
    return ctx


FUSED = ("k0", "k1", "k2", "stereo", "long")
STEPPED = ("biquad", "two_inputs", "two_delays", "mix_inside", "inner_heard")


def _paths(ctx, **kw):
    return _plan(tcomp, ctx).cycle_paths if not kw else tcomp.compile_graph(
        dict(ctx._nodes), list(ctx._edges), ctx.sample_rate, ctx.length,
        ctx._destination.node_id, "cpu", **kw).cycle_paths


@pytest.mark.parametrize("case", [
    *[(k, lambda k=k: _paths(loop_net(wt, k)), "fused") for k in FUSED],
    ("config3", lambda: _paths(reverb(wt)), "fused"),
    ("batch4", lambda: wt.GraphBatch(delay_net(wt), batch=4).cg.cycle_paths,
     "fused"),
    *[(k, lambda k=k: _paths(loop_net(wt, k)), "stepped") for k in STEPPED],
    ("automated_gain", lambda: _paths(loop_net(wt, "k1", automate=True)),
     "stepped"),
    ("ramped_gain", lambda: _paths(delay_net(wt, automate_fb=True)),
     "stepped"),
    ("a_rate_delay", lambda: _paths(delay_net(wt, modulate=True)),
     "stepped"),
    ("audio_driven_delay", lambda: _paths(delay_net(wt, drive_delay=True)),
     "stepped"),
    ("dense_rows", lambda: _paths(delay_net(wt), force_dense_params=True),
     "stepped"),
    ("render_session", lambda: _session_paths(), "stepped"),
], ids=lambda c: c[0])
def test_constant_loop_path_is_planned(case):
    """`compile_graph` walks a group that is one constant feedback-delay
    loop as one launch a block ("fused") and steps any other."""
    name, paths, want = case
    assert paths() == [want]


def _session_paths():
    from webaudio_tpu_torch.checkpoint import RenderSession

    s = RenderSession(delay_net(wt), quanta_per_block=16)
    s.step(2048)
    return s._cg.cycle_paths


def test_two_rate_plans_record_a_path_per_group():
    """A two-rate plan whose groups are a fused loop and a stepped one."""
    ctx = _context(wt, 1, int(FS))
    for g, kind in ((0.6, "gain"), (0.5, "biquad")):
        o = ctx.create_oscillator(frequency=330.0)
        o.start()
        d = ctx.create_delay(max_delay_time=0.5, delay_time=0.2)
        fb = ctx.create_gain(gain=g)
        o.connect(d)
        d.connect(fb)
        if kind == "biquad":
            f = ctx.create_biquad_filter()
            fb.connect(f)
            f.connect(d)
        else:
            fb.connect(d)
        fb.connect(ctx.destination)
    cg = _plan(tcomp, ctx)
    assert cg.two_rate_m > 1 and sorted(cg.cycle_paths) == ["fused",
                                                            "stepped"]
    got = ctx.start_rendering_sync().to_array()
    assert np.abs(got).max() > 0.1 and np.isfinite(got).all()


@pytest.mark.parametrize("kind,other", [
    *[(k, "flat") for k in FUSED],
    *[(k, "automated") for k in FUSED if k != "k0"]])
def test_fused_loop_is_bit_equal_to_stepping(monkeypatch, kind, other):
    """A fused loop renders bit for bit as the single-rate walk steps it
    (WEBAUDIO_TWO_RATE=0) and as the two-rate walk steps the same graph
    with its first gain a dense row."""
    ctx = loop_net(wt, kind)
    assert _plan(tcomp, ctx).cycle_paths == ["fused"]
    got = ctx.start_rendering_sync().to_array()
    if other == "flat":
        monkeypatch.setenv("WEBAUDIO_TWO_RATE", "0")
    ref_ctx = loop_net(wt, kind, automate=other == "automated")
    assert _plan(tcomp, ref_ctx).cycle_paths == ["stepped"]
    ref = ref_ctx.start_rendering_sync().to_array()
    assert np.abs(ref).max() > 0.1
    np.testing.assert_array_equal(got, ref)


def test_fused_reverb_and_batch_are_bit_equal_to_stepping(monkeypatch):
    """Config 3 with its convolver against its gain as a dense row (the
    same plan, so the same partitions), and a batch of 4 against the same
    batch walked single-rate."""
    got = reverb(wt).start_rendering_sync().to_array()
    ctx = reverb(wt)
    (fb,) = [n for n in ctx._nodes.values() if type(n).__name__ == "GainNode"]
    fb.gain.set_value_at_time(0.4, 0.01)
    assert _plan(tcomp, ctx).cycle_paths == ["stepped"]
    np.testing.assert_array_equal(got, ctx.start_rendering_sync().to_array())
    gb = wt.GraphBatch(delay_net(wt), batch=4)
    fused = gb.render().numpy()
    monkeypatch.setenv("WEBAUDIO_TWO_RATE", "0")
    flat = wt.GraphBatch(delay_net(wt), batch=4)
    assert flat.cg.two_rate_m == 1
    np.testing.assert_array_equal(fused[..., :gb.total_frames],
                                  flat.render().numpy()[..., :gb.total_frames])


@pytest.mark.parametrize("kind", FUSED)
def test_fused_loop_matches_jax(kind):
    got = loop_net(wt, kind).start_rendering_sync().to_array()
    want = loop_net(wa, kind).start_rendering_sync().to_array()
    assert np.abs(want).max() > 0.1
    _close(got, want, 1e-5)


# halves whose plan pads nothing (a padded block would end the first half's
# states past the split) and repeats in the second half (the ring and FDL
# shapes follow the plan): 3 and 4 inner sub-steps
@pytest.mark.parametrize("build,half", [(delay_net, 23040), (reverb, 28672)],
                         ids=["delay_net", "reverb"])
def test_port_finishes_a_jax_half_render(build, half):
    """JAX renders the first half and hands its states (the delay's ring,
    the convolver's FDL) to the port, which renders the second half: the
    result matches JAX's render of both halves."""
    jctx = build(wa, frames=2 * half)
    length = jctx.length
    split = half
    args = (dict(jctx._nodes), list(jctx._edges), jctx.sample_rate)
    dest = jctx._destination.node_id
    jcg0 = jcomp.compile_graph(*args, split, dest)
    _, jst = jcomp.render_compiled(jcg0, jctx._nodes, split)
    jcg1 = jcomp.compile_graph(*args, length - split, dest, start_frame=split)
    want, _ = jcomp.render_compiled(jcg1, jctx._nodes, length - split,
                                    start_frame=split, init_states=jst)
    states = convert.states_from_jax(
        jax.tree_util.tree_map(np.asarray, jst), "cpu")
    tctx = build(wt, frames=2 * half)
    tcg1 = tcomp.compile_graph(dict(tctx._nodes), list(tctx._edges),
                               tctx.sample_rate, length - split,
                               tctx._destination.node_id, "cpu",
                               start_frame=split)
    zero = tcomp.zero_states(tcg1)
    for key, st in zero.items():
        if st is not None:
            assert {k: (v.shape, v.dtype) for k, v in st.items()} == \
                {k: (v.shape, v.dtype) for k, v in states[key].items()}
    rings = [states[tcomp._k(nid)]["ring"] for nid, k in tcg1.kernels.items()
             if type(k).__name__ == "_DelayKernel"]
    assert rings and float(rings[0].abs().max()) > 0.0
    assert jcg0.block_frames == tcg1.block_frames and \
        split % tcg1.block_frames == 0 and tcg1.two_rate_m > 1
    got, _ = tcomp.render_compiled(tcg1, length - split, start_frame=split,
                                   init_states=states)
    whole = build(wa, frames=2 * half).start_rendering_sync().to_array()
    _close(np.asarray(want)[:, :half], whole[:, half:], 1e-5)
    _close(got[:, :half].numpy(), whole[:, half:], 1e-5)



def _failing_loop(inside, at, heard=None):
    """Config 3's loop (a looping stereo buffer into a 0.31 s delay fed
    back through 0.4, 44.1 kHz, 1.5 s) with a worklet that passes its input
    through until the call whose frames reach frame `at`, then throws:
    inside the loop (delay -> 0.4 -> worklet -> delay) or, `inside` False,
    after it (delay -> 0.4 -> delay and 0.4 -> worklet).  The destination
    hears the worklet and the source at 0.25.  `heard` collects the peak
    of each input the worklet passed.  Returns (ctx, the worklet node, its
    errors)."""
    class FailsAt(wt.AudioWorkletProcessor):
        def process(self, scope, state, inputs, params):
            if int(scope.frame0) + scope.frames > at:
                raise RuntimeError("process boom")
            if heard is not None:
                heard.append(float(inputs[0].abs().max()))
            return state, [inputs[0]]

    fs = REVERB_FS
    ctx = _context(wt, 2, int(fs * 1.5), fs)
    dry = np.sin(np.arange(int(fs)) * 0.03, dtype=np.float32)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = wt.AudioBuffer.from_array(np.stack([dry, -0.5 * dry]), fs)
    src.start()
    d = ctx.create_delay(max_delay_time=1.0)
    d.delay_time.value = 0.31
    fb = ctx.create_gain(gain=0.4)
    node = ctx.create_audio_worklet(FailsAt)
    errors = []
    node.set_onprocessorerror(errors.append)
    dry_gain = ctx.create_gain(gain=0.25)
    src.connect(d)
    d.connect(fb)
    fb.connect(node)
    (node if inside else fb).connect(d)
    node.connect(ctx.destination)
    src.connect(dry_gain)
    dry_gain.connect(ctx.destination)
    return ctx, node, errors


@pytest.mark.parametrize("inside", [True, False], ids=["group", "lone"])
def test_a_processor_that_throws_is_isolated_for_its_block(monkeypatch,
                                                           inside):
    """A worklet that throws mid-render is isolated: listed as failed, its
    onprocessorerror fired once, its output silent from the start of the
    block it threw in, the rest of the graph rendering on (the destination
    hears the source alone from there, as where the worklet throws at its
    first call; finite throughout).  "group": the worklet is in config 3's
    loop, a two-rate group stepped m >= 2 times a block, and throws at a
    later sub-step than the first: the sub-steps it passed audio through
    before are silent too.  "lone": after the loop, stepped once a block
    of a single-rate walk (WEBAUDIO_TWO_RATE=0), throwing at its fourth
    block."""
    if not inside:
        monkeypatch.setenv("WEBAUDIO_TWO_RATE", "0")
    at = int(REVERB_FS)
    heard = []
    ctx, node, errors = _failing_loop(inside, at, heard)
    cg = _plan(tcomp, ctx)
    B = cg.block_frames
    first = at // B * B                 # the block holding frame `at`
    members = {nid for grp in cg.cycle_groups for nid, _ in grp}
    if inside:
        assert cg.two_rate_m >= 2 and cg.cycle_paths == ["stepped"]
        assert node.node_id in members and at % B >= 2 * cg.inner_frames
    else:
        assert cg.two_rate_m == 1 and node.node_id not in members
        assert first == 3 * B
    out = ctx.start_rendering_sync().to_array()
    assert node.node_id in ctx.render_stats["segments"][0]["failed"]
    assert len(errors) == 1 and "process boom" in str(errors[0])
    assert np.isfinite(out).all() and max(heard) > 0.01
    ref = _failing_loop(inside, at=0)[0].start_rendering_sync().to_array()
    np.testing.assert_array_equal(out[:, first:], ref[:, first:])
    if first:
        assert np.abs(out[:, :first] - ref[:, :first]).max() > 0.01
