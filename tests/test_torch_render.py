"""Whole renders through the port (webaudio_tpu_torch) against the JAX
package, on the CPU.

Each graph is built twice by one function, once per package, from the same
numpy data.  The rendered audio must agree to the goldens' rule
(atol = 1e-5 x peak, tests/test_goldens.py) and the two plans must match:
block size, node order and dense param rows.
"""

import os

import numpy as np
import pytest
import torch

import jax

import webaudio_tpu as wa
import webaudio_tpu_torch as wt
from webaudio_tpu.graph import compiler as jcomp
from webaudio_tpu_torch import convert
from webaudio_tpu_torch.graph import compiler as tcomp

FS = 48000.0
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens.npz")


def _context(mod, channels, length, fs=FS):
    if mod is wt:
        return wt.OfflineAudioContext(channels, length, fs, device="cpu")
    return wa.OfflineAudioContext(channels, length, fs)


def _bench_buffer(mod, fs=FS):
    # bench.py:34-37's synthetic 2 s stereo buffer
    data = np.sin(np.arange(2 * 48000) * 0.03, dtype=np.float32)[None].repeat(2, 0)
    return mod.AudioBuffer.from_array(data, fs)


def bench_graph(mod, length, shaper=False):
    """bench.py's graph (looping source -> lowpass -> destination), with
    the mastering chain's WaveShaper after the filter when `shaper`."""
    ctx = _context(mod, 2, length)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = _bench_buffer(mod)
    src.start()
    filt = ctx.create_biquad_filter(type="lowpass", frequency=2000.0, q=2.0)
    src.connect(filt)
    if shaper:
        ws = ctx.create_wave_shaper()
        ws.curve = np.tanh(np.linspace(-2, 2, 2048)).astype(np.float32)
        filt.connect(ws)
        ws.connect(ctx.destination)
    else:
        filt.connect(ctx.destination)
    return ctx


def resampled_graph(mod, length):
    """The slice graph fed by a 44.1 kHz buffer: the pair-gather read."""
    ctx = _context(mod, 2, length)
    n = 44100
    data = np.stack([np.sin(np.arange(n) * 0.031), np.cos(np.arange(n) * 0.017)]
                    ).astype(np.float32)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = mod.AudioBuffer.from_array(data, 44100.0)
    src.start()
    filt = ctx.create_biquad_filter(type="lowpass", frequency=2000.0, q=2.0)
    ws = ctx.create_wave_shaper(
        curve=np.tanh(np.linspace(-2, 2, 2048)).astype(np.float32))
    src.connect(filt)
    filt.connect(ws)
    ws.connect(ctx.destination)
    return ctx


def readme_sweep(mod, length):
    """README's a-rate example with the synthetic buffer: the filter
    frequency sweeps exponentially over the render."""
    ctx = _context(mod, 2, length)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = _bench_buffer(mod)
    filt = ctx.create_biquad_filter(type="lowpass", q=8.0)
    filt.frequency.set_value_at_time(200.0, 0.0)
    filt.frequency.exponential_ramp_to_value_at_time(8000.0, length / FS)
    src.connect(filt)
    filt.connect(ctx.destination)
    src.start()
    return ctx


def gain_ramp(mod, length):
    """The verify recipe's gain ramp, fed by a constant 0.8 buffer (the
    constant source is not ported): 0 -> 1 over 0.1 s, stop at 0.4 s."""
    ctx = _context(mod, 2, length)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = mod.AudioBuffer.from_array(np.full((1, 128), 0.8, np.float32), FS)
    env = ctx.create_gain(gain=0.0)
    env.gain.linear_ramp_to_value_at_time(1.0, 0.1)
    src.connect(env)
    env.connect(ctx.destination)
    src.start()
    src.stop(0.4)
    return ctx


def resampled_bandpass(mod):
    """tests/test_goldens.py's `resampled_bandpass` case."""
    ctx = _context(mod, 1, 2048)
    rng = np.random.RandomState(0)
    buf = ctx.create_buffer(1, 1500, FS)
    buf.copy_to_channel(rng.randn(1500).astype(np.float32) * 0.3, 0)
    s = ctx.create_buffer_source(playback_rate=0.73, loop=True)
    s.buffer = buf
    f = ctx.create_biquad_filter(type="bandpass", frequency=2000.0, q=5.0)
    s.connect(f)
    f.connect(ctx.destination)
    s.start(0.0, 0.002)
    return ctx


def _plan(comp, ctx, **kw):
    return comp.compile_graph(dict(ctx._nodes), list(ctx._edges),
                              ctx.sample_rate, ctx.length,
                              ctx._destination.node_id, **kw)


def _assert_same_plan(graph_fn, *args):
    jcg = _plan(jcomp, graph_fn(wa, *args))
    tcg = _plan(tcomp, graph_fn(wt, *args), device="cpu")
    assert tcg.block_frames == jcg.block_frames
    assert tcg.order == jcg.order
    assert tcg.dense_params == jcg.dense_params
    assert not tcg.failed and not jcg.failed
    return tcg


def _assert_close(got, want):
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want,
                               atol=1e-5 * max(np.abs(want).max(), 1e-6))


def _render_both(graph_fn, *args):
    want = graph_fn(wa, *args).start_rendering_sync().to_array()
    ctx = graph_fn(wt, *args)
    got = ctx.start_rendering_sync().to_array()
    return got, want, ctx


CASES = [
    pytest.param(bench_graph, (48000,), id="bench-1s"),
    pytest.param(bench_graph, (48000 * 3 + 77,), id="bench-multiblock"),
    pytest.param(bench_graph, (48000, True), id="slice-waveshaper"),
    pytest.param(bench_graph, (40000, True), id="slice-waveshaper-padded"),
    pytest.param(resampled_graph, (30000,), id="slice-pair-gather"),
    pytest.param(gain_ramp, (24000,), id="gain-ramp"),
]


@pytest.mark.parametrize("graph_fn,args", CASES)
def test_render_matches_jax(graph_fn, args):
    _assert_same_plan(graph_fn, *args)
    got, want, ctx = _render_both(graph_fn, *args)
    _assert_close(got, want)
    assert all(not seg["failed"] for seg in ctx.render_stats["segments"])


def test_readme_sweep():
    """The a-rate biquad.  Its f32 coefficients come from sin/cos, which
    XLA and torch round differently in the last ulp for a few percent of
    the samples; the resonant sweep turns those ulps into up to 1.8e-5 x
    peak even through an exact f64 recurrence.  So the port is held to
    the JAX render at 1e-4 x peak, and its f64 scan to a sequential f64
    direct-form run on its own coefficients at 1e-6 x peak."""
    from webaudio_tpu_torch.nodes import biquad_filter as tb

    n = 24000
    tcg = _assert_same_plan(readme_sweep, n)
    got, want, _ = _render_both(readme_sweep, n)
    assert got.shape == want.shape and np.isfinite(got).all()
    peak = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-4 * peak)

    filt = [nid for nid, k in tcg.kernels.items()
            if isinstance(k, tb._BiquadARateKernel)][0]
    freq = torch.from_numpy(np.clip(
        tcg.param_plan[(filt, "frequency")].dense[:n], 0.0, FS / 2))
    coefs = [c.double().numpy() for c in tb._coefs_generic(
        tb._TorchOps, tb.BiquadFilterType.LOWPASS, FS, freq,
        torch.tensor(0.0), torch.tensor(8.0))]
    x = _bench_buffer(wt).to_array()[0].astype(np.float64)
    x = np.tile(x, -(-n // len(x)))[:n]
    b0, b1, b2, a1, a2 = coefs
    y = np.zeros(n)
    x1 = x2 = y1 = y2 = 0.0
    for i in range(n):
        y[i] = b0[i] * x[i] + b1[i] * x1 + b2[i] * x2 - a1[i] * y1 - a2[i] * y2
        x2, x1, y2, y1 = x1, x[i], y1, y[i]
    np.testing.assert_allclose(got[0], y, atol=1e-6 * peak)
    np.testing.assert_array_equal(got[0], got[1])


def test_main_path_plan_is_two_262144_frame_blocks():
    # the 10 s bench graph pads 480,000 frames to 2 x 262,144
    cg = _assert_same_plan(bench_graph, 480000, True)
    assert cg.block_frames == 262144
    assert tcomp._pad_len(480000, cg.block_frames) == 2 * 262144


def test_multiblock_case_really_spans_blocks():
    cg = _assert_same_plan(bench_graph, 48000 * 3 + 77)
    assert tcomp._pad_len(cg.total_frames, cg.block_frames) >= 2 * cg.block_frames


def test_gain_ramp_values():
    out = gain_ramp(wt, 24000).start_rendering_sync().to_array()
    t = np.arange(24000) / FS
    want = np.where(t < 0.4, 0.8 * np.minimum(t / 0.1, 1.0), 0.0)
    np.testing.assert_allclose(out[0], want, atol=1e-6)
    np.testing.assert_array_equal(out[0], out[1])


@pytest.mark.skipif(not os.path.exists(GOLDENS), reason="no golden fixtures")
def test_resampled_bandpass_golden():
    with np.load(GOLDENS) as z:
        ref = z["resampled_bandpass"]
    _assert_same_plan(lambda mod: resampled_bandpass(mod))
    got = resampled_bandpass(wt).start_rendering_sync().to_array()
    _assert_close(got, ref)


def _suspended(mod, length):
    ctx = bench_graph(mod, length, shaper=True)
    filt = [n for n in ctx._nodes.values()
            if type(n).__name__ == "BiquadFilterNode"][0]

    def retune(c):
        filt.frequency.set_value(900.0)

    ctx.suspend_sync(0.25, retune)
    return ctx


def test_suspend_sync_render_matches_jax():
    got, want, ctx = _render_both(_suspended, 48000)
    _assert_close(got, want)
    assert len(ctx.render_stats["segments"]) == 2


def test_resources_convert_from_jax():
    for graph_fn, args in ((bench_graph, (48000, True)), (resampled_graph, (30000,))):
        jcg = _plan(jcomp, graph_fn(wa, *args))
        tcg = _plan(tcomp, graph_fn(wt, *args), device="cpu")
        jres = jax.tree_util.tree_map(np.asarray, jcomp.collect_resources(jcg))
        from_jax = convert.resources_from_jax(jres, "cpu")
        ours = convert.to_torch_tree(tcomp.collect_resources(tcg), "cpu")
        assert from_jax.keys() == ours.keys()
        for node_key in ours:
            assert from_jax[node_key].keys() == ours[node_key].keys()
            for name, t in ours[node_key].items():
                assert from_jax[node_key][name].dtype == t.dtype, name
                assert torch.equal(from_jax[node_key][name], t), name


def test_port_continues_a_suspended_jax_render():
    """JAX renders segment 0 and hands its states to the port, which
    renders segment 1; the result matches the JAX render of both.  Both
    segments plan 16384-frame blocks, so every state carries over."""
    length, split = 32768, 16384
    jctx = bench_graph(wa, length, shaper=True)
    args = (dict(jctx._nodes), list(jctx._edges), FS)
    dest = jctx._destination.node_id
    jcg0 = jcomp.compile_graph(*args, split, dest)
    out0, jst = jcomp.render_compiled(jcg0, jctx._nodes, split)
    jcg1 = jcomp.compile_graph(*args, length - split, dest, start_frame=split)
    want1, _ = jcomp.render_compiled(jcg1, jctx._nodes, length - split,
                                     start_frame=split, init_states=jst)

    states = convert.states_from_jax(
        jax.tree_util.tree_map(np.asarray, jst), "cpu")
    assert states["n2"]["spectra"].dtype == torch.complex64
    assert states["n1"]["buffer_time"].dtype == torch.float64
    tctx = bench_graph(wt, length, shaper=True)
    tcg1 = tcomp.compile_graph(dict(tctx._nodes), list(tctx._edges), FS,
                               length - split, tctx._destination.node_id,
                               "cpu", start_frame=split)
    assert tcg1.block_frames == jcg0.block_frames == 16384
    got1, _ =tcomp.render_compiled(tcg1, length - split, start_frame=split,
                                    init_states=states)
    got1 = got1[:, :length - split].numpy()
    want1 = np.asarray(want1)[:, :length - split]
    _assert_close(got1, want1)
    whole = bench_graph(wa, length, shaper=True).start_rendering_sync().to_array()
    _assert_close(np.concatenate([np.asarray(out0)[:, :split], got1], axis=1),
                  whole)


def test_kernel_error_propagates_instead_of_muting(monkeypatch):
    from webaudio_tpu_torch.nodes import waveshaper

    def broken(curve, x):
        raise wt.KernelError("launch refused")

    monkeypatch.setattr(waveshaper, "curve_lookup", broken)
    ctx = bench_graph(wt, 4096, shaper=True)
    with pytest.raises(wt.KernelError):
        ctx.start_rendering_sync()


def test_processor_error_is_isolated_like_jax(monkeypatch):
    from webaudio_tpu_torch.nodes import waveshaper

    def broken(curve, x):
        raise ValueError("processor bug")

    monkeypatch.setattr(waveshaper, "curve_lookup", broken)
    seen = []
    ctx = bench_graph(wt, 4096, shaper=True)
    shaper = [n for n in ctx._nodes.values()
              if isinstance(n, waveshaper.WaveShaperNode)][0]
    shaper.set_onprocessorerror(seen.append)
    out = ctx.start_rendering_sync().to_array()
    assert not out.any()
    assert [type(e) for e in seen] == [ValueError]
    assert list(ctx.render_stats["segments"][0]["failed"]) == [shaper.node_id]


def test_unported_parts_raise_not_supported():
    ctx = _context(wt, 1, 1024)
    with pytest.raises(wt.NotSupportedError):
        ctx.decode_audio_data_sync("clip.wav")

    # a script processor, refused until the user-code nodes were ported,
    # renders as JAX's
    rendered = []
    for mod in (wt, wa):
        ctx = _context(mod, 1, 2048)
        src = ctx.create_constant_source(offset=0.25)
        sp = ctx.create_script_processor(256, 1, 1)
        sp.set_onaudioprocess(
            lambda ev: ev.output_buffer.__setitem__(
                slice(None), ev.input_buffer * 2.0))
        src.connect(sp)
        sp.connect(ctx.destination)
        src.start()
        rendered.append(ctx.start_rendering_sync().to_array())
    assert rendered[1][0, -1] == 0.5
    np.testing.assert_array_equal(*rendered)

    # an oversampled shaper, refused until its resamplers were ported,
    # renders as JAX's
    rendered = []
    for mod in (wt, wa):
        ctx = bench_graph(mod, 4096, shaper=True)
        [n for n in ctx._nodes.values()
         if hasattr(n, "oversample")][0].oversample = "4x"
        rendered.append(ctx.start_rendering_sync().to_array())
    _assert_close(*rendered)

    # an automated playback rate, refused until the cumsum playhead was
    # ported, renders as JAX's
    rendered = []
    for mod in (wt, wa):
        ctx = bench_graph(mod, 4096)
        [n for n in ctx._nodes.values()
         if hasattr(n, "playback_rate")][0].playback_rate \
            .linear_ramp_to_value_at_time(2.0, 0.05)
        rendered.append(ctx.start_rendering_sync().to_array())
    _assert_close(*rendered)

    # a cycle without a delay, refused until cycles were ported, is muted
    # (reference: graph.rs:331-402) and renders silence, as JAX's
    rendered = []
    for mod in (wt, wa):
        ctx = _context(mod, 1, 1024)
        src = ctx.create_constant_source(offset=0.5)
        g1, g2 = ctx.create_gain(), ctx.create_gain()
        src.connect(g1)
        g1.connect(g2)
        g2.connect(g1)
        g2.connect(ctx.destination)
        src.start()
        rendered.append(ctx.start_rendering_sync().to_array())
    assert not rendered[1].any()
    np.testing.assert_array_equal(*rendered)


def fusable_bank(mod):
    """32 same-buffer sources of 64 samples starting one frame apart: a
    bank that fuses, and whose grains all overlap, so it renders as one
    (V, B) closed-form playhead (K * 4 > V)."""
    ctx = _context(mod, 1, 1024)
    buf = mod.AudioBuffer.from_array(np.ones((1, 64), np.float32), FS)
    for i in range(32):
        s = ctx.create_buffer_source()
        s.buffer = buf
        s.connect(ctx.destination)
        s.start(i / FS)
    return ctx


def test_fusable_bank_renders():
    cg = _assert_same_plan(fusable_bank)
    (fused,) = [k for k in cg.kernels.values()
                if type(k).__name__ == "_FusedVoicesKernel"]
    assert fused.V == 32 and not fused.use_lanes
    got, want, _ = _render_both(fusable_bank)
    # the granular renders' tolerance (tests/test_torch_fusion.py)
    assert got.shape == want.shape and want.max() == 32.0
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-5)
    assert np.sum((got - want) ** 2.0) <= 1e-9 * np.sum(want ** 2.0)


def test_device_defaults_to_the_card():
    # naming the card needs no GPU; rendering on it without one would fail
    ctx = wt.OfflineAudioContext(2, 128, FS)
    assert ctx.device == torch.device("cuda")
    ctx = wt.OfflineAudioContext(2, 128, FS, device="cpu")
    assert ctx.device == torch.device("cpu")


def test_every_jax_context_name_works_or_is_refused():
    """Every public name of the JAX package's OfflineAudioContext exists on
    the port: a factory or method that is ported builds or runs, one that
    is not raises NotSupportedError (never AttributeError); the `listener`
    attribute is the AudioListener."""
    refused = {"decode_audio_data", "decode_audio_data_sync"}
    calls = {"create_buffer": (1, 16, FS), "create_oscillator_bank": ([220.0],),
             "create_audio_param": (wt.AudioParamDescriptor(
                 "p", wt.AutomationRate.A, 0.0, -1.0, 1.0),),
             "create_audio_worklet": (wt.AudioWorkletProcessor,),
             "suspend": (0.01,),
             "create_iir_filter": ([1.0], [1.0]),
             "set_oncomplete": (lambda ev: None,),
             "oncomplete": (lambda ev: None,),
             "set_onstatechange": (lambda ev: None,),
             "suspend_sync": (0.01, lambda c: None)}
    names = [n for n in dir(wa.OfflineAudioContext) if not n.startswith("_")]
    assert "listener" in names and "start_rendering" in names
    for name in names:
        ctx = _context(wt, 1, 1024)
        if name in refused:
            with pytest.raises(wt.NotSupportedError):
                attr = getattr(ctx, name)
                attr()
            continue
        attr = getattr(ctx, name)
        if name == "resume":
            # nothing is suspended
            with pytest.raises(wt.InvalidStateError):
                attr()
        elif name == "start_rendering":
            assert attr().result(timeout=60).length == 1024
        elif callable(attr):
            attr(*calls.get(name, ()))
    ctx = _context(wt, 1, 1024)
    ctx.create_oscillator().connect(ctx.destination)
    assert ctx.start_rendering_sync().length == 1024
