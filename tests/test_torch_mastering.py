"""The mastering chain on the port (BASELINE config 5: WaveShaper 4x ->
DynamicsCompressor -> AnalyserNode, and its batched corpus of clips at
38k/44.1k/48k) against the JAX package, on the CPU.

Each graph is built twice by one function, once per package, from the
same numpy data.  Tolerances:
- the polyphase resamplers (webaudio_tpu_torch/ops/resample.py) against
  JAX's `upsample`/`downsample` and against `fir_valid` on the
  zero-stuffed signal: 1e-6 x peak (JAX's HIGHEST-precision framed matmul
  and torch's convolution sum the same f32 products in other orders);
- renders: 1e-5 x peak, the goldens' rule;
- analyser data: float time-domain data to 1e-6 (the rings hold renders
  that differ in the last ulp), the frequency data's magnitudes to 1e-5 x
  their peak (in dB an ulp at -180 dB is a wide gap) and bytes within one
  code.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import webaudio_tpu as wa
import webaudio_tpu_torch as wt
from webaudio_tpu.graph import compiler as jcomp
from webaudio_tpu.nodes import analyser as jan
from webaudio_tpu.ops import resample as jrs
from webaudio_tpu.parallel.batch import GraphBatch as JGraphBatch
from webaudio_tpu_torch import convert
from webaudio_tpu_torch.graph import compiler as tcomp
from webaudio_tpu_torch.nodes import analyser as tan
from webaudio_tpu_torch.nodes import dynamics_compressor as tdc
from webaudio_tpu_torch.nodes import waveshaper as tws
from webaudio_tpu_torch.ops import resample as trs

FS = 48000.0
CLIP_RATES = (38000.0, 44100.0, 48000.0)


def _context(mod, channels, length, fs=FS):
    if mod is wt:
        return wt.OfflineAudioContext(channels, length, fs, device="cpu")
    return wa.OfflineAudioContext(channels, length, fs)


def _close(got, want, rel=1e-5):
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want,
                               atol=rel * max(float(np.abs(want).max()), 1e-6))


def _plan(comp, ctx, **kw):
    return comp.compile_graph(dict(ctx._nodes), list(ctx._edges),
                              ctx.sample_rate, ctx.length,
                              ctx._destination.node_id, **kw)


# --- ops/resample.py ---------------------------------------------------------


def _zero_stuffed(x, hist, factor):
    """The dense history and block as the zero-stuffed upsampled signal the
    FIR runs over: (..., C, HN - 1 + B * factor)."""
    HN = len(trs._interp_fir(factor))
    *lead, C, B = x.shape
    up = np.zeros((*lead, C, HN - 1 + B * factor), np.float32)
    for i in range(trs.TAPS_PER_PHASE):
        if i * factor < HN - 1:
            up[..., i * factor] = hist[..., i]
    up[..., HN - 1::factor] = x
    return up


@pytest.mark.parametrize("N", (1, 3))
@pytest.mark.parametrize("C", (1, 2))
@pytest.mark.parametrize("factor", (2, 4))
def test_resample_matches_jax_and_the_zero_stuffed_fir(factor, C, N):
    """upsample and downsample over (N, C, B) against JAX's per instance,
    and against `fir_valid` on the zero-stuffed (up) or full-rate (down)
    signal; the streaming states are the last dense samples and the last
    HN - 1 upsampled ones."""
    rng = np.random.RandomState(10 * factor + C + N)
    B = 384
    x = rng.randn(N, C, B).astype(np.float32)
    hist = rng.randn(N, C, trs.TAPS_PER_PHASE).astype(np.float32)
    h = trs._interp_fir(factor)
    np.testing.assert_array_equal(h, jrs._interp_fir(factor))
    HN = len(h)

    up, up_st = trs.upsample(torch.from_numpy(x), factor,
                             torch.from_numpy(hist))
    assert up.shape == (N, C, B * factor) and up.dtype == torch.float32
    np.testing.assert_array_equal(up_st.numpy(), x[..., -trs.TAPS_PER_PHASE:])
    stuffed = trs.fir_valid(torch.from_numpy(_zero_stuffed(x, hist, factor)),
                            torch.from_numpy(h))
    _close(up.numpy(), stuffed.numpy(), 1e-6)

    xd = rng.randn(N, C, B * factor).astype(np.float32)
    dhist = rng.randn(N, C, HN - 1).astype(np.float32)
    down, down_st = trs.downsample(torch.from_numpy(xd), factor,
                                   torch.from_numpy(dhist))
    ext = np.concatenate([dhist, xd], -1)
    assert down.shape == (N, C, B)
    np.testing.assert_array_equal(down_st.numpy(), ext[..., -(HN - 1):])
    full = trs.fir_valid(torch.from_numpy(ext),
                         torch.from_numpy(h / np.float32(factor)))
    _close(down.numpy(), full.numpy()[..., ::factor], 1e-6)

    for n in range(N):
        jup, jst = jrs.upsample(jnp.asarray(x[n]), factor,
                                jnp.asarray(hist[n]))
        _close(up[n].numpy(), np.asarray(jup), 1e-6)
        np.testing.assert_array_equal(up_st[n].numpy(), np.asarray(jst))
        jdown, _ = jrs.downsample(jnp.asarray(xd[n]), factor,
                                  jnp.asarray(dhist[n]))
        _close(down[n].numpy(), np.asarray(jdown), 1e-6)
    jfull = jrs._fir_valid(jnp.asarray(ext[0]), jnp.asarray(h))
    _close(trs.fir_valid(torch.from_numpy(ext[0]), torch.from_numpy(h))
           .numpy(), np.asarray(jfull), 1e-6)


@pytest.mark.parametrize("factor", (2, 4))
def test_resample_streaming_equals_one_shot(factor):
    """Two chained up + down blocks equal one block of twice the length
    (tests/test_resample_units.py), for two instances at once."""
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(2, 2, 1024).astype(np.float32))
    s_up = trs.up_fir_state(2, factor).expand(2, 2, -1)
    s_dn = trs.down_fir_state(2, factor).expand(2, 2, -1)
    u1, s_up1 = trs.upsample(x[..., :512], factor, s_up)
    u2, _ = trs.upsample(x[..., 512:], factor, s_up1)
    d1, s_dn1 = trs.downsample(u1, factor, s_dn)
    d2, _ = trs.downsample(u2, factor, s_dn1)
    uf, _ = trs.upsample(x, factor, s_up)
    df, _ = trs.downsample(uf, factor, s_dn)
    _close(torch.cat([d1, d2], -1).numpy(), df.numpy(), 1e-6)


# --- WaveShaper 2x / 4x ------------------------------------------------------

N_OS = 8192


def _shaper_render(mod, oversample, x, curve, n=N_OS):
    ctx = _context(mod, 1, n)
    buf = ctx.create_buffer(1, n, FS)
    buf.copy_to_channel(x.astype(np.float32), 0)
    src = ctx.create_buffer_source()
    src.buffer = buf
    sh = ctx.create_wave_shaper(oversample=oversample)
    sh.set_curve(curve)
    src.connect(sh)
    sh.connect(ctx.destination)
    src.start()
    return ctx.start_rendering_sync().get_channel_data(0)


def _both(oversample, x, curve):
    got = _shaper_render(wt, oversample, x, curve)
    want = _shaper_render(wa, oversample, x, curve)
    _close(got, want)
    return got


def _band_peak(spectrum, freqs, fc, width=3):
    i = int(np.argmin(np.abs(freqs - fc)))
    return spectrum[max(i - width, 0): i + width + 1].max()


def test_oversampled_shaper_suppresses_aliases_like_jax():
    """tests/test_waveshaper_oversample.py: a 10 kHz sine through a cubic
    curve folds its 3rd harmonic to 18 kHz at 1x; 2x and 4x bury it by
    60 and 80 dB more, and every render equals JAX's."""
    t = np.arange(N_OS) / FS
    sine = 0.9 * np.sin(2 * np.pi * 10000.0 * t)
    cubic = (np.linspace(-1, 1, 2049) ** 3).astype(np.float32)
    win = np.hanning(4096)
    levels = {}
    for ov in ("none", "2x", "4x"):
        out = _both(ov, sine, cubic)
        spec = np.abs(np.fft.rfft(out[3000:7096] * win))
        freqs = np.fft.rfftfreq(4096, 1.0 / FS)
        levels[ov] = 20.0 * np.log10(_band_peak(spec, freqs, 18000.0)
                                     / _band_peak(spec, freqs, 10000.0)
                                     + 1e-15)
    assert levels["none"] > -20.0, levels
    assert levels["2x"] < levels["none"] - 60.0, levels
    assert levels["4x"] < levels["none"] - 80.0, levels


@pytest.mark.parametrize("ov", ("2x", "4x"))
def test_oversampled_shaper_latency_clip_and_long_curve(ov):
    """The latency is the FIRs' analytic group delay (24 + 24 samples at
    fs), a hard clip at +-0.5 rings but stays bounded, and MDN's
    44,100-point curve shapes at the high rate; each render equals JAX's."""
    x = np.zeros(N_OS, np.float32)
    x[100] = 1.0
    out = _both(ov, x, np.linspace(-1, 1, 1025).astype(np.float32))
    assert int(np.argmax(np.abs(out))) == 100 + 48
    tone = np.sin(2 * np.pi * 440.0 * np.arange(N_OS) / FS)
    out = _both(ov, tone, np.clip(np.linspace(-1, 1, 513), -0.5, 0.5)
                .astype(np.float32))
    assert 0.5 < np.abs(out).max() < 0.62
    k = 50.0
    grid = np.linspace(-1, 1, 44100)
    mdn = ((3 + k) * grid * 20 * np.pi / 180 / (np.pi + k * np.abs(grid))
           ).astype(np.float32)
    _both(ov, 0.8 * tone, mdn)


def bench_shaper(mod, length, oversample="4x"):
    """tests/test_torch_render.py's slice graph (looping buffer -> lowpass
    -> WaveShaper), the shaper oversampled: the biquad's plan walks blocks
    of 16,384 frames, so the FIR states cross block boundaries."""
    ctx = _context(mod, 2, length)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = mod.AudioBuffer.from_array(
        np.sin(np.arange(2 * 48000) * 0.03, dtype=np.float32)[None]
        .repeat(2, 0), FS)
    src.start()
    filt = ctx.create_biquad_filter(type="lowpass", frequency=2000.0, q=2.0)
    ws = ctx.create_wave_shaper(oversample=oversample)
    ws.curve = (1.2 * np.tanh(np.linspace(-3, 3, 2048))).astype(np.float32)
    src.connect(filt)
    filt.connect(ws)
    ws.connect(ctx.destination)
    return ctx, ws


@pytest.mark.parametrize("ov", ("2x", "4x"))
def test_oversampled_shaper_across_blocks_and_a_suspend(ov):
    """Three blocks of 16,384 frames and a suspend_sync segment boundary:
    the up and down FIR histories carry across both as in JAX."""
    n = 48000
    tctx, tws_node = bench_shaper(wt, n, ov)
    jctx, _ = bench_shaper(wa, n, ov)
    for ctx in (tctx, jctx):
        ctx.suspend_sync(20000 / FS, lambda c: None)
    cg = _plan(tcomp, bench_shaper(wt, n, ov)[0], device="cpu")
    assert cg.block_frames == 16384
    (kern,) = [k for k in cg.kernels.values()
               if isinstance(k, tws._WaveShaperKernel)]
    f = int(ov[0])
    assert kern.factor == f and kern.tail_frames() == 2 * (48 * f + 1)
    got = tctx.start_rendering_sync().to_array()
    want = jctx.start_rendering_sync().to_array()
    assert len(tctx.render_stats["segments"]) == 2
    _close(got, want)


# --- AnalyserNode ------------------------------------------------------------


def _analysed(mod, x, fft_size=2048, fs=FS):
    n = x.shape[-1]
    ctx = _context(mod, 1, n, fs)
    buf = ctx.create_buffer(1, n, fs)
    buf.copy_to_channel(x.astype(np.float32), 0)
    src = ctx.create_buffer_source()
    src.buffer = buf
    an = ctx.create_analyser(fft_size=fft_size)
    src.connect(an)
    an.connect(ctx.destination)
    src.start()
    return ctx, an


def _analyser_data(an):
    td = np.zeros(an.fft_size, np.float32)
    an.get_float_time_domain_data(td)
    fd = np.zeros(an.frequency_bin_count, np.float32)
    an.get_float_frequency_data(fd)
    bt = np.zeros(an.fft_size, np.uint8)
    an.get_byte_time_domain_data(bt)
    bf = np.zeros(an.frequency_bin_count, np.uint8)
    an.get_byte_frequency_data(bf)
    return td, fd, bt, bf


def _same_analyser_data(got, want):
    td, fd, bt, bf = got
    jtd, jfd, jbt, jbf = want
    np.testing.assert_allclose(td, jtd, rtol=0, atol=1e-6)
    mag, jmag = 10.0 ** (fd / 20.0), 10.0 ** (jfd / 20.0)
    np.testing.assert_allclose(mag, jmag, rtol=0, atol=1e-5 * jmag.max())
    for b, jb in ((bt, jbt), (bf, jbf)):
        assert int(np.abs(b.astype(np.int64) - jb).max()) <= 1


@pytest.mark.parametrize("kind", ("sine", "osc"))
def test_analyser_time_frequency_and_bytes_match_jax(kind):
    """tests/test_effects.py:216 (a 1.5 kHz sine from a buffer) and
    tests/test_analysis_extra.py:10 (a 1.5 kHz oscillator, byte outputs):
    the last fft_size frames, a peak at 1.5 kHz, bytes centred on 128,
    and the same data as JAX's analyser."""
    n = 4096
    if kind == "sine":
        x = np.sin(2 * np.pi * 1500 * np.arange(n) / FS).astype(np.float32)
        data = {}
        for mod in (wt, wa):
            ctx, an = _analysed(mod, x)
            ctx.start_rendering_sync()
            data[mod] = _analyser_data(an)
        td, fd = data[wt][:2]
        np.testing.assert_allclose(td, x[-2048:], atol=1e-6)
    else:
        data = {}
        for mod in (wt, wa):
            ctx = _context(mod, 1, n)
            osc = ctx.create_oscillator(frequency=1500.0)
            an = ctx.create_analyser(fft_size=2048)
            osc.connect(an)
            an.connect(ctx.destination)
            osc.start()
            ctx.start_rendering_sync()
            data[mod] = _analyser_data(an)
        bt, bf = data[wt][2:]
        assert bt.min() < 20 and bt.max() > 235
        assert abs(int(bt.astype(np.int64).mean()) - 128) < 4
        assert bf.max() > 100
        fd = data[wt][1]
    assert abs(int(np.argmax(fd)) * FS / 2048 - 1500) < FS / 2048 * 1.5
    _same_analyser_data(data[wt], data[wa])


def test_analyser_validation_and_decibels():
    """tests/test_analysis_extra.py:33 and test_reference_vectors_misc.py:79
    (analyser.rs test_construct_decibels): the same IndexSizeErrors as JAX,
    and a (min, max) pair straddling both defaults constructs."""
    ctx = _context(wt, 1, 128)
    an = ctx.create_analyser()
    for call in (lambda: an.set_fft_size(1000), lambda: an.set_fft_size(16),
                 lambda: an.set_smoothing_time_constant(1.5),
                 lambda: an.set_min_decibels(0.0),
                 lambda: an.set_max_decibels(-200.0),
                 lambda: an.set_decibels(-10.0, -20.0)):
        with pytest.raises(wt.IndexSizeError):
            call()
    an = ctx.create_analyser(min_decibels=-10.0, max_decibels=20.0)
    assert (an.min_decibels, an.max_decibels) == (-10.0, 20.0)
    an.fft_size = 32768
    assert an.frequency_bin_count == 16384
    np.testing.assert_array_equal(tan.generate_blackman(1024),
                                  jan.generate_blackman(1024))


def test_analyser_reads_the_last_frames_after_the_render():
    """test_reference_vectors_misc.py:87 (analyser.rs
    test_analyser_after_closed) on the offline context: after the render
    has closed the context, time-domain reads return its last frames."""
    ctx = _context(wt, 1, 1024)
    src = ctx.create_constant_source()
    an = ctx.create_analyser()
    src.connect(an)
    an.connect(ctx.destination)
    src.start()
    ctx.start_rendering_sync()
    assert ctx.state == wt.AudioContextState.CLOSED
    buf = np.zeros(128, np.float32)
    an.fft_size = 128
    an.get_float_time_domain_data(buf)
    np.testing.assert_array_equal(buf, 1.0)


def test_analyser_readback_in_a_suspend_callback():
    """tests/test_offline.py:218: the ring is published after each suspend
    segment, so a callback reads the live spectrum; its data equal JAX's
    at the same point."""
    seen = {}

    def build(mod):
        ctx = _context(mod, 1, 4096)
        osc = ctx.create_oscillator(frequency=3000.0)
        an = ctx.create_analyser(fft_size=1024)
        osc.connect(an)
        an.connect(ctx.destination)
        osc.start()
        ctx.suspend_sync(2048 / FS, lambda c: seen.setdefault(
            mod, _analyser_data(an)))
        return ctx

    for mod in (wt, wa):
        build(mod).start_rendering_sync()
    fd = seen[wt][1]
    assert abs(float(np.argmax(fd) * FS / 1024) - 3000.0) < FS / 1024 * 1.5
    _same_analyser_data(seen[wt], seen[wa])


# --- the chain (config 5) ----------------------------------------------------


def _bench_data():
    # bench.py:34-37's synthetic 2 s stereo buffer: sample.wav's stand-in
    return np.sin(np.arange(2 * 48000) * 0.03, dtype=np.float32)[None].repeat(2, 0)


def mastering(mod, length, data=None, rate=FS, oversample="4x", **comp):
    """benches/suite.py::case_mastering_chain: a looping buffer ->
    WaveShaper (tanh over 2,048 points) -> DynamicsCompressor (threshold
    -18 dB, ratio 4) -> AnalyserNode (fft 2,048) -> destination."""
    ctx = _context(mod, 2, length)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = mod.AudioBuffer.from_array(
        _bench_data() if data is None else data, rate)
    src.start()
    shaper = ctx.create_wave_shaper(oversample=oversample)
    shaper.set_curve(np.tanh(np.linspace(-2, 2, 2048)).astype(np.float32))
    kw = dict(threshold=-18.0, ratio=4.0)
    kw.update(comp)
    c = ctx.create_dynamics_compressor(**kw)
    an = ctx.create_analyser(fft_size=2048)
    src.connect(shaper)
    shaper.connect(c)
    c.connect(an)
    an.connect(ctx.destination)
    return ctx, src, c, an


def test_mastering_plan_is_jax_plan():
    """Config 5a at full size (10 s, 48 kHz): one block of 480,000 frames
    (weight 5, 3,750 quanta, no pow2 wish), the same order and rows as
    JAX's; the compressor plans the chunked detector for the default
    attack; the 2 s batch plans one block of 96,000 frames."""
    for seconds, block in ((10.0, 480000), (2.0, 96000)):
        n = int(FS * seconds)
        jcg = _plan(jcomp, mastering(wa, n)[0])
        tcg = _plan(tcomp, mastering(wt, n)[0], device="cpu")
        assert tcg.block_frames == jcg.block_frames == block
        assert tcg.order == jcg.order and tcg.dense_params == jcg.dense_params
        assert tcomp._pad_len(n, block) == n
        (comp,) = [k for k in tcg.kernels.values()
                   if isinstance(k, tdc._CompressorKernel)]
        (jc,) = [k for k in jcg.kernels.values()
                 if type(k).__name__ == "_CompressorKernel"]
        assert comp.const_taus == jc.const_taus
        assert tdc.detector_mode(comp.const_taus, block) == "chunked"


@pytest.mark.parametrize("seconds,oversample", [(0.5, "4x"), (1.0, "2x")])
def test_mastering_chain_matches_jax(seconds, oversample):
    """5a's graph, cut to 0.5-1 s: the audio to 1e-5 x peak, the
    compressor's `reduction` and the analyser's data as JAX's."""
    n = int(FS * seconds)
    tctx, _, tc, tan_node = mastering(wt, n, oversample=oversample)
    jctx, _, jc, jan_node = mastering(wa, n, oversample=oversample)
    got = tctx.start_rendering_sync().to_array()
    want = jctx.start_rendering_sync().to_array()
    _close(got, want)
    assert not tctx.render_stats["segments"][0]["failed"]
    assert tc.reduction < -1.0
    assert tc.reduction == pytest.approx(jc.reduction, abs=1e-4)
    _same_analyser_data(_analyser_data(tan_node), _analyser_data(jan_node))


def test_mastering_chain_resumes_a_jax_render_at_a_suspend():
    """JAX renders the first segment and hands its states (the source's
    playhead, the shaper's `up`/`down` FIR histories, the compressor's
    `detector`, `delay` and `reduction`, the analyser's `ring`) to the
    port, which renders the rest; the result matches JAX's second
    segment."""
    length, split = 24576, 12288
    jctx = mastering(wa, length)[0]
    args = (dict(jctx._nodes), list(jctx._edges), FS)
    dest = jctx._destination.node_id
    _, jst = jcomp.render_compiled(jcomp.compile_graph(*args, split, dest),
                                   jctx._nodes, split)
    jcg1 = jcomp.compile_graph(*args, length - split, dest, start_frame=split)
    want1, _ = jcomp.render_compiled(jcg1, jctx._nodes, length - split,
                                     start_frame=split, init_states=jst)

    states = convert.states_from_jax(
        jax.tree_util.tree_map(np.asarray, jst), "cpu")
    tctx = mastering(wt, length)[0]
    tcg1 = tcomp.compile_graph(dict(tctx._nodes), list(tctx._edges), FS,
                               length - split, tctx._destination.node_id,
                               "cpu", start_frame=split)
    zero = tcomp.zero_states(tcg1)
    assert states.keys() == zero.keys()
    shapes = {nk: {k: tuple(v.shape) for k, v in st.items()}
              for nk, st in states.items() if st}
    want_shapes = {nk: {k: tuple(v.shape) for k, v in st.items()}
                   for nk, st in zero.items() if st}
    assert shapes == want_shapes
    assert {"up", "down", "detector", "delay", "reduction", "ring"} <= \
        {k for st in shapes.values() for k in st}
    got1, _ = tcomp.render_compiled(tcg1, length - split, start_frame=split,
                                    init_states=states)
    _close(got1[:, :length - split].numpy(),
           np.asarray(want1)[:, :length - split])


def corpus_clips(count, frames, seed, fs=FS):
    """Config 5b's clips: synthetic stereo clips made with numpy from a
    seed, a third each at 38,000, 44,100 and 48,000 Hz, each resampled to
    `fs` with AudioBuffer.resample (reference buffer.rs:311-363) and cut
    or zero-padded to `frames`.  Returns (count, 2, frames) f32 and the
    rates."""
    rng = np.random.default_rng(seed)
    clips = np.zeros((count, 2, frames), np.float32)
    rates = []
    for i in range(count):
        rate = CLIP_RATES[i % 3]
        n = int(rate * frames / fs * rng.uniform(0.9, 1.1))
        t = np.arange(n) / rate
        f = rng.uniform(80.0, 2000.0, (2, 1))
        x = (rng.uniform(0.3, 1.2) * np.sin(2 * np.pi * f * t)
             + 0.05 * rng.standard_normal((2, n))).astype(np.float32)
        buf = wt.AudioBuffer.from_array(x, rate)
        buf.resample(fs)
        m = min(buf.length, frames)
        clips[i, :, :m] = buf.to_array()[:, :m]
        rates.append(rate)
    return clips, rates


def test_corpus_clips_resample_like_jax():
    """The port's AudioBuffer.resample is the JAX package's numpy path."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3800)).astype(np.float32)
    for rate in CLIP_RATES:
        t, j = (mod.AudioBuffer.from_array(x, rate) for mod in (wt, wa))
        t.resample(FS)
        j.resample(FS)
        np.testing.assert_array_equal(t.to_array(), j.to_array())


def test_corpus_batch_matches_jax_and_each_render():
    """Config 5b at 4 instances: one GraphBatch of the chain, each
    instance with its own clip (override_buffer), against JAX's GraphBatch
    and against each clip's own start_rendering_sync."""
    n, count = 12288, 4
    clips, _ = corpus_clips(count, n, seed=5)
    out = {}
    for mod, GB in ((wt, wt.GraphBatch), (wa, JGraphBatch)):
        ctx, src, _, _ = mastering(mod, n, data=np.zeros((2, n), np.float32))
        gb = GB(ctx, batch=count)
        assert gb.cg.block_frames == n
        gb.override_buffer(src, clips)
        out[mod] = np.asarray(gb.render())[..., :n]
    assert float(np.abs(out[wt]).max()) > 0.1
    _close(out[wt], out[wa])
    for i in (0, 3):
        own = mastering(wt, n, data=clips[i])[0].start_rendering_sync()
        _close(out[wt][i], own.to_array(), 1e-6)


def test_mixed_batch_buckets_factors_and_taus_apart():
    """A MixedGraphBatch of mastering chains: 2x and 4x shapers, and
    compressors whose constant taus differ, plan apart (graph_fingerprint
    reads the kernels' factor and const_taus); clips differ per instance
    inside a bucket.  Every output equals its own start_rendering_sync."""
    n = 4096
    clips, _ = corpus_clips(5, n, seed=8)
    specs = [("4x", 0.003), ("4x", 0.003), ("2x", 0.003), ("4x", 0.01),
             ("2x", 0.003)]
    make = [lambda i=i, ov=ov, a=a: mastering(
        wt, n, data=clips[i], oversample=ov, attack=a)[0]
        for i, (ov, a) in enumerate(specs)]
    mb = wt.MixedGraphBatch([m() for m in make])
    assert mb.num_buckets == 3
    sizes = sorted(len(idxs) for idxs, _ in mb._buckets)
    assert sizes == [1, 2, 2]
    for got, m in zip(mb.render(), make):
        _close(got, m().start_rendering_sync().to_array(), 1e-6)


def test_mixed_batch_shapes_4x_through_a_table_of_curves(monkeypatch):
    """4x shapers whose curves differ (of one length) share a bucket: the
    bucket stages an (R, n) table and K1's contract shapes each instance's
    4x samples through its own row, in one call a block."""
    from webaudio_tpu_torch.nodes import waveshaper

    calls = []
    orig = waveshaper.curve_lookup

    def spy(curve, x):
        calls.append((tuple(curve.shape), tuple(x.shape)))
        return orig(curve, x)

    monkeypatch.setattr(waveshaper, "curve_lookup", spy)
    n = 4096
    clips, _ = corpus_clips(3, n, seed=9)

    def make(i):
        ctx, _, _, _ = mastering(wt, n, data=clips[i])
        (sh,) = [node for node in ctx._nodes.values()
                 if isinstance(node, tws.WaveShaperNode)]
        sh._curve = np.tanh((1.0 + i) * np.linspace(-2, 2, 2048)).astype(
            np.float32)
        return ctx

    mb = wt.MixedGraphBatch([make(i) for i in range(3)])
    assert mb.num_buckets == 1
    calls.clear()
    outs = mb.render()
    assert calls == [((3, 2048), (3, 2, 4 * n))]
    for i, got in enumerate(outs):
        _close(got, make(i).start_rendering_sync().to_array(), 1e-6)
