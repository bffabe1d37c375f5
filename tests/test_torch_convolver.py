"""The ConvolverNode and the IIRFilterNode on the port (webaudio_tpu_torch)
against the JAX package, on the CPU.

- The frequency-domain delay line (`ops/fft_conv.py`) with a leading
  instance axis on 1, 2 and 4 lanes, IR spectra shared or per instance,
  against the JAX package's `partitioned_conv_block` run on each instance
  (1e-5 x peak), both in its unrolled branch and in the windowed one that
  one-quantum stepping reaches (K = 690 partitions of 128, J = 1).
- `normalize_buffer_scale` equals JAX's (the f32 power sum).
- The convolver cases of tests/test_reference_vectors_convolver.py (the
  reference's literal vectors, at their tolerances) and renders of every
  channel routing (1-, 2- and 4-channel IRs, mono and stereo input, with
  and without normalization) against JAX at 1e-5 x peak.
- The IIR filter cases of tests/test_reference_vectors_iir.py (none needs
  a WAV file) on the port, and renders against JAX at 1e-5 x peak and
  against scipy `lfilter` in f64 at 1e-4 x peak.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import webaudio_tpu as wa
import webaudio_tpu_torch as wt
from webaudio_tpu.nodes import convolver as jconv
from webaudio_tpu.ops import fft_conv as jfft
from webaudio_tpu_torch.nodes import convolver as tconv
from webaudio_tpu_torch.ops import fft_conv as tfft

FS = 44100.0
CALIBRATION = 0.00125  # convolver.rs:17 GAIN_CALIBRATION


def _context(mod, channels, length, fs=FS):
    if mod is wt:
        return wt.OfflineAudioContext(channels, length, fs, device="cpu")
    return wa.OfflineAudioContext(channels, length, fs)


def _close(got, want, rel):
    assert got.shape == want.shape and np.isfinite(got).all()
    peak = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * peak)


# (lanes, block, partition, ir length, blocks): K * J <= 512 unrolls the
# partition sum; the one-quantum reverb (K = 690, J = 1) takes the window
FDL = {
    "1_lane": (1, 2048, 512, 3000, 2),
    "2_lanes": (2, 2048, 1024, 5000, 3),
    "4_lanes": (4, 1024, 256, 2000, 2),
    "one_quantum_K690": (2, 128, 128, 690 * 128, 4),
}


@pytest.mark.parametrize("per_instance", [False, True],
                         ids=["shared_ir", "ir_per_instance"])
@pytest.mark.parametrize("case", list(FDL))
def test_fdl_with_an_instance_axis_matches_jax(case, per_instance):
    L, block, P, ir_len, nblocks = FDL[case]
    N = 3
    rng = np.random.default_rng(L * 100 + block)
    irs = (rng.standard_normal((N if per_instance else 1, L, ir_len))
           * np.exp(-np.arange(ir_len) / 400.0)).astype(np.float32)
    h = np.stack([tfft.partition_ir(ir, P) for ir in irs])  # (1|N, L, K, P+1)
    K = h.shape[2]
    assert (K * (block // P) > 512) == (case == "one_quantum_K690")
    x = rng.standard_normal((N, L, nblocks * block)).astype(np.float32)
    tst = {k: v[None].repeat((N,) + (1,) * v.dim())
           for k, v in tfft.init_state(L, K, P, "cpu").items()}
    jsts = [jfft.PartitionedConvState.init(L, K, P) for _ in range(N)]
    got, want = [], []
    for b in range(nblocks):
        xb = x[..., b * block:(b + 1) * block]
        tst, ty = tfft.partitioned_conv_block(
            tst, torch.from_numpy(xb.copy()), torch.from_numpy(h), P)
        got.append(ty.numpy())
        ys = []
        for i in range(N):
            jsts[i], jy = jfft.partitioned_conv_block(
                jsts[i], jnp.asarray(xb[i]), jnp.asarray(h[i % len(h)]), P)
            ys.append(np.asarray(jy))
        want.append(np.stack(ys))
    _close(np.concatenate(got, -1), np.concatenate(want, -1), 1e-5)


@pytest.mark.parametrize("shape,rate", [((1, 1), FS), ((2, 3000), 48000.0),
                                        ((4, 777), FS), ((1, 0), FS),
                                        ((2, 64), FS)])
def test_normalize_buffer_scale_equals_jax(shape, rate):
    rng = np.random.default_rng(shape[1])
    data = rng.standard_normal(shape).astype(np.float32) * 0.3
    if shape == (2, 64):
        data[:] = 0.0                      # below min_power: the clamp
    got = tconv.normalize_buffer_scale(wt.AudioBuffer.from_array(data, rate))
    want = jconv.normalize_buffer_scale(wa.AudioBuffer.from_array(data, rate))
    assert got == want


def _convolve(mod, signal, ir_channels, length, *, disable_normalization=False,
              input_channels=None, context_channels=1):
    """tests/test_reference_vectors_convolver.py::_convolve for either
    package (the reference's test_convolve, convolver.rs:580-598)."""
    ctx = _context(mod, context_channels, length)
    if input_channels is None:
        input_channels = [signal]
    src = ctx.create_buffer_source()
    src.buffer = mod.AudioBuffer.from_array(
        np.asarray(input_channels, np.float32), FS)
    conv = ctx.create_convolver(disable_normalization=disable_normalization)
    if ir_channels is not None:
        conv.set_buffer(mod.AudioBuffer.from_array(
            np.asarray(ir_channels, np.float32).reshape(
                len(ir_channels), -1), FS))
    src.connect(conv)
    conv.connect(ctx.destination)
    src.start()
    return ctx.start_rendering_sync().to_array()


def _vec(n, **ones):
    v = np.zeros(n)
    for i, val in ones.items():
        v[int(i[1:])] = val
    return v


C = CALIBRATION
SIG = [0., 1., 0., -1., 0.]
ID4 = [[0., 1., 0., 0., 0.], [0., 0., 1., 0., 0.],
       [0., 0., 0., 1., 0.], [0., 0., 0., 0., 1.]]
VECTORS = {
    # name: (signal, ir, length, options, expected channels, atol);
    # convolver.rs:601-990 by way of test_reference_vectors_convolver.py
    "passthrough": (SIG, None, 10, {}, [[0., 1., 0., -1., 0.] + [0.] * 5],
                    1e-6),
    "empty": (SIG, [[]], 10, {}, [[0.] * 10], 1e-6),
    "zeroed": (SIG, [[0.] * 6], 10, {}, [[0.] * 10], 1e-6),
    "identity": (SIG, [[1.]], 10, {}, [[0., C, 0., -C, 0.] + [0.] * 5], 1e-6),
    "two_id": (SIG, [[1., 1.]], 10, {}, [[0., C, C, -C, -C] + [0.] * 5],
               1e-6),
    "1_chan_in_1_chan_ir": (None, [[0., 1.]], 128,
                            dict(input_channels=[[1.]], context_channels=1),
                            [_vec(128, i1=1.)], 1e-7),
    "1_chan_in_2_chan_ir": (None, [[0., 1., 0.], [0., 0., 1.]], 128,
                            dict(input_channels=[[1.]], context_channels=2),
                            [_vec(128, i1=1.), _vec(128, i2=1.)], 1e-7),
    "2_chan_in_1_chan_ir": (None, [[0., 1.]], 128,
                            dict(input_channels=[[1., 0.], [0., 1.]],
                                 context_channels=2),
                            [_vec(128, i1=1.), _vec(128, i2=1.)], 1e-7),
    "2_chan_in_2_chan_ir": (None, [[0., 1., 0.], [0., 0., 1.]], 128,
                            dict(input_channels=[[1., 0.], [0., 1.]],
                                 context_channels=2),
                            [_vec(128, i1=1.), _vec(128, i3=1.)], 1e-7),
    "2_chan_in_4_chan_ir": (None, ID4, 128,
                            dict(input_channels=[[1., 0.], [0., 1.]],
                                 context_channels=2),
                            [_vec(128, i1=1., i4=1.),
                             _vec(128, i2=1., i5=1.)], 1e-7),
    "1_chan_in_4_chan_ir": (None, ID4, 128,
                            dict(input_channels=[[1., 0.]],
                                 context_channels=2),
                            [_vec(128, i1=1., i3=1.),
                             _vec(128, i2=1., i4=1.)], 1e-7),
}


@pytest.mark.parametrize("name", list(VECTORS))
def test_convolver_reference_vectors(name):
    signal, ir, length, opts, expected, atol = VECTORS[name]
    if "input_channels" in opts:
        opts = dict(opts, disable_normalization=True)
    got = _convolve(wt, signal, ir, length, **opts)
    np.testing.assert_allclose(got, np.asarray(expected), atol=atol)
    np.testing.assert_allclose(
        got, _convolve(wa, signal, ir, length, **opts), atol=atol)


def test_constructor_option_buffer_and_tail_time():
    # convolver.rs:551-578 and :653-669
    ctx = _context(wt, 1, 10)
    src = ctx.create_buffer_source()
    src.buffer = wt.AudioBuffer.from_array(np.array([SIG], np.float32), FS)
    conv = ctx.create_convolver(
        buffer=wt.AudioBuffer.from_array(np.ones((1, 1), np.float32), FS))
    src.connect(conv)
    conv.connect(ctx.destination)
    src.start()
    np.testing.assert_allclose(ctx.start_rendering_sync().get_channel_data(0),
                               [0., C, 0., -C, 0., 0., 0., 0., 0., 0.],
                               atol=1e-6)
    data = _convolve(wt, [1.], [[1.] * 256], 512)[0]
    assert np.all(data[:256] > 1e-6)
    np.testing.assert_allclose(data[256:], np.zeros(256), atol=1e-6)


def test_convolver_refusals_as_jax():
    for mod in (wt, wa):
        ctx = _context(mod, 1, 128, 44100.0)
        with pytest.raises(mod.NotSupportedError):
            ctx.create_convolver(buffer=mod.AudioBuffer.from_array(
                np.ones((1, 1), np.float32), 48000.0))
        with pytest.raises(mod.NotSupportedError):
            ctx.create_convolver(buffer=mod.AudioBuffer.from_array(
                np.ones((3, 1), np.float32), 44100.0))
        conv = ctx.create_convolver()
        with pytest.raises(mod.NotSupportedError):
            conv.channel_count = 3
        with pytest.raises(mod.NotSupportedError):
            conv.channel_count_mode = "max"
        conv.channel_count = 1
        conv.normalize = False
        assert conv.buffer is None and not conv.normalize


def convolver_graph(mod, ir_channels, in_channels, normalize, length=6000):
    """Seeded noise (mono or stereo) through a convolver whose IR has 1, 2
    or 4 channels and spans several partitions."""
    ctx = _context(mod, 2, length)
    rng = np.random.default_rng(ir_channels * 10 + in_channels)
    x = rng.uniform(-0.7, 0.7, (in_channels, length)).astype(np.float32)
    n = 2500
    ir = (rng.standard_normal((ir_channels, n))
          * np.exp(-np.arange(n) / 600.0)).astype(np.float32)
    src = ctx.create_buffer_source()
    src.buffer = mod.AudioBuffer.from_array(x, FS)
    conv = ctx.create_convolver(disable_normalization=not normalize)
    conv.buffer = mod.AudioBuffer.from_array(ir, FS)
    src.connect(conv)
    conv.connect(ctx.destination)
    src.start()
    return ctx


ROUTES = [(ir, cin, True) for ir in (1, 2, 4) for cin in (1, 2)] + \
    [(2, 2, False), (4, 1, False)]


@pytest.mark.parametrize("ir_channels,in_channels,normalize", ROUTES)
def test_convolver_render_matches_jax(ir_channels, in_channels, normalize):
    got = convolver_graph(wt, ir_channels, in_channels, normalize) \
        .start_rendering_sync().to_array()
    want = convolver_graph(wa, ir_channels, in_channels, normalize) \
        .start_rendering_sync().to_array()
    assert np.abs(want).max() > 1e-3
    _close(got, want, 1e-5)


# --- IIRFilterNode -----------------------------------------------------


@pytest.mark.parametrize("ff,fb,err", [
    ([1.0] * 21, [1.0] * 3, "NotSupportedError"),
    ([0.0] * 5, [1.0] * 3, "InvalidStateError"),
    ([1.0] * 3, [1.0] * 21, "NotSupportedError"),
    ([1.0] * 3, [0.0] + [1.0] * 4, "InvalidStateError"),
    ([], [1.0], "NotSupportedError"),
    ([1.0, np.nan], [1.0], "InvalidStateError"),
    ([1.0] * 5, [1.0] * 3, None),
    ([1.0] * 3, [1.0] * 5, None),
])
def test_iir_validation_as_jax(ff, fb, err):
    # iir_filter.rs:120-170 (test_reference_vectors_iir.py's cases)
    for mod in (wt, wa):
        ctx = _context(mod, 2, 512)
        if err is None:
            ctx.create_iir_filter(ff, fb)
        else:
            with pytest.raises(getattr(mod, err)):
                ctx.create_iir_filter(ff, fb)


@pytest.mark.parametrize("mag_len,phase_len", [(2, 1), (1, 2)])
def test_iir_frequency_response_arguments(mag_len, phase_len):
    ctx = _context(wt, 2, 555)
    iir = ctx.create_iir_filter([1.0] * 10, [1.0] * 10)
    with pytest.raises(wt.InvalidAccessError):
        iir.get_frequency_response(np.zeros(1, np.float32),
                                   np.zeros(mag_len, np.float32),
                                   np.zeros(phase_len, np.float32))


def test_iir_one_zero_vector():
    # iir_filter.rs: a pure FIR [0.5, 0.5] against an impulse
    fs = 24000.0
    ctx = wt.OfflineAudioContext(1, 8000, fs, device="cpu")
    src = ctx.create_buffer_source()
    src.buffer = wt.AudioBuffer.from_array(np.ones((1, 1), np.float32), fs)
    iir = ctx.create_iir_filter([0.5, 0.5], [1.0])
    src.connect(iir)
    iir.connect(ctx.destination)
    src.start()
    want = np.zeros(8000, np.float32)
    want[:2] = 0.5
    np.testing.assert_allclose(ctx.start_rendering_sync().get_channel_data(0),
                               want, atol=1e-6)


def test_iir_get_frequency_response_vector():
    # iir_filter.rs tests_get_frequency_response: a scipy cheby2 highpass
    ref_mag = np.array([
        1e-3, 4.152807e-4, 1.4607895e-3, 5.051316e-3, 1.1303235e-2,
        2.2303402e-2, 4.311698e-2, 8.84345e-2, 2.1466202e-1, 6.802952e-1,
    ], np.float32)
    freqs = np.array([0., 2205., 4410., 6615., 8820., 11025., 13230.,
                      15435., 17640., 19845., 30000.], np.float32)
    got = []
    for mod in (wt, wa):
        iir = _context(mod, 2, 512).create_iir_filter(
            [0.019618022238052212, -0.03600792810244924, 0.01961802223805221],
            [1.0, 1.5764362005383137, 0.6516801731168673])
        mag = np.zeros(11, np.float32)
        phase = np.zeros(11, np.float32)
        iir.get_frequency_response(freqs, mag, phase)
        got.append((mag, phase))
    np.testing.assert_allclose(got[0][0][:10], ref_mag, rtol=1e-5, atol=1e-7)
    assert np.isnan(got[0][0][10]) and np.isnan(got[0][1][10])
    np.testing.assert_array_equal(got[0][0], got[1][0])
    np.testing.assert_array_equal(got[0][1], got[1][1])


# the reference's unnormalized biquad coefficients for frequency 2000, q 1,
# gain 3 at 44.1 kHz (test_reference_vectors_iir.py, iir_filter.rs
# test_output_against_biquad): (feedback, feedforward)
BIQUAD_COEFS = {
    "lowpass": ([1.1252702717383296, -1.9193504546709936, 0.8747297282616704],
                [0.02016238633225159, 0.04032477266450318,
                 0.02016238633225159]),
    "highpass": ([1.1252702717383296, -1.9193504546709936,
                  0.8747297282616704],
                 [0.9798376136677485, -1.959675227335497,
                  0.9798376136677485]),
    "bandpass": ([1.1405555566658274, -1.9193504546709936,
                  0.8594444433341726],
                 [0.14055555666582747, 0.0, -0.14055555666582747]),
    "notch": ([1.1405555566658274, -1.9193504546709936, 0.8594444433341726],
              [1.0, -1.9193504546709936, 1.0]),
    "allpass": ([1.1405555566658274, -1.9193504546709936,
                 0.8594444433341726],
                [0.8594444433341726, -1.9193504546709936,
                 1.1405555566658274]),
    "peaking": ([1.1182627625098631, -1.9193504546709936,
                 0.8817372374901369],
                [1.167050592175986, -1.9193504546709936,
                 0.8329494078240139]),
    "lowshelf": ([2.8028072429836723, -4.577507200153761, 1.935999047828101],
                 [2.9011403634599007, -4.544236234748791,
                  1.8709368927568424]),
    "highshelf": ([2.4410054070459357, -3.8234982904056865,
                   1.5741972118903644],
                  [3.331142651362703, -5.440377503491735,
                   2.300939180659645]),
}


def _filtered(noise, make_node):
    ctx = wt.OfflineAudioContext(1, 1000, 44100.0, device="cpu")
    node = make_node(ctx)
    node.connect(ctx.destination)
    src = ctx.create_buffer_source()
    src.connect(node)
    src.buffer = wt.AudioBuffer.from_array(noise[None], 44100.0)
    src.start()
    return ctx.start_rendering_sync().get_channel_data(0)


@pytest.mark.parametrize("ftype", list(BIQUAD_COEFS))
def test_iir_output_against_biquad(ftype):
    # the IIR node fed the biquad's unnormalized coefficients renders what
    # the BiquadFilterNode renders (at the JAX suite's 2e-6)
    feedback, feedforward = BIQUAD_COEFS[ftype]
    noise = np.random.RandomState(7).uniform(-0.5, 0.5, 2000) \
        .astype(np.float32)

    def biquad(ctx):
        f = ctx.create_biquad_filter()
        f.type = ftype
        f.frequency.set_value(2000.0)
        f.q.set_value(1.0)
        f.gain.set_value(3.0)
        return f

    np.testing.assert_allclose(
        _filtered(noise, lambda c: c.create_iir_filter(feedforward, feedback)),
        _filtered(noise, biquad), atol=2e-6)


def iir_chain(mod, length, fs=48000.0):
    """benches/suite.py::case_iir_chain with bench.py's synthetic buffer:
    a looping source through butter(4, 0.2)."""
    from scipy.signal import butter

    ctx = _context(mod, 2, length, fs)
    data = np.sin(np.arange(2 * 48000) * 0.03, dtype=np.float32)[None]
    src = ctx.create_buffer_source(loop=True)
    src.buffer = mod.AudioBuffer.from_array(data.repeat(2, 0), fs)
    src.start()
    b, a = butter(4, 0.2)
    f = ctx.create_iir_filter(feedforward=b, feedback=a)
    src.connect(f)
    f.connect(ctx.destination)
    return ctx


def test_iir_chain_matches_jax_and_lfilter():
    from scipy.signal import butter, lfilter

    length = 20000
    got = iir_chain(wt, length).start_rendering_sync().to_array()
    _close(got, iir_chain(wa, length).start_rendering_sync().to_array(), 1e-5)
    x = np.sin(np.arange(length) * 0.03, dtype=np.float32).astype(np.float64)
    want = lfilter(*butter(4, 0.2), x)
    _close(got, np.stack([want, want]), 1e-4)
