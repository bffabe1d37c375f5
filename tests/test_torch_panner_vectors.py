"""The PannerNode reference vectors on the port (webaudio_tpu_torch), on
the CPU: tests/test_reference_vectors_panner.py's five vectors, transcribed
from the reference's panner.rs test mod (panner.rs:1060-1270), with the
same expected values and bounds, rendered by the port: equal-power
panning geometry, distance attenuation, listener frames and the HRTF
smoke behaviour.
"""

import numpy as np

import webaudio_tpu_torch as wt


def _context(channels, length, fs):
    return wt.OfflineAudioContext(channels, length, fs, device="cpu")

Q = 128


def _ones_source(ctx, frames=Q):
    buf = ctx.create_buffer(1, frames, ctx.sample_rate)
    buf.copy_to_channel(np.ones(frames, np.float32), 0)
    src = ctx.create_buffer_source()
    src.buffer = buf
    src.start()
    return src


def test_ref_audioparam_value_applies_immediately():
    """panner.rs test_audioparam_value_applies_immediately (:1070-1079)."""
    ctx = _context(1, Q, 48000.0)
    p = ctx.create_panner(position_x=12.0)
    assert p.position_x.value == 12.0


def test_ref_equal_power_mono_to_stereo():
    """panner.rs test_equal_power_mono_to_stereo (:1081-1132): source at
    (1,0,0) pans fully right; no tail-time after the source ends."""
    fs = 44100.0
    ctx = _context(2, 4 * Q, fs)
    src = _ones_source(ctx)
    p = ctx.create_panner(panning_model="equalpower", channel_count=1)
    p.position_x.set_value(1.0)
    src.connect(p)
    p.connect(ctx.destination)
    out = ctx.start_rendering_sync()
    left = out.get_channel_data(0)
    right = out.get_channel_data(1)
    np.testing.assert_allclose(left[:Q], 0.0, atol=1e-6)
    np.testing.assert_allclose(right[:Q], 1.0, atol=1e-6)
    # no tail-time
    np.testing.assert_allclose(left[Q:2 * Q], 0.0, atol=1e-6)
    np.testing.assert_allclose(right[Q:2 * Q], 0.0, atol=1e-6)


def test_ref_equal_power_azimuth_mono_to_stereo():
    """panner.rs test_equal_power_azimuth_mono_to_stereo (:1134-1171):
    source directly above -> both ears at sqrt(1/2)."""
    fs = 44100.0
    ctx = _context(2, Q, fs)
    src = _ones_source(ctx)
    p = ctx.create_panner(panning_model="equalpower")
    p.position_y.set_value(1.0)
    src.connect(p)
    p.connect(ctx.destination)
    out = ctx.start_rendering_sync()
    sqrt2 = np.float32(np.sqrt(0.5))
    np.testing.assert_allclose(out.get_channel_data(0)[:Q], sqrt2, atol=1e-6)
    np.testing.assert_allclose(out.get_channel_data(1)[:Q], sqrt2, atol=1e-6)


def test_ref_equal_power_stereo_to_stereo():
    """panner.rs test_equal_power_stereo_to_stereo (:1173-1224): listener
    at (10,0,0) facing +x with up=+z, panner at (10,10,0): fully left,
    inverse-distance 1/10, stereo input sums to 2."""
    fs = 44100.0
    ctx = _context(2, Q, fs)
    lst = ctx.listener
    lst.position_x.set_value(10.0)
    lst.position_y.set_value(0.0)
    lst.position_z.set_value(0.0)
    lst.forward_x.set_value(1.0)
    lst.forward_y.set_value(0.0)
    lst.forward_z.set_value(0.0)
    lst.up_x.set_value(0.0)
    lst.up_y.set_value(0.0)
    lst.up_z.set_value(1.0)

    buf = ctx.create_buffer(2, Q, fs)
    buf.copy_to_channel(np.ones(Q, np.float32), 0)
    buf.copy_to_channel(np.ones(Q, np.float32), 1)
    src = ctx.create_buffer_source()
    src.buffer = buf
    src.start()

    p = ctx.create_panner()
    p.position_x.set_value(10.0)
    p.position_y.set_value(10.0)
    p.position_z.set_value(0.0)
    src.connect(p)
    p.connect(ctx.destination)
    out = ctx.start_rendering_sync()
    np.testing.assert_allclose(out.get_channel_data(0)[:Q], 0.2, atol=1e-3)
    np.testing.assert_allclose(out.get_channel_data(1)[:Q], 0.0, atol=1e-3)


def test_ref_hrtf_smoke():
    """panner.rs test_hrtf (:1226-1269): HRTF output differs from the
    input and has non-zero energy in the tail quantum (the HRIR delay
    spreads the impulse)."""
    fs = 44100.0
    ctx = _context(2, 4 * Q, fs)
    src = _ones_source(ctx)
    p = ctx.create_panner(panning_model="HRTF")
    p.position_x.set_value(1.0)
    src.connect(p)
    p.connect(ctx.destination)
    out = ctx.start_rendering_sync()
    left = out.get_channel_data(0)
    right = out.get_channel_data(1)
    assert np.abs(left[:Q] - 1.0).max() > 1e-6
    assert np.abs(right[:Q] - 1.0).max() > 1e-6
    assert np.abs(left[Q:2 * Q]).max() >= 1e-6
    assert np.abs(right[Q:2 * Q]).max() >= 1e-6
