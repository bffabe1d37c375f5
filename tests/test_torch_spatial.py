"""Spatial audio on the port (webaudio_tpu_torch) against the JAX package,
on the CPU: the listener geometry, the equal-power PannerNode, the HRTF
panning model, the listener's foreign params and batches of panners.

Inputs are made from seeds with numpy and go through both packages.  The
tolerance is the goldens' 1e-5 x peak unless a test states another.  Every
HRTF render also compares the per-quantum grid cells (the HRIR each
quantum picks) with the ones the JAX kernel computes, so a cell that flips
between XLA's and torch's f32 trigonometry is named, not hidden.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import webaudio_tpu as wa
import webaudio_tpu_torch as wt
from webaudio_tpu.nodes import hrtf as jhrtf
from webaudio_tpu.nodes import panner as jpanner
from webaudio_tpu_torch.graph import compiler as tcomp
from webaudio_tpu_torch.nodes import hrtf as thrtf
from webaudio_tpu_torch.nodes import panner as tpanner
from webaudio_tpu_torch.parallel.batch import graph_fingerprint

FS = 44100.0
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens.npz")


def _context(mod, channels, length, fs=FS):
    if mod is wt:
        return wt.OfflineAudioContext(channels, length, fs, device="cpu")
    return wa.OfflineAudioContext(channels, length, fs)


def _assert_close(got, want, rel=1e-5):
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want,
                               atol=rel * max(np.abs(want).max(), 1e-6))


# --- geometry -------------------------------------------------------------

def _geometry(seed, n=2048):
    """Seeded positions, orientations and listener frames, (3, n) f32 each,
    with degenerate rows: the source at the listener (row 0), forward
    parallel to up (row 1), a zero source orientation (row 2), a zero
    forward (row 3) and the source straight above (row 4)."""
    rng = np.random.default_rng(seed)
    sp, lp = (rng.uniform(-4.0, 4.0, (3, n)).astype(np.float32)
              for _ in range(2))
    so, lf, lu = (rng.uniform(-1.0, 1.0, (3, n)).astype(np.float32)
                  for _ in range(3))
    sp[:, 0] = lp[:, 0]
    lf[:, 1], lu[:, 1] = (0.0, 0.0, -1.0), (0.0, 0.0, 2.0)
    so[:, 2] = 0.0
    lf[:, 3] = 0.0
    lp[:, 4], sp[:, 4], lf[:, 4], lu[:, 4] = 0.0, (0.0, 3.0, 0.0), \
        (0.0, 0.0, -1.0), (0.0, 1.0, 0.0)
    return sp, so, lp, lf, lu


def _jnp(v):
    return [jnp.asarray(v[i]) for i in range(3)]


def _torch(v):
    return [torch.from_numpy(v[i]) for i in range(3)]


# torch's and XLA's f32 arccos differ by an ulp; near a cosine of +-1 an
# ulp moves the angle by up to ~2e-3 degrees
ANGLE_ATOL = 5e-3


@pytest.mark.parametrize("seed", range(3))
def test_azimuth_elevation_matches_jax(seed):
    sp, so, lp, lf, lu = _geometry(seed)
    want = jpanner.azimuth_elevation(_jnp(sp), _jnp(lp), _jnp(lf), _jnp(lu))
    got = tpanner.azimuth_elevation(_torch(sp), _torch(lp), _torch(lf),
                                    _torch(lu))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ANGLE_ATOL)
    az, el = (t.numpy() for t in got)
    assert az[0] == el[0] == az[1] == el[1] == 0.0      # the degenerate rows
    assert el[4] == 90.0 and az[4] == 0.0


@pytest.mark.parametrize("seed", range(3))
def test_source_listener_angle_matches_jax(seed):
    sp, so, lp, _, _ = _geometry(seed)
    want = np.asarray(jpanner.source_listener_angle(_jnp(sp), _jnp(so),
                                                    _jnp(lp)))
    got = tpanner.source_listener_angle(_torch(sp), _torch(so),
                                        _torch(lp)).numpy()
    np.testing.assert_allclose(got, want, atol=ANGLE_ATOL)
    assert got[0] == 0.0 and got[2] == 0.0


SETTINGS = [
    dict(distance_model="linear", rolloff_factor=0.7, max_distance=6.0),
    dict(distance_model="linear", rolloff_factor=3.0, ref_distance=3.0,
         max_distance=2.5),
    dict(distance_model="inverse", rolloff_factor=1.5, ref_distance=0.5),
    dict(distance_model="exponential", rolloff_factor=0.8),
    dict(distance_model="inverse", cone_inner_angle=40.0,
         cone_outer_angle=120.0, cone_outer_gain=0.2),
    dict(distance_model="exponential", cone_inner_angle=0.0,
         cone_outer_angle=0.0, cone_outer_gain=0.5),
]


@pytest.mark.parametrize("settings", range(len(SETTINGS)))
def test_spatial_gains_match_jax(settings):
    sp, so, lp, lf, lu = _geometry(settings)
    names = ("position", "orientation", "l_position", "l_forward", "l_up")
    jparams, tparams = {}, {}
    for name, v in zip(names, (sp, so, lp, lf, lu)):
        for i, ax in enumerate("xyz"):
            jparams[f"{name}_{ax}"] = jnp.asarray(v[i])
            tparams[f"{name}_{ax}"] = torch.from_numpy(v[i])
    jnode = _context(wa, 2, 128).create_panner(**SETTINGS[settings])
    tnode = _context(wt, 2, 128).create_panner(**SETTINGS[settings])
    want = jpanner.spatial_gains(jnode, jparams)
    got = tpanner._SpatialKernel(tnode).spatial_gains(tparams)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ANGLE_ATOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-5, atol=1e-7)


# --- the equal-power panner ----------------------------------------------------

def _moving_panner(mod, settings, stereo, length=6000):
    ctx = _context(mod, 2, length, 48000.0)
    o = ctx.create_oscillator(frequency=440.0)
    p = ctx.create_panner(position_x=1.0, position_z=-2.0, **settings)
    p.position_x.linear_ramp_to_value_at_time(-3.0, 0.1)
    p.orientation_z.linear_ramp_to_value_at_time(1.0, 0.12)
    ctx.listener.position_z.linear_ramp_to_value_at_time(2.0, 0.12)
    ctx.listener.forward_x.set_value(0.3)
    if stereo:
        m = ctx.create_channel_merger(2)
        o.connect(m, 0, 0)
        o2 = ctx.create_oscillator(frequency=300.0)
        o2.connect(m, 0, 1)
        o2.start()
        m.connect(p)
    else:
        o.connect(p)
    p.connect(ctx.destination)
    o.start()
    return ctx


@pytest.mark.parametrize("stereo", [False, True])
@pytest.mark.parametrize("settings", range(len(SETTINGS)))
def test_equal_power_render_matches_jax(settings, stereo):
    want = _moving_panner(wa, SETTINGS[settings], stereo) \
        .start_rendering_sync().to_array()
    got = _moving_panner(wt, SETTINGS[settings], stereo) \
        .start_rendering_sync().to_array()
    _assert_close(got, np.asarray(want))
    assert np.abs(got).max() > 0.01


def _doppler(mod, length=22050, rate_ramp=False):
    """examples/doppler.py's graph, 0.5 s: the inverse-distance panner
    moving along y, a delay swept 0.29 -> 0 -> 0.29 s, a looping
    synthetic buffer (bench.py's) in place of siren.mp3."""
    ctx = _context(mod, 2, length)
    seconds = length / FS
    buf = mod.AudioBuffer.from_array(
        np.sin(np.arange(2 * 48000) * 0.03, dtype=np.float32)[None]
        .repeat(2, 0), FS)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = buf
    if rate_ramp:
        src.playback_rate.set_value_at_time(0.8, 0.0)
        src.playback_rate.linear_ramp_to_value_at_time(1.25, seconds)
    panner = ctx.create_panner(
        panning_model="equalpower", distance_model="inverse",
        position_x=0.0, position_y=100.0, position_z=1.0,
        orientation_x=1.0, orientation_y=0.0, orientation_z=0.0,
        ref_distance=1.0, max_distance=10000.0, rolloff_factor=1.0,
        cone_inner_angle=360.0, cone_outer_angle=0.0, cone_outer_gain=0.0)
    panner.position_y.linear_ramp_to_value_at_time(-100.0, seconds)
    delay = ctx.create_delay(max_delay_time=1.0)
    doppler_max = 100.0 / 343.0
    delay.delay_time.set_value_at_time(doppler_max, 0.0)
    delay.delay_time.linear_ramp_to_value_at_time(0.0, seconds / 2)
    delay.delay_time.linear_ramp_to_value_at_time(doppler_max, seconds)
    src.connect(delay)
    delay.connect(panner)
    panner.connect(ctx.destination)
    src.start()
    return ctx


@pytest.mark.parametrize("rate_ramp", [False, True])
def test_doppler_matches_jax(rate_ramp):
    want = np.asarray(_doppler(wa, rate_ramp=rate_ramp)
                      .start_rendering_sync().to_array())
    got = _doppler(wt, rate_ramp=rate_ramp).start_rendering_sync().to_array()
    _assert_close(got, want)
    assert np.abs(got).max() > 0.005


def _geometry64(sp, lp, lf, lu):
    """spatial.rs:205-270 in numpy f64: azimuth in degrees."""
    def unit(v):
        return v / np.linalg.norm(v, axis=0)

    sl, right, fwd = unit(sp - lp), unit(np.cross(lf, lu, axis=0)), unit(lf)
    up = np.cross(right, fwd, axis=0)
    proj = unit(sl - up * np.clip((sl * up).sum(0), -1.0, 1.0))
    az = np.degrees(np.arccos(np.clip((proj * right).sum(0), -1.0, 1.0)))
    az = np.where((proj * fwd).sum(0) < 0.0, 360.0 - az, az)
    return np.where((az >= 0.0) & (az <= 270.0), 90.0 - az, 450.0 - az)


def _ear_gains(az):
    """The equal-power mono-input ear gains (panner.rs:988-1055) in f64."""
    az = np.clip(az, -180.0, 180.0)
    az = np.where(az < -90.0, -180.0 - az, np.where(az > 90.0, 180.0 - az, az))
    xx = (az + 90.0) / 180.0
    return np.stack([np.cos(xx * np.pi / 2), np.sin(xx * np.pi / 2)])


def test_f32_geometry_at_the_ear_axis():
    """The source of tests/test_torch_cuda.py's ear-axis case (x from 2 to
    -4 at z = -1 over 0.5 s, the listener turning to forward (0.5, 0, -1))
    crosses the left ear axis.  There the azimuth is the f32 arccos of a
    cosine within an ulp of -1, so the port's f32 geometry (the
    reference's own arithmetic) departs from an f64 one by hundredths of a
    degree, up to ~2.5e-4 of the far ear's gain: the conditioning that sets
    that CUDA test's 3e-4 x peak between the card and the CPU.  Away from
    the axis the departure stays below 5e-6."""
    n, fs = 24000, 48000.0
    ctx = _context(wt, 2, n, fs)
    p = ctx.create_panner(distance_model="linear", max_distance=20.0,
                          position_x=2.0, position_z=-1.0)
    p.position_x.linear_ramp_to_value_at_time(-4.0, 0.5)
    ctx.listener.forward_x.linear_ramp_to_value_at_time(0.5, 0.4)
    ctx.create_oscillator().connect(p)
    p.connect(ctx.destination)
    cg = tcomp.compile_graph(dict(ctx._nodes), list(ctx._edges), fs, n,
                             ctx._destination.node_id, "cpu")
    vals = {}
    for alias, (nid, pname) in [(a, (p.node_id, a)) for a in p.params] + [
            (a, (src.node_id, q)) for a, (src, q) in p.foreign_params().items()]:
        plan = cg.param_plan[(nid, pname)]
        vals[alias] = (np.full(n, plan.scalar, np.float32) if plan.is_constant
                       else np.asarray(plan.dense[:n], np.float32))
    tvals = {k: torch.from_numpy(v) for k, v in vals.items()}
    az32 = cg.kernels[p.node_id].spatial_gains(tvals)[0].numpy()

    def vec(prefix):
        return np.stack([vals[f"{prefix}_{a}"] for a in "xyz"]).astype(
            np.float64)

    az64 = _geometry64(vec("position"), vec("l_position"), vec("l_forward"),
                       vec("l_up"))
    dep = np.abs(_ear_gains(az32.astype(np.float64)) - _ear_gains(az64)) \
        .max(axis=0)
    at = int(np.argmax(dep))
    assert abs(abs(az64[at]) - 90.0) < 1.0          # on the ear axis
    assert 1e-5 < dep[at] <= 3e-4
    assert dep[np.abs(np.abs(az64) - 90.0) > 5.0].max() < 5e-6


def test_listener_automation_across_a_suspend_matches_jax():
    """The listener's params advance through the context's param-state
    walk across a suspend like any node's: a ramp scheduled in the
    callback starts from where the first segment left the listener."""
    def build(mod):
        ctx = _moving_panner(mod, {}, False, length=9000)

        def turn(c):
            c.listener.position_x.linear_ramp_to_value_at_time(2.5, 0.17)
            c.listener.up_x.set_value_at_time(0.4, 0.12)

        ctx.suspend_sync(0.08, turn)
        return ctx

    want = np.asarray(build(wa).start_rendering_sync().to_array())
    ctx = build(wt)
    got = ctx.start_rendering_sync().to_array()
    assert len(ctx.render_stats["segments"]) == 2
    _assert_close(got, want)
    assert ctx.listener.position_x.value == pytest.approx(2.5)


def test_audio_rate_input_into_a_listener_param_matches_jax():
    """A source driving a listener param with audio is ordered before the
    panner that reads it, even when it was created after the panner (the
    compiler's ordering edges for foreign params)."""
    def build(mod):
        ctx = _context(mod, 2, 4096, 48000.0)
        o = ctx.create_oscillator(frequency=500.0)
        p = ctx.create_panner(position_x=0.5, position_z=-1.0)
        o.connect(p)
        p.connect(ctx.destination)
        lfo = ctx.create_oscillator(frequency=7.0)
        amp = ctx.create_gain(gain=3.0)
        lfo.connect(amp)
        amp.connect(ctx.listener.position_x)
        o.start()
        lfo.start()
        return ctx

    ctx = build(wt)
    cg = tcomp.compile_graph(dict(ctx._nodes), list(ctx._edges), 48000.0,
                             ctx.length, ctx._destination.node_id, "cpu")
    panner_id = [nid for nid, n in ctx._nodes.items()
                 if isinstance(n, tpanner.PannerNode)][0]
    gain_id = [nid for nid, n in ctx._nodes.items()
               if type(n).__name__ == "GainNode"][0]
    order = [v[0] if isinstance(v, tuple) else v for v in cg.order]
    assert order.index(gain_id) < order.index(panner_id)
    want = np.asarray(build(wa).start_rendering_sync().to_array())
    _assert_close(build(wt).start_rendering_sync().to_array(), want)


def test_panner_validation_matches_jax():
    for mod in (wa, wt):
        ctx = _context(mod, 2, 128)
        with pytest.raises(RuntimeError):
            ctx.create_panner(ref_distance=-1.0)
        with pytest.raises(RuntimeError):
            ctx.create_panner(max_distance=0.0)
        with pytest.raises(RuntimeError):
            ctx.create_panner(rolloff_factor=-0.5)
        with pytest.raises(mod.InvalidStateError):
            ctx.create_panner(cone_outer_gain=1.5)
        p = ctx.create_panner()
        with pytest.raises(mod.NotSupportedError):
            p.channel_count = 3
        with pytest.raises(mod.NotSupportedError):
            p.channel_count_mode = "max"
        with pytest.raises(ValueError):
            ctx.create_panner(panning_model="binaural")
        assert p.position_x.value == 0.0 and p.orientation_x.value == 1.0
        assert set(p.foreign_params()) == {
            f"l_{a}_{x}" for a in ("position", "forward", "up") for x in "xyz"}
        lst = ctx.listener
        assert lst is ctx.listener
        assert (lst.forward_z.value, lst.up_y.value) == (-1.0, 1.0)


# --- the HRIR sphere ------------------------------------------------------------

@pytest.mark.parametrize("fs", [44100.0, 48000.0, 22050.0])
def test_sphere_and_grid_equal_jax(fs):
    got = thrtf.load_hrir_sphere(fs)
    want = jhrtf.load_hrir_sphere(fs)
    assert got[3] == want[3]
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    got = thrtf.bake_direction_grid(fs)
    want = jhrtf.bake_direction_grid(fs)
    assert got[2:] == want[2:] == (256, 128)
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    if fs == 44100.0:
        positions, faces, spectra, K = got_sphere = thrtf.load_hrir_sphere(fs)
        assert positions.shape == (187, 3) and spectra.shape == (187, 2, 4, 129)
        assert K == 4 and got_sphere is thrtf.load_hrir_sphere(fs)


# --- HRTF renders ---------------------------------------------------------------

def _quantum_values(cg, nid, node, nq):
    """The panner's own and foreign params on each quantum's first sample,
    from the port's compiled plan: alias -> (nq,) f32."""
    items = [(p, nid, p) for p in node.params]
    items += [(a, src.node_id, p)
              for a, (src, p) in node.foreign_params().items()]
    out = {}
    for alias, pnid, pname in items:
        plan = cg.param_plan[(pnid, pname)]
        if plan.is_constant:
            out[alias] = np.full(nq, plan.scalar, np.float32)
        else:
            out[alias] = np.asarray(plan.dense, np.float32)[::128][:nq]
    return out


def _cells(build):
    """(port cells, JAX cells), each (2, quanta) int: the grid cells the
    port's HRTF kernel picks on a fresh plan of build(wt), and those the
    JAX kernel's expressions (webaudio_tpu/nodes/hrtf.py:197-223, jitted
    as in its render) give on the same param values."""
    ctx = build(wt)
    jctx = build(wa)
    cg = tcomp.compile_graph(dict(ctx._nodes), list(ctx._edges),
                             ctx.sample_rate, ctx.length,
                             ctx._destination.node_id, "cpu")
    (nid,) = [k for k, kern in cg.kernels.items()
              if isinstance(kern, thrtf.HrtfPannerKernel)]
    kern = cg.kernels[nid]
    nq = -(-ctx.length // 128)
    vals = _quantum_values(cg, nid, ctx._nodes[nid], nq)
    dense = {k: torch.from_numpy(np.repeat(v, 128))[None, None]
             for k, v in vals.items()}
    az, el, _ = kern.quantum_directions(dense, 1, nq)
    got = np.stack([t[0].numpy() for t in thrtf.grid_cells(
        az, el, kern.az_bins, kern.el_bins)])

    jnode = jctx._nodes[nid]
    az_bins, el_bins = kern.az_bins, kern.el_bins

    @jax.jit
    def jax_cells(qp):
        azimuth, elevation, _ = jpanner.spatial_gains(jnode, qp)
        a = azimuth * (np.pi / 180.0)
        e = elevation * (np.pi / 180.0)
        az_i = jnp.clip(((a / (2 * np.pi) + 0.5) * az_bins)
                        .astype(jnp.int32), 0, az_bins - 1)
        el_i = jnp.clip(((e / np.pi + 0.5) * el_bins)
                        .astype(jnp.int32), 0, el_bins - 1)
        return az_i, el_i

    want = np.stack([np.asarray(t) for t in jax_cells(
        {k: jnp.asarray(v) for k, v in vals.items()})])
    return got, want


def _check_hrtf(build, rel=1e-5):
    got_cells, want_cells = _cells(build)
    flips = np.nonzero((got_cells != want_cells).any(axis=0))[0]
    assert not len(flips), (
        f"grid cells differ from the JAX kernel's at quanta {flips.tolist()}: "
        f"port {got_cells[:, flips].T.tolist()}, "
        f"JAX {want_cells[:, flips].T.tolist()}")
    want = np.asarray(build(wa).start_rendering_sync().to_array())
    ctx = build(wt)
    got = ctx.start_rendering_sync().to_array()
    _assert_close(got, want, rel)
    assert np.abs(got).max() > 0.01
    return got, ctx, got_cells


def _static(mod):
    """tests/test_goldens.py's hrtf_static graph."""
    ctx = _context(mod, 2, 2048, 48000.0)
    o = ctx.create_oscillator(type="triangle", frequency=220.0)
    p = ctx.create_panner(panning_model="HRTF", position_x=1.0,
                          position_z=-1.0)
    o.connect(p)
    p.connect(ctx.destination)
    o.start()
    return ctx


def test_hrtf_static_golden():
    got, _, cells = _check_hrtf(_static)
    if os.path.exists(GOLDENS):
        with np.load(GOLDENS) as z:
            _assert_close(got, z["hrtf_static"])
    assert len(np.unique(cells, axis=1).T) == 1


def config4(mod, seconds=1.0, fs=FS, channels=1):
    """BASELINE config 4 (benches/suite.py::case_hrtf_moving), cut to
    `seconds`: a 220 Hz sawtooth into an HRTF panner at z = -2 with the
    listener orbiting at radius 3 over 10 s (64 linear ramps a
    coordinate); channels=2 feeds the panner a stereo input."""
    ctx = _context(mod, 2, int(fs * seconds), fs)
    osc = ctx.create_oscillator(type="sawtooth", frequency=220.0)
    p = ctx.create_panner(panning_model="HRTF", position_z=-2.0)
    for t in np.linspace(0, 10.0, 64):
        ang = 2 * np.pi * t / 10.0
        ctx.listener.position_x.linear_ramp_to_value_at_time(
            float(np.sin(ang) * 3), float(t))
        ctx.listener.position_z.linear_ramp_to_value_at_time(
            float(np.cos(ang) * 3), float(t))
    if channels == 2:
        m = ctx.create_channel_merger(2)
        osc.connect(m, 0, 0)
        o2 = ctx.create_oscillator(type="square", frequency=331.0)
        o2.connect(m, 0, 1)
        o2.start()
        m.connect(p)
    else:
        osc.connect(p)
    p.connect(ctx.destination)
    osc.start()
    return ctx


def test_config4_one_second():
    _, ctx, cells = _check_hrtf(config4)
    assert len(np.unique(cells, axis=1).T) > 10      # the listener moves
    cg = tcomp.compile_graph(dict(ctx._nodes), list(ctx._edges), FS,
                             ctx.length, ctx._destination.node_id, "cpu")
    assert [key[0] for key in cg.dense_params] == [ctx.listener.node_id] * 2


def test_config4_plan_at_full_width_is_one_block():
    ctx = config4(wt, seconds=10.0)
    cg = tcomp.compile_graph(dict(ctx._nodes), list(ctx._edges), FS,
                             ctx.length, ctx._destination.node_id, "cpu")
    assert cg.block_frames == 441088
    assert tcomp._pad_len(ctx.length, cg.block_frames) == 441088


def test_hrtf_stereo_input():
    _check_hrtf(lambda mod: config4(mod, seconds=0.5, channels=2))


def test_hrtf_at_48k():
    _check_hrtf(lambda mod: config4(mod, seconds=0.5, fs=48000.0))


def _hrtf_two_blocks(mod, length=48000 * 3 + 77):
    """A lowpass after the HRTF panner makes the plan prefer power-of-two
    blocks, so the render spans two."""
    ctx = config4(mod, seconds=length / 48000.0, fs=48000.0)
    (p,) = [n for n in ctx._nodes.values() if type(n).__name__ == "PannerNode"]
    ctx._edges = [e for e in ctx._edges if e.src != p.node_id]
    f = ctx.create_biquad_filter(frequency=6000.0)
    p.connect(f)
    f.connect(ctx.destination)
    return ctx


def test_hrtf_over_two_blocks():
    _, ctx, _ = _check_hrtf(_hrtf_two_blocks)
    cg = tcomp.compile_graph(dict(ctx._nodes), list(ctx._edges), 48000.0,
                             ctx.length, ctx._destination.node_id, "cpu")
    assert tcomp._pad_len(ctx.length, cg.block_frames) >= 2 * cg.block_frames


def _hrtf_suspended(mod, with_callback=True):
    ctx = config4(mod, seconds=0.4)

    def move(c):
        (p,) = [n for n in c._nodes.values()
                if type(n).__name__ == "PannerNode"]
        p.position_y.set_value_at_time(1.5, 0.2)
        p.position_x.linear_ramp_to_value_at_time(-2.0, 0.35)

    if with_callback:
        ctx.suspend_sync(0.15, move)
    else:
        move(ctx)   # the same timeline, for the grid cells of one plan
    return ctx


def test_hrtf_across_a_suspend():
    want = np.asarray(_hrtf_suspended(wa).start_rendering_sync().to_array())
    ctx = _hrtf_suspended(wt)
    got = ctx.start_rendering_sync().to_array()
    assert len(ctx.render_stats["segments"]) == 2
    _assert_close(got, want)
    got_cells, want_cells = _cells(
        lambda mod: _hrtf_suspended(mod, with_callback=False))
    np.testing.assert_array_equal(got_cells, want_cells)


# --- the properties of tests/test_hrtf.py on the port -------------------------

def _render_hrtf(x_pos, z_pos, fs=44100.0, n=4096):
    ctx = _context(wt, 2, n, fs)
    data = np.zeros((1, n), np.float32)
    data[0, ::512] = 1.0
    bs = ctx.create_buffer_source()
    bs.buffer = wt.AudioBuffer.from_array(data, fs)
    p = ctx.create_panner(panning_model="HRTF", position_x=x_pos,
                          position_z=z_pos)
    bs.connect(p)
    p.connect(ctx.destination)
    bs.start()
    return ctx.start_rendering_sync().to_array()


def _rms(a):
    return np.sqrt((a.astype(np.float64) ** 2).mean())


def test_hrtf_lateralization_and_itd():
    left_src = _render_hrtf(-3.0, 0.0)
    right_src = _render_hrtf(3.0, 0.0)
    assert _rms(left_src[0]) > _rms(left_src[1]) * 1.5
    assert _rms(right_src[1]) > _rms(right_src[0]) * 1.5
    assert _rms(left_src[0]) == pytest.approx(_rms(right_src[1]), rel=0.2)
    l, r = left_src
    thresh = 0.05 * max(np.abs(l).max(), np.abs(r).max())
    assert int(np.argmax(np.abs(l) > thresh)) < int(np.argmax(np.abs(r) > thresh))


def test_hrtf_crossfade_smooths_motion():
    fs = 48000.0
    ctx = _context(wt, 2, 4096, fs)
    o = ctx.create_oscillator(frequency=330.0)
    p = ctx.create_panner(panning_model="HRTF")
    for ti in np.arange(0, 4096 / fs, 128 / fs):
        ang = 2 * np.pi * ti * 20  # 20 rev/s
        p.position_x.set_value_at_time(float(np.sin(ang) * 2), float(ti))
        p.position_z.set_value_at_time(float(np.cos(ang) * 2), float(ti))
    o.connect(p)
    p.connect(ctx.destination)
    o.start()
    out = ctx.start_rendering_sync().to_array()
    assert out[0, 0] == 0.0  # fades in from the crate's initial gain 0
    d = np.abs(np.diff(out[0]))
    boundary = d[127::128]
    within = np.delete(d, np.arange(127, len(d), 128))
    assert boundary.max() < 2.0 * within.max()


def test_hrtf_matches_raw_vertex_hrir():
    """At a vertex direction the output matches numpy convolution with
    that vertex's raw HRIRs, read from the file's bytes (the ~1.4 degree
    grid mixes in a few percent of the neighbours)."""
    import struct

    data = open(thrtf.HRIR_PATH, "rb").read()
    rate, ir_len, n_vert, n_idx = struct.unpack_from("<IIII", data, 4)
    stride = 3 + 2 * ir_len
    verts = np.frombuffer(data, dtype="<f4", count=n_vert * stride,
                          offset=20 + 4 * n_idx).reshape(n_vert, stride)
    positions, left, right = (verts[:, :3], verts[:, 3:3 + ir_len],
                              verts[:, 3 + ir_len:])
    fs = float(rate)
    x = np.random.RandomState(7).randn(4096).astype(np.float32) * 0.3
    for vid in (5, 40, 90, 150):
        out = _render_at_direction(
            positions[vid] / np.linalg.norm(positions[vid]), x, fs)
        seg = slice(128, len(x))
        for ch, ir in ((0, left[vid]), (1, right[vid])):
            a, b = out[ch][seg], np.convolve(x, ir)[:len(x)][seg]
            corr = float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))
            rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
            assert corr > 0.98 and rel < 0.2, (vid, ch, corr, rel)


def _render_at_direction(d, x, fs):
    """x through an HRTF panner at unit direction d in sphere space (az 0
    -> +z; the default listener faces -z), distance 1."""
    ctx = _context(wt, 2, len(x), fs)
    bs = ctx.create_buffer_source()
    bs.buffer = wt.AudioBuffer.from_array(x[None].astype(np.float32), fs)
    p = ctx.create_panner(panning_model="HRTF", position_x=float(d[0]),
                          position_y=float(d[1]), position_z=float(-d[2]))
    bs.connect(p)
    p.connect(ctx.destination)
    bs.start()
    return ctx.start_rendering_sync().to_array()


def test_hrtf_fdl_machinery_is_exact():
    """The per-quantum FDL and crossfade equal numpy convolution with the
    kernel's own barycentric-interpolated IR at a fixed direction, to f32
    accuracy (tests/test_hrtf.py's bound, 2e-4)."""
    positions, faces, spectra, K = thrtf.load_hrir_sphere(FS)
    vids_grid, w_grid, az_bins, el_bins = thrtf.bake_direction_grid(FS)
    d = np.array([0.6, 0.25, 0.76])
    d /= np.linalg.norm(d)
    az, el = np.arctan2(d[0], d[2]), np.arcsin(d[1])
    az_i = min(max(int((az / (2 * np.pi) + 0.5) * az_bins), 0), az_bins - 1)
    el_i = min(max(int((el / np.pi + 0.5) * el_bins), 0), el_bins - 1)
    part = np.fft.irfft(spectra[vids_grid[az_i, el_i]], axis=-1)[..., :128]
    ir = np.einsum("v,vekp->ekp", w_grid[az_i, el_i], part).reshape(2, -1)
    x = np.random.RandomState(3).randn(4096).astype(np.float32) * 0.5
    out = _render_at_direction(d, x, FS)
    for ch in range(2):
        np.testing.assert_allclose(out[ch][128:],
                                   np.convolve(x, ir[ch])[:4096][128:],
                                   atol=2e-4)


def test_hrtf_matches_measured_hrirs_per_octant():
    """At the measured vertex deepest inside each octant, an impulse in the
    second quantum renders the raw HRIR of IRC_1003_C.bin (normalized
    cross-correlation >= 0.95 a ear, peak lag within one sample, the
    interaural delay within two): tests/test_hrtf.py's anchor on the port."""
    import struct

    data = open(thrtf.HRIR_PATH, "rb").read()
    rate, ir_len, n_vert, n_idx = struct.unpack_from("<IIII", data, 4)
    stride = 3 + 2 * ir_len
    verts = np.frombuffer(data, dtype="<f4", count=n_vert * stride,
                          offset=20 + 4 * n_idx).reshape(n_vert, stride)
    unit = verts[:, :3] / np.linalg.norm(verts[:, :3], axis=1, keepdims=True)
    octants = {}
    for i, p in enumerate(unit):
        key = (p[0] >= 0, p[1] >= 0, p[2] >= 0)
        if key not in octants or np.min(np.abs(p)) > octants[key][0]:
            octants[key] = (np.min(np.abs(p)), i)
    assert len(octants) == 8

    def lag(a, b):
        n = len(a) + len(b) - 1
        c = np.fft.irfft(np.fft.rfft(a, n) * np.conj(np.fft.rfft(b, n)), n)
        return int(np.fft.fftfreq(n, 1.0 / n).astype(int)[np.argmax(np.abs(c))])

    x = np.zeros(1024, np.float32)
    x[128] = 1.0
    for _, i in octants.values():
        out = _render_at_direction(unit[i], x, float(rate))
        got = out[:, 128:128 + ir_len]
        refs = (verts[i, 3:3 + ir_len], verts[i, 3 + ir_len:])
        for g, ref in zip(got, refs):
            xc = np.correlate(g, ref, mode="full") / (
                np.linalg.norm(g) * np.linalg.norm(ref))
            assert xc.max() >= 0.95 and abs(int(np.argmax(xc)) - (ir_len - 1)) <= 1
        assert abs(lag(*got) - lag(*refs)) <= 2


# --- batches ------------------------------------------------------------------

def _corpus_context(mod, length=8192, model="HRTF"):
    """A looping buffer through a panner whose listener orbits (dense
    listener rows), the binaural corpus's graph at a small size."""
    ctx = _context(mod, 2, length)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = mod.AudioBuffer.from_array(
        np.sin(np.arange(3000) * 0.05, dtype=np.float32)[None], FS)
    p = ctx.create_panner(panning_model=model, position_z=-1.5)
    ctx.listener.position_x.linear_ramp_to_value_at_time(2.0, length / FS)
    ctx.listener.position_z.linear_ramp_to_value_at_time(-3.0, length / FS)
    src.connect(p)
    p.connect(ctx.destination)
    src.start()
    return ctx, src


def _orbits(n, length, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(length) / FS
    ph = rng.uniform(0, 2 * np.pi, (n, 1))
    speed = rng.uniform(0.5, 3.0, (n, 1))
    return ((2.0 * np.sin(ph + speed * t)).astype(np.float32),
            (2.0 * np.cos(ph + speed * t)).astype(np.float32))


@pytest.mark.parametrize("model", ["HRTF", "equalpower"])
def test_batch_lanes_equal_their_own_renders(model):
    """Per-instance clips and listener orbits: override_param reaches the
    listener's dense rows, and each lane equals its own render (1e-6 x
    peak) and the JAX package's batch lane (1e-5 x peak)."""
    n, length = 3, 8192
    px, pz = _orbits(n, length, 5)
    clips = np.random.default_rng(6).uniform(-0.8, 0.8, (n, 1, 3000)) \
        .astype(np.float32)
    batches = {}
    for mod in (wt, wa):
        ctx, src = _corpus_context(mod, length, model)
        gb = mod.GraphBatch(ctx, batch=n)
        gb.override_param(ctx.listener, "position_x", px)
        gb.override_param(ctx.listener, "position_z", pz)
        gb.override_buffer(src, clips)
        batches[mod] = np.asarray(gb.render())[..., :length]
    out = batches[wt]
    _assert_close(out, batches[wa])
    for i in range(n):
        ctx, src = _corpus_context(wt, length, model)
        ctx.listener.position_x.set_value_curve_at_time(px[i], 0.0,
                                                        length / FS)
        gb1 = wt.GraphBatch(ctx, batch=1)
        gb1.override_param(ctx.listener, "position_x", px[i:i + 1])
        gb1.override_param(ctx.listener, "position_z", pz[i:i + 1])
        gb1.override_buffer(src, clips[i:i + 1])
        _assert_close(out[i], gb1.render().numpy()[0, :, :length], 1e-6)
    assert not np.allclose(out[0], out[1])


def test_batch_lane_without_overrides_equals_the_context_render():
    ctx, _ = _corpus_context(wt)
    gb = wt.GraphBatch(ctx, batch=2)
    out = gb.render().numpy()[..., :ctx.length]
    own = _corpus_context(wt)[0].start_rendering_sync().to_array()
    _assert_close(out[0], own, 1e-6)
    _assert_close(out[1], own, 1e-6)


def _mixed_member(model, distance_model="inverse", cone=360.0, x=1.0):
    ctx = _context(wt, 2, 2048, 48000.0)
    o = ctx.create_oscillator(frequency=300.0)
    p = ctx.create_panner(panning_model=model, distance_model=distance_model,
                          cone_inner_angle=cone, cone_outer_angle=cone,
                          position_z=-1.0)
    # dense rows, so members that differ only there share a bucket
    p.position_x.linear_ramp_to_value_at_time(x, 2048 / 48000.0)
    o.connect(p)
    p.connect(ctx.destination)
    o.start()
    return ctx


def test_mixed_batch_buckets_panners_by_their_settings():
    """Panners that differ in distance model or cone land in different
    buckets (the kernel copies the settings, so the fingerprint sees
    them); every output equals its own render."""
    members = [_mixed_member("equalpower"), _mixed_member("equalpower", x=2.0),
               _mixed_member("equalpower", "linear"),
               _mixed_member("equalpower", cone=90.0),
               _mixed_member("HRTF"), _mixed_member("HRTF", "exponential")]
    mb = wt.GraphBatch.from_contexts(members)
    assert mb.num_buckets == 5
    outs = mb.render()
    args = [("equalpower",), ("equalpower", "inverse", 360.0, 2.0),
            ("equalpower", "linear"), ("equalpower", "inverse", 90.0),
            ("HRTF",), ("HRTF", "exponential")]
    for out, a in zip(outs, args):
        own = _mixed_member(*a).start_rendering_sync().to_array()
        _assert_close(out, own, 1e-6)


def test_fingerprint_sees_the_panner_settings():
    def fp(**kw):
        ctx = _context(wt, 2, 1024)
        o = ctx.create_oscillator()
        p = ctx.create_panner(**kw)
        o.connect(p)
        p.connect(ctx.destination)
        return graph_fingerprint(tcomp.compile_graph(
            dict(ctx._nodes), list(ctx._edges), FS, 1024,
            ctx._destination.node_id, "cpu"))

    base = fp()
    assert fp() == base
    for kw in (dict(distance_model="linear"), dict(ref_distance=2.0),
               dict(max_distance=50.0), dict(rolloff_factor=0.5),
               dict(cone_inner_angle=10.0), dict(cone_outer_angle=20.0),
               dict(cone_outer_gain=0.5), dict(panning_model="HRTF")):
        assert fp(**kw) != base, kw
