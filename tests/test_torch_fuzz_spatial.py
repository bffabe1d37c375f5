"""Whole-graph differential fuzz of spatial, dynamics and shaping chains on
the port (webaudio_tpu_torch), on the CPU.

tests/test_graph_fuzz_spatial.py's random soups (StereoPannerNode with
a-rate pan automation, the equal-power PannerNode at a static 3-D position
under all three distance models, the WaveShaperNode without oversampling,
the DynamicsCompressorNode), built from the same seeds, rendered by the
port and held to the same independent f64 numpy oracle at the same
bounds: 1.5e-3 x peak with a compressor in the graph (its f32 chunked
detector against the sequential f64 recurrence), 7e-5 x peak without.
"""

import numpy as np
import pytest

import webaudio_tpu_torch as wt

from test_graph_fuzz_oracle import _automation_values, _frame_time
from test_graph_fuzz_spatial import (
    FS, _oracle_compressor, _oracle_panner_equalpower, _oracle_stereo_pan,
    _oracle_waveshaper,
)


def _build_random_pair(seed: int):
    """test_graph_fuzz_spatial.py::_build_random_pair on the port: the same
    random draws in the same order, so the graph and its oracle are the
    JAX suite's."""
    rng = np.random.RandomState(1000 + seed)
    length = int(rng.randint(1500, 6000))
    ctx = wt.OfflineAudioContext(2, length, FS, device="cpu")
    has_compressor = False

    def rand_events(hi, lo=0.0):
        events, t_prev = [], 0
        for _ in range(rng.randint(0, 4)):
            f = t_prev + int(rng.randint(1, max(2, length // 3)))
            if f >= length:
                break
            events.append(("set" if rng.rand() < 0.4 else "ramp",
                           _frame_time(f), float(rng.uniform(lo, hi))))
            t_prev = f
        return events

    def apply_events(param, events):
        if not events:
            return
        param.set_value_at_time(param.value, 0.0)
        for kind, t, v in events:
            if kind == "set":
                param.set_value_at_time(v, t)
            else:
                param.linear_ramp_to_value_at_time(v, t)

    n_chains = rng.randint(2, 5)
    acc = np.zeros((2, length), np.float64)
    for _ in range(n_chains):
        sf = int(rng.randint(0, length // 2))
        stopf = int(rng.randint(sf + 1, length)) \
            if rng.rand() < 0.5 else length + 1000
        if rng.rand() < 0.5:
            offset = float(rng.uniform(-1.0, 1.0))
            node = ctx.create_constant_source(offset=offset)
            sig = np.full(length, offset, np.float64)
        else:
            freq = float(rng.uniform(30.0, 4000.0))
            node = ctx.create_oscillator(type="sine", frequency=freq)
            n = np.arange(length, dtype=np.float64)
            sig = np.sin(2.0 * np.pi * np.mod((n - sf) * (freq / FS), 1.0))
        mask = np.zeros(length, bool)
        mask[sf:min(stopf, length)] = True
        sig = np.where(mask, sig, 0.0)
        node.start(_frame_time(sf))
        if stopf <= length:
            node.stop(_frame_time(stopf))

        for _ in range(rng.randint(0, 3)):
            pickk = rng.randint(3)
            if pickk == 0:
                g0 = float(rng.uniform(0.1, 1.2))
                g = ctx.create_gain(gain=g0)
                events = rand_events(1.5)
                apply_events(g.gain, events)
                node.connect(g)
                node = g
                sig = sig * _automation_values(g0, events, length)
            elif pickk == 1:
                ncurve = int(rng.randint(2, 9))
                curve = rng.uniform(-1.0, 1.0, ncurve).astype(np.float32)
                w = ctx.create_wave_shaper(oversample="none")
                w.set_curve(curve)
                node.connect(w)
                node = w
                sig = _oracle_waveshaper(curve, sig)
            else:
                has_compressor = True
                thr = float(rng.uniform(-40.0, -5.0))
                rat = float(rng.uniform(1.5, 15.0))
                kn = float(rng.uniform(0.0, 30.0))
                att = float(rng.choice([0.0, 0.003, 0.03, 0.0002]))
                rel = float(rng.uniform(0.05, 0.4))
                comp = ctx.create_dynamics_compressor(
                    threshold=thr, ratio=rat, knee=kn,
                    attack=att, release=rel)
                node.connect(comp)
                node = comp
                sig = _oracle_compressor(sig, thr, rat, kn, att, rel)

        choice = rng.randint(3)
        if choice == 0:
            pan0 = float(rng.uniform(-1.0, 1.0))
            sp = ctx.create_stereo_panner(pan=pan0)
            events = rand_events(1.0, lo=-1.0)
            apply_events(sp.pan, events)
            node.connect(sp)
            node = sp
            st = _oracle_stereo_pan(
                sig, _automation_values(pan0, events, length))
        elif choice == 1:
            pos = rng.uniform(-4.0, 4.0, 3)
            while np.linalg.norm(pos) < 0.2:
                pos = rng.uniform(-4.0, 4.0, 3)
            model = ["linear", "inverse", "exponential"][rng.randint(3)]
            ro = float(rng.uniform(0.0, 2.0))
            p = ctx.create_panner(
                panning_model="equalpower", distance_model=model,
                position_x=float(pos[0]), position_y=float(pos[1]),
                position_z=float(pos[2]), rolloff_factor=ro)
            node.connect(p)
            node = p
            st = _oracle_panner_equalpower(sig, pos, model, 1.0, 10000.0, ro)
        else:
            st = np.stack([sig, sig])

        node.connect(ctx.destination)
        acc += st

    return ctx, acc.astype(np.float32), has_compressor


@pytest.mark.parametrize("seed", range(12))
def test_spatial_dynamics_soup_matches_oracle(seed):
    ctx, ref, has_compressor = _build_random_pair(seed)
    got = ctx.start_rendering_sync().to_array()
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-3)
    atol = (1.5e-3 if has_compressor else 7e-5) * scale
    np.testing.assert_allclose(
        got, ref, atol=atol, rtol=0,
        err_msg=f"spatial/dynamics fuzz diverged on the port (seed {seed})")


def test_panner_chains_occur():
    """The seeds exercise the equal-power panner (the point of porting
    this fuzz with the spatial slice)."""
    from webaudio_tpu_torch.nodes.panner import PannerNode

    panners = sum(isinstance(n, PannerNode)
                  for seed in range(12)
                  for n in _build_random_pair(seed)[0]._nodes.values())
    assert panners >= 5
