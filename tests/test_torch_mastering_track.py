"""BASELINE config 5 on one whole song (the benchmark's `mastering.bounce`
cell) on the port, against the plain PyTorch reference
`wabench/reference/mastering_track.py`, on the CPU.

- The port's render of a 0.5 s seeded track, in one block and forced into
  two, against the reference rounded to float32 after every operation
  within 1e-6 x peak (the port computes in f32 and reads ~2e-7 off it),
  and against the float64 reference within 3e-5 x peak: the reference
  rounded to float32 reads 0.7-1.4e-5 x peak off its own float64 result
  on these tracks (the detector's roundings, carried over the release's
  12,000-sample time constant), so the renders' 1e-5 rule for two f32
  programs (`test_torch_mastering.py`) is under float32's own floor here.
  The detector is the card's (`WEBAUDIO_DETECTOR=seq`, its plain version
  here); the CPU's default chunked detector solves 128-sample chunks in
  f32 and reads up to ~3.5e-4 x peak on these tracks.
- The reference's pieces against independent forms within 1e-12: its
  blocked polyphase FIRs against a direct filter of the zero-stuffed
  signal, its roundings against `reference/precision.py`'s, and the whole
  of it against the NumPy reference of config 5 (`reference/mastering.py`).
- The full-size plan (11,520,000 frames: two blocks of 5,760,000), the
  `render.resources` span, and the reference's imports.
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import webaudio_tpu_torch as wt
from wabench.configs import mastering_track as mt
from wabench.reference import mastering as np_ref
from wabench.reference import mastering_track as ref
from wabench.reference.precision import rounder as np_rounder
from webaudio_tpu_torch.graph import compiler

ROOT = Path(__file__).resolve().parents[1]
CFG = json.loads((ROOT / "wabench/configs/mastering_track.json").read_text())
TINY = dict(CFG, **CFG["tiny"])
FS = CFG["sample_rate"]
SETTINGS = {"drive": np.array([3.5]), "threshold": np.array([-20.0]),
            "ratio": np.array([6.0])}


def _tracks(seed=24, cfg=TINY):
    return mt.inputs(cfg, np.random.default_rng([seed, 1]))


def _context(inputs, clip=0, cfg=TINY, settings=SETTINGS, frames=None):
    frames = frames or mt.buffer_frames(cfg)
    audio = mt.prepare(wt, cfg, *inputs["clips"][clip])
    one = {k: v[0] for k, v in settings.items()}
    return mt.build(wt, cfg, inputs, "cpu", frames, audio, one, batch=False)


def _close(got, want, rel):
    assert got.shape == want.shape and np.isfinite(got).all()
    peak = float(np.abs(want).max())
    assert np.abs(got - want).max() <= rel * peak, \
        np.abs(got - want).max() / peak


@pytest.mark.parametrize("seed,clip", [(24, 0), (24, 1), (2**31 + 9, 0)])
@pytest.mark.parametrize("blocks", [1, 2])
def test_port_render_matches_the_reference(blocks, seed, clip, monkeypatch):
    """One block, and two with the compressor's detector, lookahead ring
    and the oversampler's FIR histories carried across the boundary."""
    monkeypatch.setenv("WEBAUDIO_DETECTOR", "seq")
    if blocks > 1:
        # 188 quanta under a cap of 128: two blocks of 94
        monkeypatch.setattr(compiler, "_budget_quanta", lambda nodes: 64)
    inputs = _tracks(seed)
    ctx, _ = _context(inputs, clip)
    out = ctx.start_rendering_sync().to_array()
    segments = ctx.render_stats["segments"]
    assert len(segments) == 1 and not segments[0]["failed"]
    frames = ctx.length
    bf = segments[0]["block_frames"]
    assert -(-frames // bf) == blocks
    if blocks > 1:
        assert bf == 94 * 128
    for precision, rel in (("float32", 1e-6), ("float64", 3e-5)):
        want = mt.reference(TINY, inputs, [inputs["clips"][clip]], SETTINGS,
                            frames, precision)[0]
        _close(out, want, rel)


def test_two_blocks_equal_one_block_closely(monkeypatch):
    """The forced two-block walk against the uncut one: the carry alone."""
    monkeypatch.setenv("WEBAUDIO_DETECTOR", "seq")
    inputs = _tracks(7)
    one = _context(inputs)[0].start_rendering_sync().to_array()
    monkeypatch.setattr(compiler, "_budget_quanta", lambda nodes: 64)
    ctx, _ = _context(inputs)
    two = ctx.start_rendering_sync().to_array()
    assert ctx.render_stats["segments"][0]["block_frames"] == 94 * 128
    _close(two, one, 1e-6)


def test_full_size_plan_is_two_blocks():
    """compile_graph at the cell's 11,520,000 frames, no render: two eager
    blocks of 5,760,000 (45,000 quanta under the 2^25-frame budget)."""
    frames = mt.buffer_frames(CFG)
    assert frames == 11_520_000
    audio = np.zeros((2, frames), np.float32)
    one = {"drive": 2.0, "threshold": -18.0, "ratio": 4.0}
    ctx, _ = mt.build(wt, CFG, {}, "cpu", frames, audio, one, batch=False)
    cg = compiler.compile_graph(dict(ctx._nodes), list(ctx._edges),
                                ctx.sample_rate, ctx.length,
                                ctx._destination.node_id, "cpu")
    assert cg.block_frames == 5_760_000
    assert frames // cg.block_frames == 2


@pytest.mark.parametrize("suspends", [0, 1])
def test_render_resources_span_once_a_segment(suspends):
    """`render.resources` wraps the resource staging of each segment's
    plan, inside its `render.stage`."""
    ctx, _ = _context(_tracks(3))
    if suspends:
        ctx.suspend_sync(0.25, lambda c: None)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ctx.start_rendering_sync()
    got = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith("webaudio.render."):
            s = ev.start_ns()
            got.setdefault(ev.name(), []).append((s, s + ev.duration_ns()))
    res, stage = got["webaudio.render.resources"], got["webaudio.render.stage"]
    assert len(res) == len(stage) == 1 + suspends
    assert all(a[0] <= b[0] and b[1] <= a[1] for a, b in zip(stage, res))


def test_blocked_firs_match_the_direct_filter():
    """The up pass's phases and the down pass's kept outputs, in blocks
    that split frames and a last block padded, against scipy's direct
    filter of the zero-stuffed signal, within 1e-12."""
    from scipy.signal import lfilter

    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 5000))
    h = np_ref.taps()
    up = np.zeros((2, 4 * x.shape[1]))
    up[:, ::4] = x
    up = lfilter(h, [1.0], up, axis=-1)
    curve = mt.curve(TINY, 3.0).astype(np.float64)
    want = lfilter(h / 4, [1.0], np_ref.shape(
        up[None], curve[None], lambda v: v)[0], axis=-1)[:, ::4]
    q = ref.rounder("float64")
    up_mat, _ = ref._fir_matrices(q, q)
    got_up = ref.upsample_block(torch.from_numpy(x[:, :4992]),
                                torch.zeros((2, 48), dtype=torch.float64),
                                up_mat, q, q)
    assert np.abs(got_up.numpy() - up[:, :4 * 4992]).max() <= 1e-12
    for block in (1000, 4096, 1 << 16):
        got = ref.oversampled_shape(torch.from_numpy(x),
                                    torch.from_numpy(curve), q, block=block)
        assert np.abs(got.numpy() - want).max() <= 1e-12, block


@pytest.mark.parametrize("name", ["float32", "tfloat32"])
def test_roundings_match_the_numpy_reference(name):
    """The tensor and the scalar roundings against `precision.rounder`,
    ties and double roundings through float32 included."""
    rng = np.random.default_rng(5)
    v = np.concatenate([
        rng.standard_normal(4000) * 10.0 ** rng.uniform(-30, 5, 4000),
        [0.0, 1.5, -2.5, 1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-24,
         1.0 + 2**-12 + 2**-30, -(1.0 + 3 * 2**-9)]])
    want = np_rounder(name)(v)
    got = ref.rounder(name)(torch.from_numpy(v)).numpy()
    assert np.array_equal(got, want)
    q = ref.scalar_rounder(name)
    assert np.array_equal(np.array([q(float(x)) for x in v]), want)
    assert ref.scalar_rounder("float64") is None


@pytest.mark.parametrize("precision", ["float64", "float32", "tfloat32",
                                       "float32,fir=tfloat32"])
def test_reference_matches_the_numpy_reference(precision):
    """Two plain references of one chain agree: within 1e-12 x peak at
    float64; at a rounded precision each rounds the same operations, so
    they differ only where a sum's order moves a rounding (1e-6)."""
    inputs = _tracks(31)
    clip, rate = inputs["clips"][1]
    n = clip.shape[1]
    got = mt.reference(TINY, inputs, [(clip, rate)], SETTINGS, n,
                       precision)[0]
    want = np_ref.render(clip[None].astype(np.float64),
                         mt.curve(TINY, 3.5)[None].astype(np.float64),
                         SETTINGS["threshold"], SETTINGS["ratio"], FS,
                         precision, knee=CFG["knee_db"],
                         attack=CFG["attack_s"], release=CFG["release_s"])[0]
    _close(got, want, 1e-12 if precision == "float64" else 1e-6)


def test_tracks_are_seeded_and_sound():
    a, b = _tracks(9)["clips"], _tracks(9)["clips"]
    c = _tracks(10)["clips"]
    assert len(a) == TINY["clip_pool"]
    assert all(np.array_equal(x, y) for (x, _), (y, _) in zip(a, b))
    assert not any(np.array_equal(x, y) for (x, _), (y, _) in zip(a, c))
    for x, rate in a:
        assert rate == FS and x.shape == (2, mt.buffer_frames(TINY))
        assert x.dtype == np.float32 and 0.05 < np.abs(x).max() < 1.5


def test_partials_match_their_direct_sum():
    f, amp, phase = np.array([55.0, 1234.5, 1999.0]), \
        np.array([0.2, 0.5, 0.3]), np.array([0.1, 0.7, 0.0])
    n = 10_007
    t = np.arange(n) / FS
    want = sum(a * np.sin(2 * np.pi * (fi * t + p))
               for fi, a, p in zip(f, amp, phase))
    assert np.abs(mt._partials(f, amp, phase, n, FS, width=512)
                  - want).max() <= 1e-11


def test_reference_imports_nothing_of_either_package():
    src = (ROOT / "wabench/reference/mastering_track.py").read_text()
    names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "array", "math", "numpy", "torch"}, names
    assert not names & {"jax", "jaxlib", "webaudio_tpu",
                        "webaudio_tpu_torch"}
