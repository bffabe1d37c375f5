"""The buffer source's automated-rate (cumsum) playhead on the port
(webaudio_tpu_torch) against the JAX package, on the CPU.

An automated playback_rate or detune makes the playhead an exclusive
masked cumsum of the per-sample increments (an f32 cumsum within each
quantum in XLA's order, f64 sums across quanta) carried across blocks.
Every case renders synthetic buffers made from a seed through both
packages and holds the port to 1e-5 x peak; the cumsum itself is held to
the JAX package's to 1e-13 relative: its f32 part runs in XLA's order (an
f32 cumsum in another order would be ~1e-7 off), and only the f64 sums
of each quantum may round apart.

The graphs are tests/playhead_cases.py's; tests/playhead_jax.npz keeps the
JAX package's renders of them for machines without JAX (the card's tests
in tests/test_torch_playhead_kernel.py), and the last test here holds it to
JAX's renders.  Regenerate it with
`JAX_PLATFORMS=cpu python tests/test_torch_playhead.py --regen`.
"""

import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import webaudio_tpu as wa
import webaudio_tpu_torch as wt
from webaudio_tpu.graph import compiler as jcomp
from webaudio_tpu.nodes import buffer_source as jbs
from webaudio_tpu_torch.graph import compiler as tcomp
from webaudio_tpu_torch.nodes import buffer_source as tbs

import playhead_cases as cases

FS = cases.FS


def _context(mod, channels, length, fs=FS):
    return cases.context(mod, channels, length, fs)


def _assert_close(got, want, rel=1e-5):
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want,
                               atol=rel * max(np.abs(want).max(), 1e-6))


_data = cases.data
_source = cases.source


def _render_both(graph_fn, *args, rel=1e-5):
    want = np.asarray(graph_fn(wa, *args).start_rendering_sync().to_array())
    ctx = graph_fn(wt, *args)
    got = ctx.start_rendering_sync().to_array()
    _assert_close(got, want, rel)
    return got, want, ctx


@pytest.mark.parametrize("seed", range(3))
def test_masked_cumsum_equals_jax(seed):
    rng = np.random.default_rng(seed)
    B = 1024
    vals = rng.uniform(-2.0, 3.0, B)
    mask = rng.uniform(size=B) > 0.2
    want, want_total = jbs._masked_cumsum_f64(jnp.asarray(vals),
                                              jnp.asarray(mask))
    got, total = tbs._masked_cumsum_f64(torch.from_numpy(vals)[None],
                                        torch.from_numpy(mask))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-13,
                               atol=1e-13)
    np.testing.assert_allclose(float(total[0]), float(want_total),
                               rtol=1e-13)


# --- automation of the rate --------------------------------------------------

_automated = cases.automated


@pytest.mark.parametrize("case", cases.AUTOMATED)
def test_automated_rate_matches_jax(case):
    got, _, _ = _render_both(_automated, case)
    assert np.abs(got).max() > 0.1
    # the cumsum playhead runs (the closed form needs a constant rate)
    ctx = _automated(wt, case)
    cg = tcomp.compile_graph(dict(ctx._nodes), list(ctx._edges), FS,
                             ctx.length, ctx._destination.node_id, "cpu")
    (src,) = [k for k in cg.kernels.values()
              if isinstance(k, tbs._BufferSourceKernel)]
    assert src.const_rate is None and src.read_mode == "gather"


_looped = cases.looped


@pytest.mark.parametrize("args", cases.LOOPED)
def test_loops_start_and_duration_match_jax(args):
    _render_both(_looped, *args)


_one_shot = cases.one_shot


@pytest.mark.parametrize("args", cases.ONE_SHOT)
def test_one_shot_end_of_buffer_matches_jax(args):
    _render_both(_one_shot, *args)


# --- blocks and suspends ------------------------------------------------------

_two_blocks = cases.two_blocks


def _reference_wrap(pos, ls, le, loop_len):
    """The JAX package's loop wrap with the reference's `almost::equal`
    tolerance: sqrt(eps) relative to the compared values, so to loop_end
    (the port's), where the JAX package scales it by the unwrapped
    playhead."""
    wrapped = ls + jnp.mod(pos - ls, loop_len)
    return jnp.where(le - wrapped <= 1.5e-8 * max(abs(le), 1.0), ls, wrapped)


def test_render_over_two_blocks_matches_jax(monkeypatch):
    """A read at frame 106,334 lands 1.75e-3 samples short of loop_end
    (7,938): within the JAX package's tolerance, 1.5e-8 x its unwrapped
    playhead (over 1.2e5 samples there), outside the reference's, 1.5e-8
    x loop_end = 1.2e-4.  The JAX package is held to the reference's
    tolerance here, as the port is."""
    monkeypatch.setattr(jbs, "_loop_wrap", _reference_wrap)
    _, _, ctx = _render_both(_two_blocks)
    cg = tcomp.compile_graph(dict(ctx._nodes), list(ctx._edges), FS,
                             ctx.length, ctx._destination.node_id, "cpu")
    assert tcomp._pad_len(ctx.length, cg.block_frames) >= 2 * cg.block_frames


_suspended = cases.suspended


def test_render_across_a_suspend_matches_jax():
    got, _, ctx = _render_both(_suspended)
    assert len(ctx.render_stats["segments"]) == 2
    jctx = _suspended(wa)
    jctx.start_rendering_sync()
    jsrc = [n for n in jctx._nodes.values() if hasattr(n, "playback_rate")][0]
    tsrc = [n for n in ctx._nodes.values() if hasattr(n, "playback_rate")][0]
    assert tsrc.position == pytest.approx(jsrc.position, abs=1e-9)


def test_batch_lanes_with_their_own_rate_rows():
    """Each instance of a GraphBatch carries its own rate row, so each
    has its own playhead; every lane equals its own render."""
    length, n = 4096, 3
    rows = np.stack([np.linspace(r0, r1, length, dtype=np.float32)
                     for r0, r1 in ((0.5, 2.0), (1.0, -1.0), (1.7, 0.9))])

    def build(mod, row=None):
        ctx = _context(mod, 2, length)
        src = _source(mod, ctx, _data(2, 1500, 17), FS, loop=True)
        if row is None:
            src.playback_rate.linear_ramp_to_value_at_time(2.0, 0.05)
        else:
            src.playback_rate.set_value_curve_at_time(row, 0.0, length / FS)
        src.connect(ctx.destination)
        src.start()
        return ctx, src

    ctx, src = build(wt)
    gb = wt.GraphBatch(ctx, batch=n)
    gb.override_param(src, "playback_rate", rows)
    out = gb.render().numpy()[..., :length]
    for i in range(n):
        own_ctx, own = build(wt)
        gb1 = wt.GraphBatch(own_ctx, batch=1)
        gb1.override_param(own, "playback_rate", rows[i:i + 1])
        own_out = gb1.render().numpy()[0, :, :length]
        _assert_close(out[i], own_out, 1e-6)
        jctx, jsrc = build(wa)
        jgb = wa.GraphBatch(jctx, batch=1)
        jgb.override_param(jsrc, "playback_rate", rows[i:i + 1])
        _assert_close(out[i], np.asarray(jgb.render())[0, :, :length])


# --- port-side copies of JAX tests that automate the rate --------------------

def test_krate_automation_with_unaligned_length():
    """tests/test_offline.py::test_krate_automation_with_unaligned_length
    on the port, held to the JAX render."""
    def build(mod):
        ctx = _context(mod, 1, 1000, 44100.0)
        src = _source(mod, ctx, np.ones((1, 1000), np.float32), 44100.0)
        src.playback_rate.set_value_at_time(2.0, 0.01)  # a k-rate event
        src.connect(ctx.destination)
        src.start()
        return ctx

    got, _, _ = _render_both(build)
    assert np.isfinite(got).all()


def test_looping_or_automated_buffer_sources_not_fused(monkeypatch):
    """tests/test_fusion.py::test_looping_or_automated_buffer_sources_not_fused
    on the port: loops and automated rates stay unfused, and the render
    equals JAX's."""
    monkeypatch.setenv("WEBAUDIO_FUSE_THRESHOLD", "4")

    def build(mod):
        ctx = _context(mod, 1, 2048)
        sample = mod.AudioBuffer.from_array(np.ones((1, 1000), np.float32), FS)
        for i in range(6):
            src = ctx.create_buffer_source(loop=(i % 2 == 0))
            src.buffer = sample
            if i % 2 == 1:
                src.playback_rate.linear_ramp_to_value_at_time(2.0, 0.02)
            src.connect(ctx.destination)
            src.start()
        return ctx

    ctx = build(wt)
    cg = tcomp.compile_graph(dict(ctx._nodes), list(ctx._edges), FS,
                             ctx.length, ctx._destination.node_id, "cpu")
    jctx = build(wa)
    jcg = jcomp.compile_graph(dict(jctx._nodes), list(jctx._edges), FS,
                              jctx.length, jctx._destination.node_id)
    assert not any(nid < 0 for nid in cg.kernels)
    assert sorted(cg.kernels) == sorted(jcg.kernels)
    _render_both(build)


# --- the kept JAX renders -------------------------------------------------------

def _jax_render(name):
    """The JAX package's render of a case of tests/playhead_cases.py and
    its playhead after it; the two-block case with the reference's loop
    tolerance, as test_render_over_two_blocks_matches_jax holds it."""
    saved = jbs._loop_wrap
    if name == "two_blocks":
        jbs._loop_wrap = _reference_wrap
    try:
        return cases.render(wa, name)
    finally:
        jbs._loop_wrap = saved


@pytest.mark.parametrize("name", sorted(cases.CASES))
def test_kept_jax_renders_are_current(name):
    """tests/playhead_jax.npz, which the card's kernel is held to where
    there is no JAX, is the JAX package's render of each case: within
    1e-6 x peak (a tenth of what the port is held to), the playhead
    within 1e-9 samples."""
    out, position = _jax_render(name)
    with np.load(cases.JAX_RENDERS) as kept:
        want, want_position = kept[name], float(kept[name + ".position"])
    assert want.shape == out.shape and np.abs(want).max() > 0.1
    np.testing.assert_allclose(want, out, rtol=0,
                               atol=1e-6 * np.abs(out).max())
    assert want_position == pytest.approx(position, rel=0, abs=1e-9)


if __name__ == "__main__" and "--regen" in sys.argv:
    import jax

    jax.config.update("jax_platforms", "cpu")
    kept = {}
    for name in sorted(cases.CASES):
        out, position = _jax_render(name)
        kept[name] = out.astype(np.float32)
        kept[name + ".position"] = np.float64(position)
    np.savez_compressed(cases.JAX_RENDERS, **kept)
    print(f"wrote {cases.JAX_RENDERS}")
