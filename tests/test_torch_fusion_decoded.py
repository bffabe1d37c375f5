"""Port-side copies of the five tests/test_fusion.py tests (from its
test_grain_window_read_matches_gather on) that build their grain banks
from the reference's samples/sample.wav, which the repository does not
hold.  Here the sample is a stereo 16-bit WAV of the same shape (44.1 kHz,
142,187 frames) written by the port's `write_wav` and decoded with
`decode_audio_data_sync`; each test runs the JAX test's check on the port
(webaudio_tpu_torch, CPU) and holds the port to the JAX package's render
of the same graph from the same file, within 3e-5 absolute (granular
renders: XLA contracts the playhead and the lerp into FMAs; ROADMAP's
known deviations).

The port has one envelope path for a lane-packed grain bank (per-lane
spliced rows); the JAX package's study switches WEBAUDIO_COMPACT_ENV and
WEBAUDIO_GRAIN_LANES are not ported, so the compact-table and
per-voice-row renders they select are the JAX package's, read on the same
file.
"""

import numpy as np
import pytest

import webaudio_tpu as wa
import webaudio_tpu_torch as wt
from webaudio_tpu.graph import compiler as jcomp
from webaudio_tpu.parallel.batch import MixedGraphBatch as JMixed
from webaudio_tpu_torch.checkpoint import RenderSession
from webaudio_tpu_torch.graph import compiler as tcomp
from webaudio_tpu_torch.media.wav import write_wav

FS = 44100.0
GRANULAR = 3e-5


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    n = 142187
    t = np.arange(n)
    rng = np.random.default_rng(9)
    x = np.stack([0.6 * np.sin(t * 0.021) + 0.1 * np.sin(t * 0.31),
                  0.5 * np.cos(t * 0.013) + 0.05 * rng.standard_normal(n)])
    path = str(tmp_path_factory.mktemp("samples") / "sample.wav")
    write_wav(path, x.astype(np.float32), FS, bits=16)
    return path


def _ctx(mod, frames):
    if mod is wt:
        return wt.OfflineAudioContext(2, frames, FS, device="cpu")
    return wa.OfflineAudioContext(2, frames, FS)


def _grains(ctx, path, grains, ramp=0.4):
    sample = ctx.decode_audio_data_sync(path)
    for when, offset, rate in grains:
        src = ctx.create_buffer_source(playback_rate=rate)
        src.buffer = sample
        env = ctx.create_gain(gain=0.0)
        env.gain.set_value_at_time(0.0, when)
        env.gain.linear_ramp_to_value_at_time(ramp, when + 0.045)
        env.gain.linear_ramp_to_value_at_time(0.0, when + 0.09)
        src.connect(env)
        env.connect(ctx.destination)
        src.start(when, offset, 0.09)
    return ctx


def _fused(ctx):
    if isinstance(ctx, wt.OfflineAudioContext):
        cg = tcomp.compile_graph(dict(ctx._nodes), list(ctx._edges),
                                 ctx.sample_rate, ctx.length,
                                 ctx._destination.node_id, ctx.device)
    else:
        cg = jcomp.compile_graph(dict(ctx._nodes), list(ctx._edges),
                                 ctx.sample_rate, ctx.length,
                                 ctx._destination.node_id)
    fused = [k for k in cg.kernels.values()
             if type(k).__name__.startswith("_FusedVoices")]
    assert fused
    return cg, fused[0]


def _window_grains(seconds=1.0):
    rng0 = np.random.RandomState(7)
    return [(i * (seconds - 0.2) / 40,
             0.3 + 0.5 * (i / 40) + rng0.rand() * 0.05,
             float(0.9 + 0.2 * rng0.rand())) for i in range(40)]


def _bank_grains(n_grains=48, seconds=1.0, seed=3, spread=0.8):
    rng = np.random.RandomState(seed)
    return [(i * (seconds - 0.2) / n_grains,
             0.3 + spread * (i / n_grains),
             float(0.9 + 0.2 * rng.rand())) for i in range(n_grains)]


def _grain_ctx(mod, path, seed=3, ramp=0.4):
    """test_fusion.py::_grain_ctx: a fused grain bank at lane-env density
    (48 grains of 90 ms in 1 s)."""
    return _grains(_ctx(mod, int(FS)), path, _bank_grains(seed=seed), ramp)


def _render(ctx):
    return ctx.start_rendering_sync().to_array()


def _with_env(monkeypatch, name, value, make):
    monkeypatch.setenv(name, value)
    try:
        return make()
    finally:
        monkeypatch.delenv(name)


def test_grain_window_read_matches_gather(sample, monkeypatch):
    """The windowed and grouped reads equal the pair gather to 2e-6, the
    Pallas-mode read (grouped_pl) the grouped_t one to 5e-7; the port's
    gather render is the JAX package's to 3e-5."""
    def render(mod, mode):
        def make():
            ctx = _grains(_ctx(mod, int(FS)), sample, _window_grains())
            _, fused = _fused(ctx)
            assert fused.use_lanes
            return _render(ctx), fused.win_W
        return _with_env(monkeypatch, "WEBAUDIO_GRAIN_READ", mode, make)

    got_g, act_g = render(wt, "gather")
    assert act_g == 0
    for mode in ("window", "grouped"):
        got_w, act_w = render(wt, mode)
        assert act_w > 0, mode
        assert np.abs(got_w).max() > 0.01
        np.testing.assert_allclose(got_w, got_g, atol=2e-6, err_msg=mode)
    got_t, act_t = render(wt, "grouped_t")
    got_pl, act_pl = render(wt, "grouped_pl")
    assert act_t > 0 and act_pl > 0
    np.testing.assert_allclose(got_pl, got_t, atol=5e-7)
    np.testing.assert_allclose(got_g, render(wa, "gather")[0], atol=GRANULAR)


def test_compact_env_matches_dense_rows(sample, monkeypatch):
    """The JAX package renders the same bank with its per-voice dense
    envelope rows (WEBAUDIO_COMPACT_ENV=0) and its compact segment tables
    (=1), equal to 2e-6; the port's render (its one envelope path) is
    both within 3e-5, and overriding a grain's envelope in a batch
    raises."""
    def build(mod):
        return _grains(_ctx(mod, int(FS)), sample,
                       _bank_grains(n_grains=40, seed=4))

    dense = _with_env(monkeypatch, "WEBAUDIO_COMPACT_ENV", "0",
                      lambda: _render(build(wa)))
    compact = _with_env(monkeypatch, "WEBAUDIO_COMPACT_ENV", "1",
                        lambda: _render(build(wa)))
    np.testing.assert_allclose(compact, dense, atol=2e-6)
    got = _render(build(wt))
    assert np.abs(got).max() > 0.01
    np.testing.assert_allclose(got, dense, atol=GRANULAR)
    np.testing.assert_allclose(got, compact, atol=GRANULAR)

    ctx = build(wt)
    env0 = next(n for n in ctx._nodes.values()
                if type(n).__name__ == "GainNode")
    gb = wt.GraphBatch(ctx, batch=2)
    with pytest.raises(ValueError, match="batch-overridden"):
        gb.override_param(env0, "gain", np.zeros((2, ctx.length), np.float32))


def test_lane_env_matches_voice_rows(sample, monkeypatch):
    """The port splices each lane's envelopes into one row a lane (K rows
    in xs, not V voice rows); its render equals the JAX package's lane
    render and its per-voice-row render (WEBAUDIO_GRAIN_LANES=0) within
    3e-5, which equal each other to 2e-6."""
    ctx = _grain_ctx(wt, sample)
    cg, fused = _fused(ctx)
    assert fused.lane_env and fused.use_lanes
    assert len(cg.dense_params) == fused.K
    got = _render(ctx)
    assert np.abs(got).max() > 0.01
    dense = _with_env(monkeypatch, "WEBAUDIO_GRAIN_LANES", "0",
                      lambda: _render(_grain_ctx(wa, sample)))
    lanes = _render(_grain_ctx(wa, sample))
    np.testing.assert_allclose(lanes, dense, atol=2e-6)
    np.testing.assert_allclose(got, lanes, atol=GRANULAR)
    np.testing.assert_allclose(got, dense, atol=GRANULAR)


def test_lane_env_checkpoint_resume(sample, tmp_path):
    """A RenderSession over the lane-env bank, saved mid-render and
    restored, matches the one-shot render (5e-6) and the JAX package's
    one-shot (3e-5)."""
    full = _render(_grain_ctx(wt, sample))
    n = _grain_ctx(wt, sample).length
    s = RenderSession(_grain_ctx(wt, sample), quanta_per_block=32)
    half = (n // 2) // 4096 * 4096
    first = s.step(half)
    ck = str(tmp_path / "lane.npz")
    s.save(ck)
    s2 = RenderSession(_grain_ctx(wt, sample), quanta_per_block=32)
    s2.restore(ck)
    second = s2.step((n - half) // 4096 * 4096)
    got = np.concatenate([first, second], axis=1)
    np.testing.assert_allclose(got, full[:, :got.shape[1]], atol=5e-6)
    want = _render(_grain_ctx(wa, sample))
    np.testing.assert_allclose(got, want[:, :got.shape[1]], atol=GRANULAR)


def test_lane_env_mixed_batch_and_override_error(sample):
    """Two lane-env banks that differ in their envelopes' peak bucket
    together and render their own audio (2e-5), the JAX package's within
    3e-5; a grain envelope cannot be overridden in a batch."""
    a, b = _grain_ctx(wt, sample), _grain_ctx(wt, sample, ramp=0.7)
    ra = _render(_grain_ctx(wt, sample))
    rb = _render(_grain_ctx(wt, sample, ramp=0.7))
    outs = wt.MixedGraphBatch([a, b]).render()
    np.testing.assert_allclose(outs[0], ra, atol=2e-5)
    np.testing.assert_allclose(outs[1], rb, atol=2e-5)
    jouts = JMixed([_grain_ctx(wa, sample),
                    _grain_ctx(wa, sample, ramp=0.7)]).render()
    for got, want in zip(outs, jouts):
        np.testing.assert_allclose(got, np.asarray(want), atol=GRANULAR)

    ctx = _grain_ctx(wt, sample)
    env0 = next(n_ for n_ in ctx._nodes.values()
                if type(n_).__name__ == "GainNode")
    gb = wt.GraphBatch(ctx, batch=2)
    with pytest.raises(ValueError, match="batch-overridden"):
        gb.override_param(env0, "gain", np.zeros((2, ctx.length), np.float32))
