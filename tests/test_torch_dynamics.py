"""The DynamicsCompressorNode on the port (webaudio_tpu_torch/nodes/
dynamics_compressor.py, ops/detector.py) against the JAX package, on the
CPU.

Tolerances:
- each detector against the sequential recurrence: 1e-4 relative to the
  detector's peak, tests/test_effects.py's bound (the f32 fixed point's
  composition error grows ~eps log2(B));
- each detector against its JAX twin: 1e-5 relative (measured <= 1.3e-6:
  the recursive-doubling scan and the cumsums associate the f32 sums in
  another order than `associative_scan` and the HIGHEST-precision
  triangular matmuls); the generic twins on the inputs of up to 4,096
  samples, where JAX's while loop compiles in seconds;
- the sequential plain version against JAX's `_detector_sequential`: 1e-4
  relative (measured <= 2.2e-5 at 131,072 samples: XLA contracts the step
  into an FMA, the port rounds the product and the sum apart, as its
  CUDA kernel does);
- renders: 1e-5 x peak, the goldens' rule (measured ~1e-6: XLA's and
  torch's f32 exp, log10 and pow differ in the last ulp, and the
  detector's dB domain turns an ulp into ~1e-6 relative gain).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import webaudio_tpu as wa
import webaudio_tpu_torch as wt
from webaudio_tpu.nodes import dynamics_compressor as jdc
from webaudio_tpu_torch.graph import compiler as tcomp
from webaudio_tpu_torch.nodes import dynamics_compressor as tdc
from webaudio_tpu_torch.ops import detector as tdet

Q = 128


def _context(mod, channels, length, fs):
    if mod is wt:
        return wt.OfflineAudioContext(channels, length, fs, device="cpu")
    return wa.OfflineAudioContext(channels, length, fs)


def _signal(rng, kind, B):
    """tests/test_effects.py:307-375's three kinds of detector input."""
    if kind % 3 == 0:
        return np.abs(rng.randn(B)).astype(np.float32) * 30
    if kind % 3 == 1:
        x = np.zeros(B, np.float32)
        x[B // 4: B // 2] = 25.0
        return x
    t = np.arange(B)
    return (20 * np.abs(np.sin(2 * np.pi * t / 997))
            + rng.randn(B)).astype(np.float32)


def _generic_cases():
    """test_effects.py::test_detector_fixed_point_matches_sequential."""
    rng = np.random.RandomState(7)
    fs = 44100.0
    out = []
    for kind, B in enumerate((128, 1000, 4096, 20000, 48000, 513)):
        x = _signal(rng, kind, B)
        a = np.float32(np.exp(-1 / (rng.uniform(0.0005, 0.05) * fs)))
        r = np.float32(np.exp(-1 / (rng.uniform(0.01, 1.0) * fs)))
        out.append((np.float32(rng.uniform(0, 10)), x, float(a), float(r)))
    return out


def _chunked_cases():
    """test_effects.py::test_detector_chunked_matches_sequential."""
    rng = np.random.RandomState(11)
    fs = 48000.0
    out = []
    for kind, B in enumerate((128, 513, 4096, 16384, 1000, 131072, 20000,
                              129)):
        x = _signal(rng, kind, B)
        a = float(np.exp(-1 / (rng.uniform(0.001, 0.05) * fs)))
        r = float(np.exp(-1 / (rng.uniform(0.01, 1.0) * fs)))
        assert tdc.chunked_taus_ok(a, r) and jdc.chunked_taus_ok(a, r)
        out.append((np.float32(rng.uniform(0, 10)), x, a, r))
    return out


GENERIC = _generic_cases()
CHUNKED = _chunked_cases()


@functools.lru_cache(maxsize=None)
def _jax_reference(family, i):
    """JAX's `_detector_sequential` on case i of a family, once."""
    y0, x, a, r = (GENERIC if family == "generic" else CHUNKED)[i]
    return _jax_sequential(y0, x, a, r)


def _jax_sequential(y0, x, a, r):
    B = x.shape[0]
    return np.asarray(jdc._detector_sequential(
        jnp.float32(y0), jnp.asarray(x), jnp.full((B,), np.float32(a)),
        jnp.full((B,), np.float32(r))))


def _rel(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-6)


def _port(mode, y0, x, a, r):
    ty0 = torch.tensor([y0])
    tx = torch.from_numpy(x)[None]
    ta, tr = torch.tensor(np.float32(a)), torch.tensor(np.float32(r))
    if mode == "sequential":
        return tdet.detector_scan(ty0, tx, ta, tr)[0].numpy()
    if mode == "fixed_point":
        return tdc._detector_fixed_point(ty0, tx, ta, tr)[0].numpy()
    if mode == "fp64":
        return tdc._detector_fixed_point(ty0, tx, ta, tr,
                                         dtype=torch.float64)[0].numpy()
    return tdc._detector_fixed_point_chunked(ty0, tx, a, r)[0].numpy()


def _jax(mode, y0, x, a, r):
    B = x.shape[0]
    args = (jnp.float32(y0), jnp.asarray(x), jnp.full((B,), np.float32(a)),
            jnp.full((B,), np.float32(r)))
    if mode == "sequential":
        return _jax_sequential(y0, x, a, r)
    if mode == "fixed_point":
        return np.asarray(jdc._detector_fixed_point(*args))
    if mode == "fp64":
        return np.asarray(jdc._detector_fixed_point(*args, dtype=jnp.float64))
    return np.asarray(jdc._detector_fixed_point_chunked(
        jnp.float32(y0), jnp.asarray(x), a, r))


# the sequential plain version loops over samples in Python: it takes the
# cases up to 20,000 samples
DETECTOR_CASES = (
    [pytest.param(m, "generic", i, id=f"{m}-generic{i}")
     for m in ("fixed_point", "fp64") for i in range(len(GENERIC))]
    + [pytest.param("sequential", "generic", i, id=f"sequential-generic{i}")
       for i in range(len(GENERIC)) if GENERIC[i][1].shape[0] <= 20000]
    + [pytest.param("chunked", "chunked", i, id=f"chunked{i}")
       for i in range(len(CHUNKED))])


@pytest.mark.parametrize("mode,family,i", DETECTOR_CASES)
def test_detector_matches_jax_and_sequential(mode, family, i):
    y0, x, a, r = (GENERIC if family == "generic" else CHUNKED)[i]
    got = _port(mode, y0, x, a, r)
    assert got.dtype == np.float32 and got.shape == x.shape
    assert _rel(got, _jax_reference(family, i)) < 1e-4
    if family == "chunked" or x.shape[0] <= 4096:
        tol = 1e-4 if mode == "sequential" else 1e-5
        assert _rel(got, _jax(mode, y0, x, a, r)) < tol


def test_detector_plain_version_is_the_recurrence():
    """The kernel's plain version steps exactly as written: each product
    and the sum rounded in f32 (what csrc/detector.cu does), per-sample
    and per-instance taus, attack 0 and release 0, one sample."""
    rng = np.random.RandomState(5)
    N, B = 3, 300
    x = (np.abs(rng.randn(N, B)) * 20).astype(np.float32)
    y0 = rng.uniform(0, 10, N).astype(np.float32)
    at = rng.uniform(0.5, 0.999, (N, B)).astype(np.float32)
    rt = rng.uniform(0.5, 0.9999, (N, B)).astype(np.float32)
    for a, r in ((at, rt), (at[:, :1], rt[:, :1]), (np.float32(0.0), rt),
                 (at, np.float32(0.0))):
        got = tdet.detector_scan(torch.from_numpy(y0), torch.from_numpy(x),
                                 torch.as_tensor(a), torch.as_tensor(r))
        aa = np.broadcast_to(a, (N, B)).astype(np.float32)
        rr = np.broadcast_to(r, (N, B)).astype(np.float32)
        want = np.empty((N, B), np.float32)
        prev = y0.copy()
        for i in range(B):
            tau = np.where(x[:, i] > prev, aa[:, i], rr[:, i])
            prev = (tau * prev + (np.float32(1.0) - tau) * x[:, i]
                    ).astype(np.float32)
            want[:, i] = prev
        np.testing.assert_array_equal(got.numpy(), want)
        for n in range(N):
            jseq = np.asarray(jdc._detector_sequential(
                jnp.float32(y0[n]), jnp.asarray(x[n]), jnp.asarray(aa[n]),
                jnp.asarray(rr[n])))
            assert _rel(got[n].numpy(), jseq) < 1e-5
    one = tdet.detector_scan(torch.tensor([2.0]), torch.tensor([[5.0]]),
                             0.5, 0.9)
    assert one.tolist() == [[3.5]]


def test_detector_instances_are_independent():
    """(N, B) detectors equal N one-instance runs: convergence is judged
    per instance, so a batch renders each instance as it would alone."""
    cases = [c for c in CHUNKED if c[1].shape[0] == 4096] + \
        [(np.float32(3.0), CHUNKED[2][1][::-1].copy(), CHUNKED[0][2],
          CHUNKED[0][3])]
    x = np.stack([c[1] for c in cases])
    y0 = torch.tensor([c[0] for c in cases])
    a, r = cases[0][2], cases[0][3]
    batch = tdc._detector_fixed_point_chunked(y0, torch.from_numpy(x), a, r)
    for n in range(len(cases)):
        alone = tdc._detector_fixed_point_chunked(
            y0[n:n + 1], torch.from_numpy(x[n:n + 1]), a, r)
        np.testing.assert_array_equal(batch[n].numpy(), alone[0].numpy())


def test_non_converged_instances_take_the_sequential_kernel(monkeypatch):
    """attack_tau = 0 resets y to x on every attack step, so a mispredicted
    branch re-seeds the rest of the block and the pattern front crawls: the
    fixed point runs out of iterations and the instance takes the exact
    recurrence.  Only the instances that did not settle go through it."""
    calls = []
    orig = tdc.detector_scan

    def spy(y0, x, at, rt):
        calls.append(tuple(x.shape))
        return orig(y0, x, at, rt)

    monkeypatch.setattr(tdc, "detector_scan", spy)
    rng = np.random.RandomState(3)
    B = 3000
    hard = (np.abs(rng.randn(B)) * 30).astype(np.float32)
    easy = np.full(B, 1.0, np.float32)
    x = torch.from_numpy(np.stack([easy, hard, easy]))
    y0 = torch.tensor([0.5, 5.0, 0.5])
    at = torch.zeros(3, B)
    rt = torch.full((3, B), np.float32(0.999))
    got = tdc._detector_fixed_point(y0, x, at, rt, max_iters=3)
    assert calls == [(1, B)]
    want = tdet.detector_reference(y0, x, at, rt)
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    assert _rel(got.numpy(), want.numpy()) < 1e-4
    jwant = np.asarray(jdc._detector_fixed_point(
        jnp.float32(5.0), jnp.asarray(hard), jnp.zeros(B),
        jnp.full(B, np.float32(0.999)), max_iters=3))
    assert _rel(got[1].numpy(), jwant) < 1e-4


def _buffer_graph(mod, x, fs, n_out=None, channels=1, **comp):
    """tests/test_effects.py's `_ctx_with_buffer` into a compressor."""
    n = x.shape[-1]
    ctx = _context(mod, channels, n_out or n, fs)
    buf = ctx.create_buffer(1 if x.ndim == 1 else x.shape[0], n, fs)
    for c, row in enumerate(np.atleast_2d(x)):
        buf.copy_to_channel(row, c)
    src = ctx.create_buffer_source()
    src.buffer = buf
    c = ctx.create_dynamics_compressor(**comp)
    src.connect(c)
    c.connect(ctx.destination)
    src.start()
    return ctx, c


def _both(build):
    """Render build(mod) with both packages: (port, JAX, port node, JAX
    node)."""
    tctx, tnode = build(wt)
    jctx, jnode = build(wa)
    got = tctx.start_rendering_sync().to_array()
    want = jctx.start_rendering_sync().to_array()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want,
                               atol=1e-5 * max(np.abs(want).max(), 1e-6))
    return got, want, tnode, jnode


def test_compressor_reduces_gain():
    """tests/test_effects.py:113 as parity: 0 dBFS against threshold -24,
    ratio 12, hard knee."""
    x = np.ones(48000, np.float32)
    got, _, tc, jc = _both(lambda mod: _buffer_graph(
        mod, x, 48000.0, threshold=-24.0, knee=0.0, ratio=12.0))
    expected = 10 ** ((-22.0 + 0.6 * 22.0) / 20.0)
    assert got[0, -100:].mean() == pytest.approx(expected, rel=0.01)
    assert tc.reduction == pytest.approx(-22.0 + 0.6 * 22.0, abs=0.2)
    assert tc.reduction == pytest.approx(jc.reduction, abs=1e-4)


@pytest.mark.parametrize("fs", (48000.0, 44100.0))
def test_compressor_lookahead_delay(fs):
    """tests/test_effects.py:131 and test_reference_vectors.py:933
    (dynamics_compressor.rs test_inner_delay) as parity: the output is
    delayed by ceil(fs * 0.006 / 128) quanta."""
    non_zero = int(np.ceil(0.006 * fs / Q)) * Q
    low = np.zeros(1024, np.float32)
    low[0] = 0.01
    got, _, _, _ = _both(lambda mod: _buffer_graph(mod, low, fs))
    assert np.all(got[0, :non_zero] == 0.0) and got[0, non_zero] != 0.0
    ones = np.ones(Q * 5, np.float32)
    got, _, _, _ = _both(lambda mod: _buffer_graph(mod, ones, fs, Q * 8))
    np.testing.assert_allclose(got[0, :non_zero], 0.0, atol=0.0)
    assert np.all(got[0, non_zero: Q * 8] != 0.0)


def _noise_graph(mod):
    rng = np.random.RandomState(3)
    x = (rng.randn(2, 8192) * 0.5).astype(np.float32)
    return _buffer_graph(mod, x, 48000.0, channels=2, threshold=-20.0,
                         ratio=6.0)


@pytest.mark.parametrize("mode", ("seq", "chunked", "fp64", "auto"))
def test_compressor_detector_modes_render_like_jax(monkeypatch, mode):
    """tests/test_effects.py:378 as parity: constant k-rate params plan the
    chunked detector (const_taus from the same f32 math as JAX), and every
    WEBAUDIO_DETECTOR mode renders as the JAX package does and within the
    JAX suite's 2e-4 x peak of the sequential render."""
    monkeypatch.setenv("WEBAUDIO_DETECTOR", mode)
    ctx, _ = _noise_graph(wt)
    cg = tcomp.compile_graph(dict(ctx._nodes), list(ctx._edges),
                             ctx.sample_rate, ctx.length,
                             ctx._destination.node_id, "cpu")
    (kern,) = [k for k in cg.kernels.values()
               if isinstance(k, tdc._CompressorKernel)]
    jctx, _ = _noise_graph(wa)
    from webaudio_tpu.graph import compiler as jcomp

    jcg = jcomp.compile_graph(dict(jctx._nodes), list(jctx._edges),
                              jctx.sample_rate, jctx.length,
                              jctx._destination.node_id)
    (jkern,) = [k for k in jcg.kernels.values()
                if type(k).__name__ == "_CompressorKernel"]
    assert kern.const_taus == jkern.const_taus and kern.const_taus is not None
    assert kern.delay_frames == jkern.delay_frames == 384
    want_mode = {"auto": "chunked"}.get(mode, mode)
    assert tdc.detector_mode(kern.const_taus, cg.block_frames) == want_mode
    got, _, _, _ = _both(_noise_graph)
    monkeypatch.setenv("WEBAUDIO_DETECTOR", "seq")
    seq = _noise_graph(wt)[0].start_rendering_sync().to_array()
    np.testing.assert_allclose(got, seq, atol=2e-4 * np.abs(seq).max())


def test_compressor_with_attack_zero_renders_like_jax():
    """attack 0 fails the chunked guard: the generic fixed point runs, and
    its non-converging blocks take the sequential kernel."""
    rng = np.random.RandomState(9)
    x = (rng.randn(4096) * 0.7).astype(np.float32)
    _both(lambda mod: _buffer_graph(mod, x, 48000.0, attack=0.0,
                                    threshold=-30.0, ratio=8.0))
    assert tdc.detector_mode((0.0, 0.99), 4096) == "fixed_point"
    assert tdc.detector_mode((0.5, 0.99), 100) == "fixed_point"


def test_compressor_golden_shaped_compressed():
    """tests/test_goldens.py's `shaped_compressed` (a sawtooth through a
    256-point tanh WaveShaper into a compressor) against the committed
    fixture at 1e-5 x peak, and against the JAX render."""
    import os

    path = os.path.join(os.path.dirname(__file__), "goldens.npz")

    def build(mod):
        ctx = _context(mod, 1, 2048, 48000.0)
        o = ctx.create_oscillator(type="sawtooth", frequency=300.0)
        c = ctx.create_dynamics_compressor(threshold=-30.0, ratio=8.0, knee=6.0)
        ws = ctx.create_wave_shaper()
        ws.set_curve(np.tanh(np.linspace(-2, 2, 256)).astype(np.float32))
        o.connect(ws)
        ws.connect(c)
        c.connect(ctx.destination)
        o.start()
        return ctx, c

    got, _, _, _ = _both(build)
    with np.load(path) as z:
        ref = z["shaped_compressed"]
    np.testing.assert_allclose(got, ref, atol=1e-5 * max(np.abs(ref).max(),
                                                         1e-6))


def test_compressor_refusals_and_params():
    ctx = _context(wt, 2, 1024, 48000.0)
    c = ctx.create_dynamics_compressor()
    with pytest.raises(wt.NotSupportedError):
        c.channel_count = 3
    with pytest.raises(wt.NotSupportedError):
        c.channel_count_mode = "max"
    c.channel_count = 1
    c.channel_count_mode = "explicit"
    for name in ("attack", "knee", "ratio", "release", "threshold"):
        p = getattr(c, name)
        assert p.automation_rate == wt.AutomationRate.K
        with pytest.raises(wt.InvalidStateError):
            p.automation_rate = wt.AutomationRate.A
    assert c.reduction == 0.0
    jc = _context(wa, 2, 1024, 48000.0).create_dynamics_compressor()
    for name in ("attack", "knee", "ratio", "release", "threshold"):
        tp, jp = getattr(c, name), getattr(jc, name)
        assert (tp.default_value, tp.min_value, tp.max_value) == \
            (jp.default_value, jp.min_value, jp.max_value)


def test_compressor_state_resumes_across_a_suspend():
    """The detector, the lookahead ring and `reduction` carry across a
    suspend_sync segment, and the callback reads the live reduction."""
    rng = np.random.RandomState(4)
    x = (rng.randn(2, 12000) * 0.6).astype(np.float32)
    seen = {}

    def build(mod):
        ctx, c = _buffer_graph(mod, x, 48000.0, channels=2, threshold=-30.0)
        ctx.suspend_sync(4096 / 48000.0,
                         lambda _: seen.setdefault(mod.__name__, c.reduction))
        return ctx, c

    _both(build)
    assert seen["webaudio_tpu_torch"] < -1.0
    assert seen["webaudio_tpu_torch"] == pytest.approx(seen["webaudio_tpu"],
                                                       abs=1e-4)
