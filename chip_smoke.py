"""GPU smoke check of the PyTorch port (webaudio_tpu_torch) on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout and
drives its main path on `device="cuda"`:

  a. the WaveShaper curve kernel against its plain PyTorch version, bit for
     bit, at 2 x 262,144 samples (values outside [-1, 1], NaN and +-inf
     included) for curve lengths 2, 2048 (shared-memory branch) and 65536
     (read-only-cache branch), and through a (2, n) table of per-instance
     curves (one row per row of x); a non-contiguous input must raise;
  b. the slice graph at full size: 10 s, 48 kHz, stereo, a looping
     AudioBufferSourceNode (bench.py's synthetic 2 s buffer, the aligned
     read) -> lowpass BiquadFilterNode (2000 Hz, Q 2) -> WaveShaperNode
     (tanh curve, 2048 points) -> destination, through
     OfflineAudioContext.start_rendering_sync.  Oracle: scipy lfilter in
     f64 on the looped buffer, then a numpy gather-lerp through the curve;
     tolerance 1e-5 x peak.  The plan must be 2 blocks of 262,144 frames,
     no node may fail, and the curve kernel must have launched;
  c. the same graph fed by a 44.1 kHz buffer (the pair-gather read), against
     the same kind of oracle with the buffer resampled the way the
     closed-form playhead reads it; tolerance 1e-5 x peak;
  d. the README's a-rate filter sweep (synthetic buffer), which runs the
     f64 log-depth scan on the card, against the port's own CPU render;
     tolerance 1e-4 x peak, because torch's CPU and CUDA sin/cos round the
     f32 filter coefficients differently in the last ulp and the resonant
     sweep amplifies that (an exact f64 recurrence moves by 2e-5 x peak);
  e. timing with CUDA events: the phase-b render end to end (one warm-up,
     then the median of 5) and its block loop alone on a compiled plan, as
     realtime factors; the curve kernel against its plain version at the
     main path's shape, as device time (calls replayed from a CUDA graph)
     and as called from Python.

Then batched serving (GraphBatch, MixedGraphBatch and the bounces), with
the dither and u-law kernels:

  f. the dither (int16) and u-law (uint8) kernels against their plain
     versions at (512, 98304) f32 from a uniform on [-1.2, 1.2] with NaN
     and +-inf planted, for three seeds: int16 bit-equal, uint8 within one
     code with at most 1e-6 of the codes off (the count is printed: any two
     uniforms give codes at most one apart, so only the count can catch a
     wrong random stream); one seed twice gives the same codes,
     two seeds differ; a non-contiguous input, an f64 input and a CPU input
     beside an output on the card raise KernelError;
  g. GraphBatch at full width: 256 instances of benches/suite.py's batched
     graph (2 s, 48 kHz, stereo, looping buffer -> lowpass Q 3 sweeping
     200 -> 8000 Hz), planned as 6 blocks of 16,384 frames.  Before the
     override every lane carries the context's rows and lane 0 matches its
     start_rendering_sync (1e-6 x peak); with the per-instance sweep rows,
     lanes 0 and 255 match a 2-instance batch on the CPU (1e-4 x peak, the
     sin/cos ulps of phase d); with 256 distinct buffers, lanes 0, 128 and
     255 match 1-instance batches on the card (1e-6 x peak);
  h. the bounces on that batch: render_i16 codes are floor(32767 x) or
     one more and equal the plain dither of the render bit for bit,
     render_u8 holds to the plain u-law as in f and, decoded, lies within
     0.06 of the render,
     render_stream(3, "i16") equals render_i16, and render_stream with
     updates of the sweep rows gives, batch by batch, the direct render
     after the same update;
  i. MixedGraphBatch over 96 contexts, 32 each of three topologies (the
     sweep; buffer -> constant lowpass -> WaveShaper; buffer -> gain
     envelope): 3 buckets, every output within 1e-6 x peak of its own
     start_rendering_sync on the card.  The dither, u-law and curve kernels
     must each have launched on the path g-i;
  j. timing: the staged batch's render at 256 and 1,024 instances
     (instances x audio seconds per wall second, graphs/s), end to end with
     the host copy (f32 and int16), render_stream pipelined (int16, uint8),
     the device-busy share of the 256-instance render (torch.profiler), and
     the dither and u-law kernels against their plain versions at
     (512, 98304) as device time from CUDA-graph replay.

Prints the measurements, a {"kernels": [...]} line and the card's name and
power limit, then as its last line {"ok": true, "device": {...}}.  Exits
non-zero, printing no result, if CUDA is unavailable or any phase fails.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

FS = 48000.0
SECONDS = 10.0
FRAMES = int(FS * SECONDS)
CURVE_POINTS = 2048
KERNEL_SAMPLES = 2 * 262144
SEED = 20261016
BATCH_SECONDS = 2.0
BATCH_FRAMES = int(FS * BATCH_SECONDS)
BATCH = 256
BIG_BATCH = 1024
QUANT_SHAPE = (512, 98304)
MIXED_PER_TOPOLOGY = 32
DEVICE = "cuda"              # where the batch phases g-i render


def _curve(n, rng=None):
    c = np.tanh(np.linspace(-2.0, 2.0, n))
    if rng is not None:
        c = c + 0.01 * rng.standard_normal(n)
    return c.astype(np.float32)


def _bench_data():
    # bench.py:34-37: the synthetic 2 s stereo buffer
    return np.sin(np.arange(2 * 48000) * 0.03, dtype=np.float32)[None].repeat(2, 0)


def _resampled_data():
    n = 2 * 44100
    t = np.arange(n)
    return np.stack([np.sin(t * 0.031) + 0.3 * np.sin(t * 0.0007),
                     np.cos(t * 0.017)]).astype(np.float32)


def slice_context(wt, device, data, buf_rate, frames=FRAMES):
    """source (loop) -> lowpass 2000 Hz, Q 2 -> WaveShaper -> destination."""
    ctx = wt.OfflineAudioContext(2, frames, FS, device=device)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = wt.AudioBuffer.from_array(data, buf_rate)
    src.start()
    filt = ctx.create_biquad_filter(type="lowpass", frequency=2000.0, q=2.0)
    shaper = ctx.create_wave_shaper(curve=_curve(CURVE_POINTS))
    src.connect(filt)
    filt.connect(shaper)
    shaper.connect(ctx.destination)
    return ctx


def sweep_context(wt, device, frames=FRAMES):
    """README.md's a-rate example with bench.py's synthetic buffer."""
    ctx = wt.OfflineAudioContext(2, frames, FS, device=device)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = wt.AudioBuffer.from_array(_bench_data(), FS)
    filt = ctx.create_biquad_filter(type="lowpass", q=8.0)
    filt.frequency.set_value_at_time(200.0, 0.0)
    filt.frequency.exponential_ramp_to_value_at_time(8000.0, frames / FS)
    src.connect(filt)
    filt.connect(ctx.destination)
    src.start()
    return ctx


def oracle(looped, curve):
    """scipy lfilter in f64 (the spec's lowpass, Q in dB) then a numpy
    gather + lerp through the curve."""
    from scipy.signal import lfilter

    w0 = 2.0 * np.pi * 2000.0 / FS
    alpha = np.sin(w0) / (2.0 * 10.0 ** (2.0 / 20.0))
    cw = np.cos(w0)
    b = np.array([(1 - cw) / 2, 1 - cw, (1 - cw) / 2])
    a = np.array([1 + alpha, -2 * cw, 1 - alpha])
    y = lfilter(b / a[0], a / a[0], looped.astype(np.float64), axis=1)
    n = len(curve)
    v = np.clip((n - 1) / 2.0 * (y + 1.0), 0.0, n - 1)
    k = np.minimum(np.floor(v).astype(np.int64), n - 2)
    f = v - k
    c = curve.astype(np.float64)
    return c[k] * (1.0 - f) + c[k + 1] * f


def looped_read(data, buf_rate, frames):
    """The closed-form playhead's looped read at rate 1: position
    n * buf_rate / fs wrapped into [0, L) (with the sticky snap at the
    loop end), lerped in f32 with the wrap neighbour at the seam."""
    L = data.shape[1]
    pos = np.arange(frames, dtype=np.float64) * (buf_rate / FS)
    wrapped = np.fmod(pos, L)
    wrapped = np.where(L - wrapped <= 1.5e-8 * np.maximum(pos, 1.0), 0.0, wrapped)
    k = np.floor(wrapped).astype(np.int64)
    frac = (wrapped - k).astype(np.float32)
    nxt = np.where(k + 1 >= L, 0, k + 1)
    return data[:, k] * (1.0 - frac) + data[:, nxt] * frac


def _check_close(name, got, want, rel):
    peak = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    ok = got.shape == want.shape and bool(np.isfinite(got).all()) and \
        err <= rel * peak
    print(f"{name}: max_abs_err {err:.3e} peak {peak:.6f} "
          f"limit {rel:g} x peak -> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: {err} > {rel} x {peak}")
    return err


def _events_ms(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _graph_ms(fn, reps):
    """Device ms per call of fn: `reps` calls captured in one CUDA graph,
    replayed 5 times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _events_ms(graph.replay, 5) / reps


def phase_a(ck, KernelError):
    rng = np.random.default_rng(SEED)
    x = rng.uniform(-1.6, 1.6, KERNEL_SAMPLES).astype(np.float32)
    x[:6] = [np.nan, np.inf, -np.inf, -1.0, 1.0, 0.0]
    xd = torch.from_numpy(x).reshape(2, -1).cuda()   # the main path's shape
    worst = 0.0
    for n in (2, 2048, 65536):
        curve = torch.from_numpy(_curve(n, rng)).cuda()
        got = ck.curve_lookup(curve, xd)
        torch.cuda.synchronize()
        want = ck.curve_lookup_reference(curve, xd)
        same = torch.equal(got.isnan(), want.isnan()) and torch.equal(
            torch.nan_to_num(got), torch.nan_to_num(want))
        err = float((torch.nan_to_num(got) - torch.nan_to_num(want)).abs().max())
        worst = max(worst, err)
        print(f"a. curve_lookup n={n}: bit-equal {same} max_abs_err {err:.3e}",
              flush=True)
        if not same:
            raise AssertionError(f"curve kernel differs from plain, n={n}")
    table = torch.stack([torch.from_numpy(_curve(CURVE_POINTS, rng)).cuda()
                         for _ in range(2)])
    got = ck.curve_lookup(table, xd)
    torch.cuda.synchronize()
    want = ck.curve_lookup_reference(table, xd)
    same = torch.equal(got.isnan(), want.isnan()) and torch.equal(
        torch.nan_to_num(got), torch.nan_to_num(want))
    err = float((torch.nan_to_num(got) - torch.nan_to_num(want)).abs().max())
    worst = max(worst, err)
    print(f"a. curve_lookup (2, {CURVE_POINTS}) table: bit-equal {same} "
          f"max_abs_err {err:.3e}", flush=True)
    if not same:
        raise AssertionError("curve table kernel differs from plain")
    try:
        ck.curve_lookup(curve, torch.zeros((2, 64), device="cuda").t())
    except KernelError as exc:
        print(f"a. non-contiguous input raises: {exc}", flush=True)
    else:
        raise AssertionError("non-contiguous input did not raise")
    return worst


def phase_b(wt, ck):
    data = _bench_data()
    ctx = slice_context(wt, "cuda", data, FS)
    ck.curve_lookup.launches = 0
    out = ctx.start_rendering_sync().to_array()
    launches = ck.curve_lookup.launches
    segs = ctx.render_stats["segments"]
    print(f"b. main path: segments {segs} curve_lookup launches {launches}",
          flush=True)
    if len(segs) != 1 or segs[0]["block_frames"] != 262144 or segs[0]["failed"]:
        raise AssertionError(f"unexpected plan or failed nodes: {segs}")
    if launches < 1:
        raise AssertionError("the curve kernel never launched on the main path")
    idx = np.arange(FRAMES) % data.shape[1]
    _check_close("b. 10 s slice render vs lfilter oracle", out,
                 oracle(data[:, idx], _curve(CURVE_POINTS)), 1e-5)
    return launches


def phase_c(wt):
    data = _resampled_data()
    ctx = slice_context(wt, "cuda", data, 44100.0)
    out = ctx.start_rendering_sync().to_array()
    if any(seg["failed"] for seg in ctx.render_stats["segments"]):
        raise AssertionError("a node failed in the 44.1 kHz render")
    want = oracle(looped_read(data, 44100.0, FRAMES), _curve(CURVE_POINTS))
    _check_close("c. 44.1 kHz buffer render vs resampled oracle", out, want, 1e-5)


def phase_d(wt):
    got = sweep_context(wt, "cuda").start_rendering_sync().to_array()
    want = sweep_context(wt, "cpu").start_rendering_sync().to_array()
    _check_close("d. README a-rate sweep, cuda vs cpu", got, want, 1e-4)


def phase_e(wt, ck, compiler):
    runs = []
    for i in range(6):
        ctx = slice_context(wt, "cuda", _bench_data(), FS)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        ctx.start_rendering_sync()
        stop.record()
        torch.cuda.synchronize()
        if i:                                  # the first run is warm-up
            runs.append(start.elapsed_time(stop))
    e2e_ms = statistics.median(runs)
    print(f"e. start_rendering_sync 10 s slice: median {e2e_ms:.3f} ms of "
          f"{['%.3f' % r for r in runs]} -> realtime factor "
          f"{SECONDS * 1000.0 / e2e_ms:.1f}x", flush=True)

    ctx = slice_context(wt, "cuda", _bench_data(), FS)
    cg = compiler.compile_graph(dict(ctx._nodes), list(ctx._edges), FS,
                                FRAMES, ctx._destination.node_id, "cuda")
    compiler.render_compiled(cg, FRAMES)
    loop = [_events_ms(lambda: compiler.render_compiled(cg, FRAMES), 5)
            for _ in range(3)]
    loop_ms = statistics.median(loop)
    print(f"e. block loop on a compiled plan: median {loop_ms:.3f} ms of "
          f"{['%.3f' % r for r in loop]} (5 renders each) -> realtime factor "
          f"{SECONDS * 1000.0 / loop_ms:.1f}x", flush=True)

    rng = np.random.default_rng(SEED + 1)
    xd = torch.from_numpy(rng.uniform(-1.6, 1.6, KERNEL_SAMPLES).astype(
        np.float32)).reshape(2, -1).cuda()
    curve = torch.from_numpy(_curve(CURVE_POINTS)).cuda()
    for _ in range(10):
        ck.curve_lookup(curve, xd)
        ck.curve_lookup_reference(curve, xd)

    def kernel():
        return ck.curve_lookup(curve, xd)

    def plain():
        return ck.curve_lookup_reference(curve, xd)

    # device time: 100 calls captured in one CUDA graph, so the Python
    # wrapper's host cost is out of the figure; plain, kernel, kernel, plain
    k_dev, p_dev = [], []
    for _ in range(2):
        p_dev.append(_graph_ms(plain, 100))
        k_dev.append(_graph_ms(kernel, 100))
        k_dev.append(_graph_ms(kernel, 100))
        p_dev.append(_graph_ms(plain, 100))
    # per call from Python, back to back: what the block loop pays
    k_host = _events_ms(kernel, 200)
    p_host = _events_ms(plain, 200)
    k_ms, p_ms = statistics.median(k_dev), statistics.median(p_dev)
    gbs = KERNEL_SAMPLES * 8 / (k_ms * 1e-3) / 1e9
    print(f"e. curve_lookup at {KERNEL_SAMPLES} samples, n={CURVE_POINTS}: "
          f"device time kernel {k_ms * 1000:.2f} us ({gbs:.0f} GB/s of x in "
          f"+ y out), plain {p_ms * 1000:.2f} us; called from Python back to "
          f"back: kernel {k_host * 1000:.2f} us, plain {p_host * 1000:.2f} us",
          flush=True)
    return k_ms, p_ms


def _host(t):
    return t.detach().cpu().numpy()


def _ulaw_off(name, got, want):
    """Codes of got off want: at most one apart, and at most 1e-6 of them
    (a wrong key, counter or word order moves about half of all codes)."""
    diff = (got.int() - want.int()).abs()
    off, worst = int(torch.count_nonzero(diff)), int(diff.max())
    print(f"{name}: ulaw_u8 codes off by one {off} of {diff.numel()}, max "
          f"off {worst} (limits: 1 code, {1e-6 * diff.numel():.0f} codes)",
          flush=True)
    if worst > 1 or off > 1e-6 * diff.numel():
        raise AssertionError(f"{name}: ulaw_u8 disagrees with its plain "
                             "version")
    return worst


def phase_f(dither, KernelError):
    rng = np.random.default_rng(SEED + 2)
    x = rng.uniform(-1.2, 1.2, QUANT_SHAPE).astype(np.float32)
    flat = x.reshape(-1)
    planted = rng.choice(flat.size, 3000, replace=False)
    flat[planted[:1000]] = np.nan
    flat[planted[1000:2000]] = np.inf
    flat[planted[2000:]] = -np.inf
    xd = torch.from_numpy(x).cuda()
    dither_err, ulaw_off = 0, 0
    for seed in (0, 1, 2**31 + 12345):
        q = dither.dither_i16(xd, seed)
        u = dither.ulaw_u8(xd, seed)
        torch.cuda.synchronize()
        err = int((q.int() - dither.dither_i16_reference(xd, seed).int())
                  .abs().max())
        dither_err = max(dither_err, err)
        print(f"f. seed {seed}: dither_i16 max |kernel - plain| {err} codes",
              flush=True)
        if err:
            raise AssertionError(f"dither_i16 differs from plain, seed {seed}")
        ulaw_off = max(ulaw_off, _ulaw_off(
            f"f. seed {seed}", u, dither.ulaw_u8_reference(xd, seed)))
    for fn in (dither.dither_i16, dither.ulaw_u8):
        a, b, c = fn(xd, 3), fn(xd, 3), fn(xd, 4)
        if not torch.equal(a, b) or torch.equal(a, c):
            raise AssertionError(f"{fn.__name__}: seeds do not act as seeds")
        for bad, args in (("non-contiguous", (xd.t(),)),
                          ("f64", (xd.double(),)),
                          ("x on the cpu, out on the card",
                           (xd[:2].cpu(), 0, torch.empty_like(a[:2])))):
            try:
                fn(*args)
            except KernelError as exc:
                print(f"f. {fn.__name__} {bad} raises: {exc}", flush=True)
            else:
                raise AssertionError(f"{fn.__name__}: {bad} did not raise")
    print("f. same seed twice gives the same codes, two seeds differ",
          flush=True)
    return float(dither_err), float(ulaw_off)


def batched_context(wt, device, f0=200.0, f1=8000.0):
    """benches/suite.py::_build_batched_ctx with bench.py's synthetic
    buffer: looping buffer -> lowpass Q 3, frequency f0 -> f1 Hz."""
    ctx = wt.OfflineAudioContext(2, BATCH_FRAMES, FS, device=device)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = wt.AudioBuffer.from_array(_bench_data(), FS)
    src.start()
    filt = ctx.create_biquad_filter(type="lowpass", q=3.0)
    filt.frequency.set_value_at_time(f0, 0.0)
    filt.frequency.exponential_ramp_to_value_at_time(f1, BATCH_SECONDS)
    src.connect(filt)
    filt.connect(ctx.destination)
    return ctx, src, filt


def sweep_rows(batch):
    sweeps = np.linspace(0.5, 2.0, batch, dtype=np.float32)
    base = np.geomspace(200.0, 8000.0, BATCH_FRAMES, dtype=np.float32)
    return sweeps[:, None] * base[None, :]


def lane_buffers(batch):
    """`batch` distinct synthetic stereo buffers of 2 s, amplitude 0.5."""
    w = np.linspace(0.004, 0.06, batch)[:, None]
    t = np.arange(BATCH_FRAMES)[None, :]
    return (0.5 * np.stack([np.sin(w * t), np.cos(1.3 * w * t)], axis=1)
            ).astype(np.float32)


def single_batch(wt, rows, buf):
    ctx, src, filt = batched_context(wt, DEVICE)
    gb = wt.GraphBatch(ctx, batch=1)
    gb.override_param(filt, "frequency", rows)
    gb.override_buffer(src, buf)
    return _host(gb.render())[0]


def phase_g(wt):
    ctx, src, filt = batched_context(wt, DEVICE)
    gb = wt.GraphBatch(ctx, batch=BATCH)
    print(f"g. plan: {gb.nb} blocks of {gb.cg.block_frames} frames, dense "
          f"params {gb.cg.dense_params}", flush=True)
    if gb.nb != 6 or gb.cg.block_frames != 16384:
        raise AssertionError("the batched graph did not plan 6 x 16384")
    own = _host(gb.render())
    spread = float(np.abs(own - own[:1]).max())
    print(f"g. before the override, max |lane - lane 0| = {spread:.3e}",
          flush=True)
    if spread > 0.0:
        raise AssertionError("lanes differ before any override")
    ref = batched_context(wt, DEVICE)[0].start_rendering_sync().to_array()
    _check_close("g. lane 0 vs the context's start_rendering_sync",
                 own[0, :, :BATCH_FRAMES], ref, 1e-6)

    rows = sweep_rows(BATCH)
    gb.override_param(filt, "frequency", rows)
    out = _host(gb.render())
    cctx, _, cfilt = batched_context(wt, "cpu")
    cpu = wt.GraphBatch(cctx, batch=2)
    cpu.override_param(cfilt, "frequency", rows[[0, BATCH - 1]])
    _check_close(f"g. lanes 0 and {BATCH - 1} vs a 2-instance CPU batch",
                 out[[0, BATCH - 1]], cpu.render().numpy(), 1e-4)

    bufs = lane_buffers(BATCH)
    gb.override_buffer(src, bufs)
    out = _host(gb.render())
    for i in (0, BATCH // 2, BATCH - 1):
        _check_close(f"g. per-instance buffer, lane {i} vs its single batch",
                     out[i], single_batch(wt, rows[i:i + 1], bufs[i:i + 1]),
                     1e-6)
    if gb.cg.failed:
        raise AssertionError(f"nodes failed: {gb.cg.failed}")
    return gb, filt, rows


def phase_h(gb, filt, rows, dither):
    x = gb.render()
    q = gb.render_i16()
    inside = x.abs() < 1.0
    base = torch.floor(x * 32767.0)
    qf = q.float()
    ok = ((qf == base) | (qf == base + 1.0)) | ~inside
    print(f"h. render_i16 {tuple(q.shape)} {q.dtype}: {int(inside.sum())} "
          f"samples in (-1, 1), all floor(32767 x) or +1: {bool(ok.all())}",
          flush=True)
    if q.dtype != torch.int16 or not bool(ok.all()):
        raise AssertionError("render_i16 codes are not the dithered render")
    if not torch.equal(q, dither.dither_i16_reference(x, 0)):
        raise AssertionError("render_i16 differs from the plain dither")
    print("h. render_i16 equals the plain dither of the render", flush=True)
    u = gb.render_u8()
    _ulaw_off("h. render_u8 vs the plain u-law of the render", u,
              dither.ulaw_u8_reference(x, 0))
    err = float(np.abs(dither.ulaw_decode_u8(_host(u))
                       - _host(x.clamp(-1.0, 1.0))).max())
    print(f"h. render_u8 decoded vs the render (clipped to [-1, 1]): max "
          f"|err| {err:.4f} (limit 0.06)", flush=True)
    if u.dtype != torch.uint8 or err >= 0.06:
        raise AssertionError("render_u8 does not track the render")
    direct = _host(gb.render_i16())
    for k, host in enumerate(gb.render_stream(3, fetch="i16")):
        if not np.array_equal(host, direct):
            raise AssertionError(f"render_stream batch {k} != render_i16")
    print("h. render_stream(3, 'i16') equals render_i16", flush=True)

    def updates(gb_, k):
        gb_.override_param(filt, "frequency", rows * (1.0 + 0.25 * k))

    streamed = list(gb.render_stream(3, updates=updates, fetch="f32"))
    for k, host in enumerate(streamed):
        updates(gb, k)
        d = float(np.abs(host - _host(gb.render())).max())
        print(f"h. render_stream with updates, batch {k}: max |stream - "
              f"direct| {d:.3e}", flush=True)
        if d != 0.0:
            raise AssertionError("render_stream batch differs from direct")
    gb.override_param(filt, "frequency", rows)


def mixed_corpus(wt):
    """32 each of three topologies, in one shuffled list."""
    curve = _curve(CURVE_POINTS)
    bufs = lane_buffers(MIXED_PER_TOPOLOGY)
    out = []
    for i in range(MIXED_PER_TOPOLOGY):
        s = 0.5 + 1.5 * i / (MIXED_PER_TOPOLOGY - 1)
        out.append(batched_context(wt, DEVICE, 200.0 * s, 8000.0 * s)[0])

        ctx = wt.OfflineAudioContext(2, BATCH_FRAMES, FS, device=DEVICE)
        src = ctx.create_buffer_source(loop=True)
        src.buffer = wt.AudioBuffer.from_array(bufs[i], FS)
        src.start()
        filt = ctx.create_biquad_filter(type="lowpass", frequency=3000.0, q=1.0)
        shaper = ctx.create_wave_shaper(curve=curve)
        src.connect(filt)
        filt.connect(shaper)
        shaper.connect(ctx.destination)
        out.append(ctx)

        ctx = wt.OfflineAudioContext(2, BATCH_FRAMES, FS, device=DEVICE)
        src = ctx.create_buffer_source(loop=True)
        src.buffer = wt.AudioBuffer.from_array(_bench_data(), FS)
        src.start()
        env = ctx.create_gain(gain=0.0)
        env.gain.linear_ramp_to_value_at_time(s / 2.0, BATCH_SECONDS)
        src.connect(env)
        env.connect(ctx.destination)
        out.append(ctx)
    return out


def phase_i(wt, kernels):
    mb = wt.MixedGraphBatch(mixed_corpus(wt))
    outs = mb.render()
    launches = {k.__name__: k.launches for k in kernels}
    print(f"i. MixedGraphBatch: {len(outs)} contexts in {mb.num_buckets} "
          f"buckets; launches on the batch path (g-i): {launches}", flush=True)
    if mb.num_buckets != 3:
        raise AssertionError(f"expected 3 buckets, got {mb.num_buckets}")
    worst = 0.0
    for i, ctx in enumerate(mixed_corpus(wt)):
        want = ctx.start_rendering_sync().to_array()
        peak = float(np.abs(want).max())
        err = float(np.abs(outs[i] - want).max())
        worst = max(worst, err / peak)
        if outs[i].shape != want.shape or not err <= 1e-6 * peak:
            raise AssertionError(f"context {i}: {err} > 1e-6 x {peak}")
    print(f"i. every output vs its own start_rendering_sync: worst "
          f"{worst:.3e} x peak (limit 1e-6) -> ok", flush=True)
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"{name} never launched on the batch path")
    return launches


def _median_events_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    return statistics.median(_events_ms(fn, 1) for _ in range(reps))


def _rates(name, batch, ms):
    print(f"j. {name}: median {ms:.3f} ms -> "
          f"{batch * BATCH_SECONDS * 1000.0 / ms:.1f} instance-audio-s per "
          f"wall s, {batch * 1000.0 / ms:.1f} graphs/s", flush=True)


def _busy_share(fn, reps=3):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in rows
                  if e.device_type == DeviceType.CUDA)
    # device time by the aten op that launched it
    ops = sorted((e for e in rows if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)[:6]
    return busy_us, wall_us, [(e.key, e.self_device_time_total / reps)
                              for e in ops]


def phase_j(wt, gb, filt, dither):
    ms = _median_events_ms(gb.render)
    _rates(f"staged render, {BATCH} instances", BATCH, ms)
    big_ctx, _, big_filt = batched_context(wt, DEVICE)
    big = wt.GraphBatch(big_ctx, batch=BIG_BATCH)
    big.override_param(big_filt, "frequency", sweep_rows(BIG_BATCH))
    _rates(f"staged render, {BIG_BATCH} instances", BIG_BATCH,
           _median_events_ms(big.render))
    del big
    _rates(f"render + host copy f32, {BATCH} instances", BATCH,
           _median_events_ms(lambda: gb.render().cpu()))
    _rates(f"render_i16 + host copy, {BATCH} instances", BATCH,
           _median_events_ms(lambda: gb.render_i16().cpu()))
    for fetch in ("i16", "u8"):
        for _ in gb.render_stream(2, fetch=fetch):
            pass
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in gb.render_stream(6, fetch=fetch):
                pass
            walls.append((time.perf_counter() - t0) * 1000.0 / 6)
        _rates(f"render_stream pipelined {fetch} (host clock, per batch, "
               f"median of 3 streams of 6)", BATCH, statistics.median(walls))
    busy_us, wall_us, top = _busy_share(gb.render)
    if busy_us > 0:
        print(f"j. profiler over 3 renders of {BATCH}: device busy "
              f"{busy_us / 1000:.3f} ms of {wall_us / 1000:.3f} ms wall "
              f"({100.0 * busy_us / wall_us:.1f}% busy); device us per "
              f"render by op: {[(k, round(t, 1)) for k, t in top]}",
              flush=True)
    else:
        print("j. profiler saw no device time: device-busy share not "
              "measured", flush=True)

    xd = torch.from_numpy(np.random.default_rng(SEED + 3).uniform(
        -1.2, 1.2, QUANT_SHAPE).astype(np.float32)).cuda()
    times = {}
    for name, kern, plain, out_bytes in (
            ("dither_i16", dither.dither_i16, dither.dither_i16_reference, 2),
            ("ulaw_u8", dither.ulaw_u8, dither.ulaw_u8_reference, 1)):
        k_dev, p_dev = [], []
        for _ in range(2):
            p_dev.append(_graph_ms(lambda: plain(xd, 0), 5))
            k_dev.append(_graph_ms(lambda: kern(xd, 0), 20))
            k_dev.append(_graph_ms(lambda: kern(xd, 0), 20))
            p_dev.append(_graph_ms(lambda: plain(xd, 0), 5))
        k_ms, p_ms = statistics.median(k_dev), statistics.median(p_dev)
        gbs = xd.numel() * (4 + out_bytes) / (k_ms * 1e-3) / 1e9
        print(f"j. {name} at {QUANT_SHAPE}: device time kernel "
              f"{k_ms * 1000:.2f} us ({gbs:.0f} GB/s of x in + codes out), "
              f"plain {p_ms * 1000:.2f} us ({p_ms / k_ms:.1f}x)", flush=True)
        times[name] = (k_ms, p_ms)
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    import webaudio_tpu_torch as wt
    from webaudio_tpu_torch.graph import compiler
    from webaudio_tpu_torch.ops import cuda_lib
    from webaudio_tpu_torch.ops import curve_kernel as ck
    from webaudio_tpu_torch.ops import dither

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    sources = sorted(p.name for p in cuda_lib.CSRC_DIR.glob("*.cu"))
    with ThreadPoolExecutor(len(sources)) as pool:   # one nvcc per source,
        list(pool.map(cuda_lib.load_library, sources))   # all at once
    ck._launcher()
    dither._launchers()
    print(f"build: {', '.join(sources)} built and loaded in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    max_err = phase_a(ck, wt.KernelError)
    offline_launches = phase_b(wt, ck)
    phase_c(wt)
    phase_d(wt)
    k_ms, p_ms = phase_e(wt, ck, compiler)
    q_err = phase_f(dither, wt.KernelError)

    # the batch path, g-i: every count from 0
    kernels = (ck.curve_lookup, dither.dither_i16, dither.ulaw_u8)
    for k in kernels:
        k.launches = 0
    gb, filt, rows = phase_g(wt)
    phase_h(gb, filt, rows, dither)
    launches = phase_i(wt, kernels)
    times = phase_j(wt, gb, filt, dither)

    print(json.dumps({"kernels": [
        {"name": "curve_lookup", "route": "cuda",
         "source": "webaudio_tpu_torch/csrc/curve_lookup.cu",
         "replaces": "webaudio_tpu/ops/curve_kernel.py:164",
         "launches": launches["curve_lookup"],
         "launches_offline_path": offline_launches, "max_abs_err": max_err,
         "ms": k_ms, "plain_ms": p_ms},
        {"name": "dither_i16", "route": "cuda",
         "source": "webaudio_tpu_torch/csrc/quantize.cu",
         "replaces": "webaudio_tpu/ops/dither.py:37",
         "launches": launches["dither_i16"], "max_abs_err": q_err[0],
         "ms": times["dither_i16"][0], "plain_ms": times["dither_i16"][1]},
        {"name": "ulaw_u8", "route": "cuda",
         "source": "webaudio_tpu_torch/csrc/quantize.cu",
         "replaces": "webaudio_tpu/ops/dither.py:113",
         "launches": launches["ulaw_u8"], "max_abs_err": q_err[1],
         "ms": times["ulaw_u8"][0], "plain_ms": times["ulaw_u8"][1]},
    ]}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
