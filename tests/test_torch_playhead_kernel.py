"""The buffer source's automated-rate playhead on the port: its plain
version (`nodes/buffer_source.py::_BufferSourceKernel._process_cumsum`)
against a frame-by-frame float64 walk of the reference's playback state
machine on the CPU, what the kernel's wrapper (`ops/playhead.py`) refuses,
and on the card the CUDA kernel (`csrc/buffer_playhead.cu`) against the
plain version on the same tensors and against the same frame-by-frame
walk.  Both devices render tests/playhead_cases.py's graphs against the
JAX package's renders kept in tests/playhead_jax.npz (on the CPU,
tests/test_torch_playhead.py renders them through JAX itself and holds
the kept file to it).

The file imports no JAX, so on a GPU machine without it:

    python -m pytest tests/test_torch_playhead_kernel.py --noconftest -q
"""

import math

import numpy as np
import pytest
import torch

import webaudio_tpu_torch as wt
from webaudio_tpu_torch.graph import compiler
from webaudio_tpu_torch.nodes.buffer_source import _BufferSourceKernel
from webaudio_tpu_torch.ops import playhead
from webaudio_tpu_torch.ops.bufread import edge_vals, pair_rows
from webaudio_tpu_torch.ops.cuda_lib import KernelError

import playhead_cases as cases

FS = 48000.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _data(channels, frames, seed):
    """Smooth seeded audio: two sines a channel, slopes under 0.05 a
    sample."""
    rng = np.random.default_rng(seed)
    t = np.arange(frames)
    w = rng.uniform(0.002, 0.03, (channels, 2, 1))
    x = 0.5 * np.sin(t * w[:, 0]) + 0.3 * np.sin(t * w[:, 1] + 1.0)
    return x.astype(np.float32)


def _kernel(device, frames, frame0, *, buf_rate=44100.0, channels=2,
            length=6000, loop=True, loop_start=0.02, loop_end=0.11,
            when=0.0, offset=0.0, duration=None, seed=0):
    """A looping or one-shot source's kernel on the automated-rate path,
    planned as a session plans it (every param a dense row), and its
    buffer."""
    data = _data(channels, length, seed)
    ctx = wt.OfflineAudioContext(channels, frame0 + frames, FS,
                                 device=device)
    src = ctx.create_buffer_source(loop=loop, loop_start=loop_start,
                                   loop_end=loop_end)
    src.buffer = wt.AudioBuffer.from_array(data, buf_rate)
    src.connect(ctx.destination)
    src.start(when, offset, duration)
    cg = compiler.compile_graph(
        dict(ctx._nodes), list(ctx._edges), FS, frames,
        ctx._destination.node_id, ctx.device, start_frame=frame0,
        quanta_per_block=frames // 128, force_dense_params=True)
    (kern,) = [k for k in cg.kernels.values()
               if isinstance(k, _BufferSourceKernel)]
    assert kern.const_rate is None
    return kern, data


def _resources(kern, data, n, R, device, seed):
    """The staged pair rows and edge values, one buffer (R = 1) or one an
    instance (R = n, the first the kernel's own, the others seeded)."""
    wrap = int(math.ceil(kern.loop_start * kern.buf_rate))
    bufs = [data] + [_data(*data.shape, seed + i) for i in range(1, R)]
    return {"data_rows": torch.from_numpy(np.stack(
                [pair_rows(b) for b in bufs])).to(device),
            "edge_vals": torch.from_numpy(np.stack(
                [edge_vals(b, kern.loop, wrap) for b in bufs])).to(device)}


def _block(kern, res, pr, dt, state, frame0, device, captured=False,
           plain=False):
    """One block of the source through `process` (the kernel on a card,
    the plain version on the CPU) or, plain=True, through the plain
    version on any device; captured: frame0 as the device scalar of a
    captured walk."""
    n, frames = state["buffer_time"].shape[0], pr.shape[-1]
    device = torch.device(device)
    if captured:
        scope = compiler.BlockScope(
            torch.tensor(frame0, dtype=torch.int64, device=device), frames,
            n, device, None, torch.arange(frames, device=device))
    else:
        scope = compiler.BlockScope(frame0, frames, n, device)
    scope.node_resources = res
    params = {"playback_rate": pr, "detune": dt}
    if plain:
        return kern._process_cumsum(scope, state, params)
    return kern.process(scope, state, [], params)


def _state(bt, el, en, device):
    return {"buffer_time": torch.tensor(bt, dtype=torch.float64,
                                        device=device),
            "elapsed": torch.tensor(el, dtype=torch.float64, device=device),
            "entered": torch.tensor(en, dtype=torch.bool, device=device)}


def _wrap(pos, ls, le, snap):
    """The loop wrap into [ls, le); snap: reads within sqrt(eps) of le,
    relative to le, take ls (audio_buffer_source.rs:694-699)."""
    w = ls + np.mod(pos - ls, le - ls)
    return ls if snap and le - w <= 1.5e-8 * max(abs(le), 1.0) else w


def _model(kern, data, pr, dt, frame0, state):
    """The reference's playback (audio_buffer_source.rs:625-815) one frame
    at a time in float64 on one instance's rows: the start's offset and
    sub-sample advance, the duration limit on the elapsed |rate|, the
    sticky loop entry and its wrap, the pair read with the loop's or the
    end's neighbour, and the lerp.  -> ((C, B) output, state')."""
    fs, br = kern.sample_rate, kern.buf_rate
    ratio, L = br / fs, kern.buf_len
    ls, le = kern.loop_start * br, kern.loop_end * br
    bt, el, en = state
    never = kern.start_frame >= 2**31 - 1
    delta = 0.0 if never else kern.start_frame / fs - kern.start_time
    out = np.zeros((data.shape[0], pr.shape[-1]))
    d = data.astype(np.float64)
    for n in range(pr.shape[-1]):
        t = frame0 + n
        rate = float(pr[n]) * 2.0 ** (float(dt[n]) / 1200.0)
        if t == kern.start_frame:
            off = min(max(kern.offset + delta * rate, 0.0), kern.buf_duration)
            if kern.loop:
                off = (min(off, kern.loop_end) if rate >= 0.0
                       else max(off, kern.loop_start))
            bt = off * br
            el += abs(delta * rate) * fs
        sched = kern.start_frame <= t < kern.stop_frame
        active = sched and el < kern.duration * fs
        pos = bt
        if kern.loop:
            past = kern.offset * br >= le
            if active and (pos < le if past else pos >= ls):
                en = True
            if en:
                pos = _wrap(pos, ls, le, snap=True)
        if active and 0.0 <= pos < L:
            i = int(np.floor(pos))
            k = pos - i
            if i + 1 < L:
                b = d[:, i + 1]
            elif kern.loop:
                b = d[:, min(max(int(math.ceil(ls)), 0), L - 1)]
            elif k >= 1.0 - 1e-6 or i == 0:
                b = np.zeros(d.shape[0])
            else:
                b = 2.0 * d[:, L - 1] - d[:, L - 2]
            out[:, n] = d[:, i] * (1.0 - k) + b * k
        if sched:
            el += abs(rate)
        if active:
            bt += rate * ratio
            if kern.loop and en:
                bt = _wrap(bt, ls, le, snap=False)
    return out, (bt, el, en)


def _rows(kind, n, frames, seed):
    """(n, 1, frames) f32 rate or detune rows."""
    rng = np.random.default_rng(seed)
    a, b = {"ramp": (0.6, 1.8), "negative": (-0.5, -1.6),
            "mixed": (1.2, -1.0), "cents": (-300.0, 500.0),
            "flat": (0.0, 0.0)}[kind]
    shift = 0.0 if kind == "flat" else rng.uniform(-0.1, 0.1, (n, 1)) * (
        100.0 if kind == "cents" else 1.0)
    x = np.linspace(a, b, frames)[None] + shift
    return x.astype(np.float32)[:, None, :]


# --- the plain version on the CPU -------------------------------------------

# (name, source settings, blocks of frames, frame0 of the first, rate rows,
# detune rows, the state before it (buffer_time, elapsed, entered))
MODEL_CASES = {
    "loop_sub_sample_start": (
        dict(when=(100.3) / FS), 512, 0, "ramp", "cents", (0.0, 0.0, False)),
    "one_shot_duration_offset": (
        dict(loop=False, when=700 / FS, offset=0.01, duration=0.012), 512, 0,
        "ramp", "flat", (0.0, 0.0, False)),
    "loop_backwards_from_its_end": (
        dict(when=3.5 / FS, offset=0.115), 512, 0, "negative", "cents",
        (0.0, 0.0, False)),
    "one_shot_runs_off_the_end": (
        dict(loop=False, length=1500), 512, 0, "ramp", "cents",
        (0.0, 0.0, False)),
    "loop_entered_then_reversed": (
        dict(when=1400 / FS, offset=0.0197), 1024, 0, "mixed", "flat",
        (0.0, 0.0, False)),
    "far_into_a_render": (
        dict(), 512, 2**26, "ramp", "cents", (2000.25, 2.0**26, True)),
}


def _against_model(case, device):
    """Three blocks of MODEL_CASES[case] carried through the state by
    `process` on `device` (the plain version on the CPU, the kernel on a
    card, one launch a block), against the float64 frame-by-frame walk.
    Each quantum's increments are summed in float32 (at most 128 x 1.9 a
    quantum, so each of its ~24 roundings is under 2^-24 x 256 = 1.5e-5
    buffer samples), and the buffer's slopes stay under 0.05 a sample:
    the reads may differ by 2e-5 x peak.  The carried state is float64
    from end to end."""
    kw, frames, frame0, rk, dk, st = MODEL_CASES[case]
    kern, data = _kernel(device, frames, frame0, **kw)
    res = _resources(kern, data, 1, 1, device, 0)
    pr = _rows(rk, 1, 3 * frames, 1)
    dt = _rows(dk, 1, 3 * frames, 2)
    state = _state([st[0]], [st[1]], [st[2]], device)
    want_state = st
    outs, wants = [], []
    per_block = 1 if torch.device(device).type == "cuda" else 0
    for b in range(3):
        sl = slice(b * frames, (b + 1) * frames)
        f0 = frame0 + b * frames
        before = playhead.buffer_playhead.launches
        state, (out,) = _block(kern, res,
                               torch.from_numpy(pr[..., sl]).to(device),
                               torch.from_numpy(dt[..., sl]).to(device),
                               state, f0, device)
        assert playhead.buffer_playhead.launches == before + per_block
        want, want_state = _model(kern, data, pr[0, 0, sl], dt[0, 0, sl], f0,
                                  want_state)
        outs.append(out[0].cpu().numpy())
        wants.append(want)
        assert float(state["buffer_time"][0]) == pytest.approx(
            want_state[0], rel=0, abs=1e-9)
        assert float(state["elapsed"][0]) == pytest.approx(
            want_state[1], rel=1e-12, abs=1e-9)
        assert bool(state["entered"][0]) == want_state[2]
    got, want = np.concatenate(outs, -1), np.concatenate(wants, -1)
    assert np.abs(want).max() > 0.2        # the source sounds
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-5 * np.abs(want).max())


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_plain_version_equals_a_frame_by_frame_playhead(case):
    """The plain version against the frame-by-frame walk (`_against_model`).
    The reversed loop enters and falls back under loop_start inside one
    block: the entry must stick there too."""
    _against_model(case, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_kernel_equals_a_frame_by_frame_playhead(cuda, case):
    """The card's kernel, through `process`, against the same
    frame-by-frame walk and within the same bounds as the plain
    version."""
    _against_model(case, cuda)


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("name", sorted(cases.CASES))
def test_renders_match_the_kept_jax_renders(device, name):
    """Each automated-rate graph of tests/playhead_cases.py rendered on
    `device` (the kernel on a card, the plain version on the CPU) against
    the JAX package's render of it kept in tests/playhead_jax.npz
    (tests/test_torch_playhead.py holds that file to JAX): within 1e-5 x
    peak, as tests/test_torch_playhead.py holds the port to JAX, and the
    playhead after the render within 1e-9 where the source did not wrap
    (the port carries a looping playhead wrapped into its loop, the JAX
    package unwrapped)."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    before = playhead.buffer_playhead.launches
    out, position = cases.render(wt, name, device)
    launched = playhead.buffer_playhead.launches - before
    assert launched > 0 if device == "cuda" else launched == 0
    with np.load(cases.JAX_RENDERS) as kept:
        want, want_position = kept[name], float(kept[name + ".position"])
    assert out.shape == want.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    if name.startswith("one_shot") or name == "suspended":
        assert position == pytest.approx(want_position, rel=0, abs=1e-9)


def test_a_cpu_render_launches_no_kernel():
    """The CPU runs the plain version: an automated-rate source renders
    without the kernel."""
    ctx = wt.OfflineAudioContext(2, 4096, FS, device="cpu")
    src = ctx.create_buffer_source(loop=True)
    src.buffer = wt.AudioBuffer.from_array(_data(2, 3000, 3), 44100.0)
    src.playback_rate.linear_ramp_to_value_at_time(1.7, 0.05)
    src.connect(ctx.destination)
    src.start()
    before = playhead.buffer_playhead.launches
    out = ctx.start_rendering_sync().to_array()
    assert playhead.buffer_playhead.launches == before
    assert np.abs(out).max() > 0.2


def _args(device, n=2, frames=256, C=2, L=100):
    """Arguments the wrapper takes: n instances, frames, C channels."""
    z = dict(device=device)
    return dict(
        playback_rate=torch.ones((n, 1, frames), **z),
        detune=torch.zeros((), **z),
        state={"buffer_time": torch.zeros(n, dtype=torch.float64, **z),
               "elapsed": torch.zeros(n, dtype=torch.float64, **z),
               "entered": torch.zeros(n, dtype=torch.bool, **z)},
        rows=torch.zeros((1, L, 2 * C), **z), edge=torch.zeros((1, C), **z),
        frames=frames, frame0=0, consts=playhead.Constants(length=L))


def _bad(args, bad, device):
    """args with one thing the kernel does not take."""
    st, n = args["state"], args["state"]["buffer_time"].shape[0]
    z = dict(device=device)
    change = {
        "frames_not_quanta": {"frames": 200, "playback_rate": torch.ones(
            (n, 1, 200), **z)},
        "rate_rows": {"playback_rate": torch.ones((3, 1, 256), **z)},
        "rate_frames": {"detune": torch.zeros((1, 1, 128), **z)},
        "rows_odd": {"rows": torch.zeros((1, 100, 3), **z)},
        "rows_instances": {"rows": torch.zeros((3, 100, 4), **z)},
        "edge_shape": {"edge": torch.zeros((1, 3), **z)},
        "state_shape": {"state": dict(st, elapsed=torch.zeros(3, **z,
                                      dtype=torch.float64))},
        "rate_f64": {"playback_rate": args["playback_rate"].double()},
        "rows_f16": {"rows": args["rows"].half()},
        "entered_u8": {"state": dict(st, entered=st["entered"].to(
            torch.uint8))},
        "time_f32": {"state": dict(st, buffer_time=st["buffer_time"]
                                   .float())},
        "rate_strided": {"playback_rate": torch.ones((n, 1, 512), **z)[
            ..., ::2]},
        "rows_strided": {"rows": torch.zeros((1, 4, 100), **z)
                         .transpose(1, 2)},
    }
    return dict(args, **change[bad])


CPU_REFUSALS = {
    "frames_not_quanta": "whole quanta", "rate_rows": "playback_rate 0-d",
    "rate_frames": "detune 0-d", "rows_odd": "pair rows",
    "rows_instances": "pair rows", "edge_shape": "edge values",
    "state_shape": "three leaves", "rate_f64": "playback_rate is",
    "rows_f16": "rows is", "entered_u8": "entered is",
    "time_f32": "buffer_time is", "rate_strided": "contiguous",
    "rows_strided": "rows must be contiguous", "on_cpu": "CUDA device",
}


@pytest.mark.parametrize("bad", sorted(CPU_REFUSALS))
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    """Shapes, dtypes and strides are refused on any device (here on the
    CPU, where the kernel refuses every tensor), each with its own
    reason, and nothing is launched."""
    args = _args("cpu")
    if bad != "on_cpu":
        args = _bad(args, bad, "cpu")
    before = playhead.buffer_playhead.launches
    with pytest.raises(KernelError, match=CPU_REFUSALS[bad]):
        playhead.buffer_playhead(**args)
    assert playhead.buffer_playhead.launches == before


# --- on the card ------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["rate_f64", "rows_f16", "rate_strided",
                                 "rows_strided", "state_shape", "mixed",
                                 "frame0_i32", "frame0_on_cpu"])
def test_kernel_refuses_on_the_card(cuda, bad):
    args = _args(cuda)
    if bad == "mixed":
        args["edge"] = args["edge"].cpu()
    elif bad == "frame0_i32":
        args["frame0"] = torch.zeros((), dtype=torch.int32, device=cuda)
    elif bad == "frame0_on_cpu":
        args["frame0"] = torch.zeros((), dtype=torch.int64)
    else:
        args = _bad(args, bad, cuda)
    before = playhead.buffer_playhead.launches
    with pytest.raises(KernelError):
        playhead.buffer_playhead(**args)
    assert playhead.buffer_playhead.launches == before


# (n instances, R buffers, source settings, frames, frame0, rate rows,
# detune rows, the start: "before" the block (a carried state) or in it)
CARD_CASES = {
    "session_block_sub_sample_start": (
        1, 1, dict(when=100.3 / FS), 8192, 0, "ramp", "cents"),
    "session_block_at_2_26": (1, 1, dict(), 8192, 2**26, "ramp", "flat"),
    "session_block_at_4_76e8": (
        1, 1, dict(), 8192, 476_000_000, "ramp", "cents"),
    "one_shot_duration_in_block": (
        1, 1, dict(loop=False, when=(2**26 + 300.6) / FS, duration=0.1,
                   length=40000), 8192, 2**26, "ramp", "flat"),
    "backwards_sub_sample_start_at_4_76e8": (
        1, 1, dict(when=(476_000_000 + 4000.25) / FS, offset=0.2), 8192,
        476_000_000, "negative", "cents"),
    "batch_one_buffer": (64, 1, dict(), 8192, 2**26, "ramp", "cents"),
    "batch_own_buffers_start_in_block": (
        64, 64, dict(when=77.7 / FS), 8192, 0, "mixed", "cents"),
    "batch_one_shot_duration": (
        64, 64, dict(loop=False, duration=0.1, length=12000), 8192,
        476_000_000, "ramp", "cents"),
    "long_block_several_passes": (
        1, 1, dict(when=5000.5 / FS), 3 * 8192 + 1024, 0, "ramp", "cents"),
    "short_block_backwards": (
        64, 64, dict(), 2048, 2**26, "negative", "flat"),
}


def _card_inputs(case, device):
    n, R, kw, frames, frame0, rk, dk = CARD_CASES[case]
    kern, data = _kernel(device, frames, frame0, **kw)
    res = _resources(kern, data, n, R, device, 11)
    rng = np.random.default_rng(frames + n)
    L, br = kern.buf_len, kern.buf_rate
    if kern.start_frame < frame0:
        # a state carried into the block: a playhead inside the buffer
        # (the loop once entered), the elapsed time so far
        lo, hi = ((kern.loop_start * br, kern.loop_end * br) if kern.loop
                  else (0.0, L / 2))
        bt = rng.uniform(lo, hi, n)
        el = np.full(n, float(frame0 - kern.start_frame))
        if kern.duration < math.inf:
            el = kern.duration * FS - rng.uniform(1000.0, 6000.0, n)
        en = rng.random(n) < 0.7 if kern.loop else np.zeros(n, bool)
    else:
        bt, el, en = np.zeros(n), np.zeros(n), np.zeros(n, bool)
    pr = torch.from_numpy(_rows(rk, n, frames, 5)).to(device)
    dt = torch.from_numpy(_rows(dk, n, frames, 6)).to(device)
    return kern, res, pr, dt, _state(bt, el, en, device), frame0


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_kernel_equals_plain_version(cuda, case):
    """The kernel against the plain version on the same card tensors: the
    output within 1e-6 x peak, buffer_time within 1e-9 buffer samples,
    elapsed within 1e-14 relative, entered equal (they differ only in
    the order of each quantum's float64 sum).  One launch a block; a
    second launch, frame0 read from the card, and a CUDA graph of the
    launch replayed all give the first launch's bits."""
    kern, res, pr, dt, state, frame0 = _card_inputs(case, cuda)
    want_state, (want,) = _block(kern, res, pr, dt, state, frame0, cuda,
                                 plain=True)
    before = playhead.buffer_playhead.launches
    got_state, (got,) = _block(kern, res, pr, dt, state, frame0, cuda)
    torch.cuda.synchronize()
    assert playhead.buffer_playhead.launches == before + 1
    peak = float(want.abs().max())
    assert peak > 0.2
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-6 * peak
    assert torch.equal(got_state["entered"], want_state["entered"])
    assert float((got_state["buffer_time"] - want_state["buffer_time"])
                 .abs().max()) <= 1e-9
    torch.testing.assert_close(got_state["elapsed"], want_state["elapsed"],
                               rtol=1e-14, atol=1e-9)

    def same(other):
        st, (out,) = other
        return torch.equal(out, got) and all(
            torch.equal(st[k], got_state[k]) for k in got_state)

    assert same(_block(kern, res, pr, dt, state, frame0, cuda))
    assert same(_block(kern, res, pr, dt, state, frame0, cuda,
                       captured=True))
    scope = compiler.BlockScope(
        torch.tensor(frame0, dtype=torch.int64, device=cuda), pr.shape[-1],
        pr.shape[0], cuda, None, torch.arange(pr.shape[-1], device=cuda))
    scope.node_resources = res
    params = {"playback_rate": pr, "detune": dt}
    kern.process(scope, state, [], params)        # warm up outside capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = kern.process(scope, state, [], params)
    graph.replay()
    torch.cuda.synchronize()
    assert same(replayed)


@pytest.mark.cuda
def test_session_launches_the_kernel_once_a_block(cuda, monkeypatch):
    """A RenderSession (every param a dense row) walks its source through
    the kernel: one launch a block eager, and the captured steps add
    their graph's launch at each replay; the captured steps equal the
    eager session's bit for bit."""
    def steps(n):
        ctx = wt.OfflineAudioContext(2, 12 * 8192, FS, device=cuda)
        src = ctx.create_buffer_source(loop=True)
        src.buffer = wt.AudioBuffer.from_array(_data(2, 30000, 4), 44100.0)
        src.playback_rate.linear_ramp_to_value_at_time(1.6, 1.5)
        src.connect(ctx.destination)
        src.start(0.001)
        s = wt.RenderSession(ctx, quanta_per_block=64)
        before = playhead.buffer_playhead.launches
        out = np.concatenate([s.step(16384) for _ in range(n)], axis=1)
        return out, playhead.buffer_playhead.launches - before, s

    monkeypatch.setenv("WEBAUDIO_CUDA_GRAPHS", "0")
    eager, launches, _ = steps(5)
    assert launches == 10                      # two blocks a step
    monkeypatch.delenv("WEBAUDIO_CUDA_GRAPHS")
    got, launches, s = steps(5)
    assert launches == 10
    assert sum(g.replays for g in s._cg.graphs.values()) >= 3
    np.testing.assert_array_equal(got, eager)
    assert np.abs(got).max() > 0.2
