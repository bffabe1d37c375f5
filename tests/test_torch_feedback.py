"""The constant feedback-delay loop (`webaudio_tpu_torch/ops/feedback.py`):
its plain version against a frame-by-frame walk of the recurrence on the
CPU, and on the card the CUDA kernel against the plain version, a captured
walk of a fused loop against the eager one, its launch count, and what the
wrapper refuses.  The renders' bit-equality with the stepped walk and the
JAX package is in tests/test_torch_cycles.py.

The file imports no JAX, so on a GPU machine without it:

    python -m pytest tests/test_torch_feedback.py --noconftest -q
"""

import numpy as np
import pytest
import torch

import webaudio_tpu_torch as wt
from webaudio_tpu_torch.graph import compiler
from webaudio_tpu_torch.ops import feedback
from webaudio_tpu_torch.ops.cuda_lib import KernelError

FS = 44100.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _sequential(ring, x, frames, shift, wa, wb, gains, frame0):
    """The recurrence one frame at a time, in numpy f32."""
    ring = ring.copy()
    N, C, R = ring.shape
    r = np.zeros((N, C, frames), np.float32)
    y = np.zeros_like(r)
    wa, wb = np.float32(wa), np.float32(wb)
    for n in range(frames):
        t = frame0 + n
        p = t - shift
        bw = ring[..., (p + 1) % R] * wb
        rv = (ring[..., p % R] * wa + bw if p >= 0
              else bw if p == -1 else np.zeros_like(bw))
        yv = rv
        for g in gains:
            yv = yv * np.float32(g)
        ring[..., t % R] = yv if x is None else x[..., n] + yv
        r[..., n], y[..., n] = rv, yv
    return r, y, ring


def _inputs(N, C, R, frames, x_rows, seed):
    rng = np.random.default_rng(seed)
    ring = rng.standard_normal((N, C, R)).astype(np.float32)
    x = (None if x_rows is None else
         rng.standard_normal((x_rows, C, frames)).astype(np.float32))
    return ring, x


def _read(delay_frames):
    """`_DelayKernel.const_read` for a delay of `delay_frames` (shift, wa,
    wb), as nodes/delay.py computes it."""
    n = int(np.floor(delay_frames))
    k0 = np.float32(delay_frames - n)
    if k0 == 0.0:
        return n, 1.0, 0.0
    ks = np.float32(1.0) - k0
    return n + 1, float(np.float32(1.0) - ks), float(ks)


# (N, C, R, shift as delay frames, frames, frame0, gains, x instances)
CPU_CASES = [
    (1, 1, 40, 7.0, 100, 0, (0.5,), 1),          # the first block: silence
    (2, 2, 40, 7.25, 100, 3, (), None),          # k = 0, no outside signal
    (3, 2, 64, 20.6, 130, 75, (0.9, -0.7), 1),   # shared x, the ring's end
    (2, 1, 32, 31.0, 90, 1000, (1.5,), 2),       # runs of 1 frame (R - shift)
]


@pytest.mark.parametrize("N,C,R,delay,frames,frame0,gains,xr", CPU_CASES)
def test_plain_version_equals_the_frame_by_frame_recurrence(
        N, C, R, delay, frames, frame0, gains, xr):
    ring, x = _inputs(N, C, R, frames, xr, seed=R + frames)
    shift, wa, wb = _read(delay)
    want = _sequential(ring, x, frames, shift, wa, wb, gains, frame0)
    ring_t = torch.from_numpy(ring)
    got = feedback.feedback_delay(
        ring_t, None if x is None else torch.from_numpy(x), frames, shift,
        wa, wb, gains, frame0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert np.array_equal(ring_t.numpy(), ring)        # the input is kept
    if not gains:
        assert got[1] is got[0]


@pytest.mark.parametrize("bad", ["ring_2d", "x_channels", "x_frames",
                                 "shift_1", "shift_R", "gains"])
def test_wrapper_refuses_wrong_shapes_on_any_device(bad):
    ring = torch.zeros((2, 2, 64))
    x = torch.zeros((2, 2, 100))
    args = dict(ring=ring, x=x, frames=100, shift=10, wa=1.0, wb=0.0,
                gains=(0.5,), frame0=0)
    args.update({"ring_2d": {"ring": ring[0]},
                 "x_channels": {"x": x[:, :1]},
                 "x_frames": {"x": x[..., :99]},
                 "shift_1": {"shift": 1},
                 "shift_R": {"shift": 64},
                 "gains": {"gains": (0.5,) * 17}}[bad])
    with pytest.raises(KernelError):
        feedback.feedback_delay(**args)


# --- on the card ------------------------------------------------------------

# (N, C, R, delay frames, frames, frame0, gains, x instances): config 3's
# bounce block (R 61,440, 13,671.0001 frames, 442,368 frames a block) from
# frame 0 and across the ring's end; integer and fractional delays; a
# batch of 8; blocks shorter than the ring and than the delay; a ring of
# one frame more than the delay (runs of one frame); a 3 s delay in a
# ring that holds less than two of it (runs of R - shift frames)
CARD_CASES = [
    (1, 2, 61440, 13671.000105, 442368, 0, (0.4,), 1),
    (1, 2, 61440, 13671.000105, 442368, 884736, (0.4,), 1),
    (8, 1, 61440, 13671.0, 442368, 3 * 61440 - 5000, (0.4,), 8),
    (8, 2, 12288, 4410.3, 98304, 0, (0.9, -0.7), 1),
    (1, 1, 12288, 4410.5, 98304, 77777, (), None),
    (8, 2, 384, 200.25, 1000, 300, (0.5,), 8),
    (2, 2, 8192, 1000.5, 3000, 5000, (0.5,), 2),     # B < R: slots carried
    (1, 2, 61440, 13671.000105, 8192, 0, (0.4,), 1),  # B < shift: one run
    (1, 2, 32, 31.0, 90, 1000, (1.5,), 1),
    (1, 2, 196608, 132300.25, 442368, 150000, (0.4,), 1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("N,C,R,delay,frames,frame0,gains,xr", CARD_CASES)
@pytest.mark.parametrize("frame0_on", ["host", "card"])
def test_kernel_equals_plain_version(cuda, N, C, R, delay, frames, frame0,
                                     gains, xr, frame0_on):
    ring, x = _inputs(N, C, R, frames, xr, seed=R + frames + N)
    shift, wa, wb = _read(delay)
    ring_t = torch.from_numpy(ring)
    x_t = None if x is None else torch.from_numpy(x)
    want = feedback.feedback_delay_reference(ring_t, x_t, frames, shift, wa,
                                             wb, gains, frame0)
    ring_d = ring_t.to(cuda)
    f0 = (frame0 if frame0_on == "host" else
          torch.tensor(frame0, dtype=torch.int64, device=cuda))
    before = feedback.feedback_delay.launches
    got = feedback.feedback_delay(ring_d, None if x_t is None
                                  else x_t.to(cuda), frames, shift, wa, wb,
                                  gains, f0)
    torch.cuda.synchronize()
    assert feedback.feedback_delay.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert torch.equal(ring_d.cpu(), ring_t)           # the input is kept


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["ring_f64", "x_f16", "ring_strided",
                                 "x_strided", "frame0_i32", "x_on_cpu",
                                 "frame0_on_cpu"])
def test_kernel_refuses_what_it_does_not_take(cuda, bad):
    ring = torch.zeros((2, 2, 64), device=cuda)
    x = torch.zeros((2, 2, 100), device=cuda)
    args = dict(ring=ring, x=x, frames=100, shift=10, wa=1.0, wb=0.0,
                gains=(0.5,), frame0=0)
    args.update({
        "ring_f64": {"ring": ring.double()},
        "x_f16": {"x": x.half()},
        "ring_strided": {"ring": torch.zeros((2, 2, 128), device=cuda)[
            ..., ::2]},
        "x_strided": {"x": torch.zeros((2, 100, 2), device=cuda)
                      .transpose(1, 2)},
        "frame0_i32": {"frame0": torch.zeros((), dtype=torch.int32,
                                             device=cuda)},
        "x_on_cpu": {"x": x.cpu()},
        "frame0_on_cpu": {"frame0": torch.zeros((), dtype=torch.int64)},
    }[bad])
    before = feedback.feedback_delay.launches
    with pytest.raises(KernelError):
        feedback.feedback_delay(**args)
    assert feedback.feedback_delay.launches == before


def _reverb(device, seconds):
    """Config 3's graph with a short IR and a 0.05 s delay, which plans
    blocks of 118,784 frames: a looping stereo source into a convolver and
    a delay fed back through 0.4."""
    rng = np.random.default_rng(7)
    frames = int(FS * seconds)
    ctx = wt.OfflineAudioContext(2, frames, FS, device=device)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = wt.AudioBuffer.from_array(
        (0.3 * rng.standard_normal((2, 44100))).astype(np.float32), FS)
    n = 11025
    ir = rng.standard_normal((2, n)) * np.exp(-np.arange(n) / 4000.0)
    verb = ctx.create_convolver(
        buffer=wt.AudioBuffer.from_array(ir.astype(np.float32), FS))
    d = ctx.create_delay(max_delay_time=1.0, delay_time=0.05)
    fb = ctx.create_gain(gain=0.4)
    src.connect(verb)
    verb.connect(ctx.destination)
    src.connect(d)
    d.connect(fb)
    fb.connect(d)
    fb.connect(ctx.destination)
    src.start()
    return ctx


@pytest.mark.cuda
def test_captured_walk_of_a_fused_loop_equals_eager(cuda, monkeypatch):
    """A multi-block walk of config 3's graph, captured as CUDA graphs and
    replayed (frame0 read on the card), equals its eager walk bit for bit
    and the CPU's render; each walk launches the kernel once a block.  The
    first walk after the eager one marks the blocks, the next captures."""
    ctx = _reverb(cuda, 8.0)
    cg = compiler.compile_graph(dict(ctx._nodes), list(ctx._edges),
                                ctx.sample_rate, ctx.length,
                                ctx._destination.node_id, ctx.device)
    nb = -(-ctx.length // cg.block_frames)
    assert cg.cycle_paths == ["fused"] and cg.capture is True and nb == 3
    monkeypatch.setenv("WEBAUDIO_CUDA_GRAPHS", "0")
    before = feedback.feedback_delay.launches
    eager, _ = compiler.render_compiled(cg, ctx.length)
    assert feedback.feedback_delay.launches == before + nb
    monkeypatch.delenv("WEBAUDIO_CUDA_GRAPHS")
    for _ in range(2):
        before = feedback.feedback_delay.launches
        got, _ = compiler.render_compiled(cg, ctx.length)
        torch.cuda.synchronize()
        assert feedback.feedback_delay.launches == before + nb
        assert torch.equal(got, eager)
    assert cg.graphs and any(g.replays for g in cg.graphs.values())
    cpu = _reverb("cpu", 8.0).start_rendering_sync().to_array()
    np.testing.assert_allclose(eager[:, :ctx.length].cpu().numpy(), cpu,
                               rtol=0, atol=1e-5 * np.abs(cpu).max())
