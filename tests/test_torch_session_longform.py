"""A RenderSession far into a long render, on the CPU (the resume on a card
too): a looping source's reads, its carried playhead, and save and
restore, at frames from 2^26 (25.4 minutes at 44.1 kHz) up to 2^31 - 2^17,
where the block walk's frame numbers still hold.

A session is restored from a checkpoint whose frame cursor is F and whose
source has played F frames' worth of its buffer (its playhead at F times
the buffer's rate over the context's, inside the loop), then stepped, and
compared with what the reference's playback reads there:

- a clip at the context's rate reads `dry[:, t % L]` exactly: the unit
  step's lerp weight is 0, so no arithmetic touches the samples;
- a clip at 33,075 Hz (a step of 0.75 buffer samples a frame, exact in
  binary) against a plain float64 lerp with the loop's wrap, within 1e-6:
  the port's lerp is three float32 operations on samples below 4 in
  magnitude, each rounding by at most half an ulp (3 x 2^-24 x 4 = 7.2e-7);
- a small config-3 reverb (the looping source into a convolver and a
  0.31 s feedback delay) stepped on from F, and the same steps after a
  save and a restore into a fresh context: bit-equal, as the same plan
  and kernels run on the same states; on a card too, where the session's
  source runs its playhead kernel (csrc/buffer_playhead.cu) eagerly in
  the restored steps and from CUDA graphs in the uninterrupted ones.

The file imports no JAX, so on a GPU machine without it:

    python -m pytest tests/test_torch_session_longform.py --noconftest -q

A wrap tolerance that grows with the playhead (1.5e-8 x its unwrapped
value: one sample at 2^26) reads each loop's last samples as its first,
and fails the first two.
"""

import json

import numpy as np
import pytest
import torch

import webaudio_tpu_torch as wt
from webaudio_tpu_torch.checkpoint import RenderSession
from webaudio_tpu_torch.ops.playhead import buffer_playhead

FS = 44100.0
L = 88200                      # a 2 s loop at 44.1 kHz
STEP = 16384                   # quanta_per_block=128
FRAMES = [2**26, 476_000_000, 2**31 - 2**17]


def _dry(seed=0, n=L):
    return np.random.default_rng(seed).standard_normal((2, n)).astype(
        np.float32)


def _loop(dry, rate, frames):
    """A looping source into the destination."""
    ctx = wt.OfflineAudioContext(2, frames, FS, device="cpu")
    src = ctx.create_buffer_source(loop=True)
    src.buffer = wt.AudioBuffer.from_array(dry, rate)
    src.connect(ctx.destination)
    src.start()
    return ctx


def _reverb(dry, frames, device="cpu"):
    """Config 3's graph, short: the loop into a normalized convolver and a
    0.31 s delay fed back through 0.4."""
    ctx = wt.OfflineAudioContext(2, frames, FS, device=device)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = wt.AudioBuffer.from_array(dry, FS)
    src.start()
    rng = np.random.default_rng(7)
    m = 4410
    ir = rng.standard_normal((2, m)) * np.exp(-np.arange(m) / FS / 0.03)
    verb = ctx.create_convolver()
    verb.set_buffer(wt.AudioBuffer.from_array(ir.astype(np.float32), FS))
    src.connect(verb)
    verb.connect(ctx.destination)
    d = ctx.create_delay(max_delay_time=1.0)
    d.delay_time.value = 0.31
    fb = ctx.create_gain(gain=0.4)
    src.connect(d)
    d.connect(fb)
    fb.connect(d)
    fb.connect(ctx.destination)
    return ctx


def _leaves(path):
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    return json.loads(str(arrays["__header__"])), arrays


def _moved_to(path, frame, playhead):
    """Rewrite the checkpoint at `path` as one taken at `frame`, the
    source's playhead at `playhead` buffer samples and in its loop."""
    header, arrays = _leaves(path)
    header["frame"] = int(frame)
    for i, p in enumerate(header["paths"]):
        if p.endswith("/buffer_time"):
            arrays[f"leaf_{i}"] = np.asarray(playhead, np.float64)
        elif p.endswith("/entered"):
            arrays[f"leaf_{i}"] = np.asarray(True)
    arrays["__header__"] = json.dumps(header)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def _restored_at(make, frame, playhead, tmp_path, qpb=128):
    """A fresh session of `make()` restored at `frame`."""
    path = str(tmp_path / "at.npz")
    first = RenderSession(make(), quanta_per_block=qpb)
    first.step(qpb * 128)
    first.save(path)
    _moved_to(path, frame, playhead)
    s = RenderSession(make(), quanta_per_block=qpb)
    s.restore(path)
    assert s.frame == frame
    return s


@pytest.mark.parametrize("frame", FRAMES)
def test_loop_reads_every_sample_far_into_a_render(frame, tmp_path):
    """Tolerance 0: a unit-step read copies the sample.  Six steps cross
    the loop's end wherever in the loop F falls."""
    dry = _dry()
    s = _restored_at(lambda: _loop(dry, FS, frame + 6 * STEP), frame,
                     float(frame), tmp_path)
    t = frame + np.arange(6 * STEP)
    got = np.concatenate([s.step(STEP) for _ in range(6)], axis=1)
    np.testing.assert_array_equal(got, dry[:, t % L])


@pytest.mark.parametrize("frame", FRAMES)
def test_loop_at_another_rate_far_into_a_render(frame, tmp_path):
    """Tolerance 1e-6 absolute: three float32 roundings of the lerp.  A
    loop of 22,050 buffer samples, whose end two steps (24,576 buffer
    samples) cross wherever F falls."""
    rate, r, n = 33075.0, 0.75, 22050
    dry = _dry(1, n)
    s = _restored_at(lambda: _loop(dry, rate, frame + 2 * STEP), frame,
                     frame * r, tmp_path)
    got = np.concatenate([s.step(STEP), s.step(STEP)], axis=1)
    pos = np.mod(frame * r + r * np.arange(2 * STEP), n)
    i = np.floor(pos).astype(np.int64)
    k = pos - i
    d = dry.astype(np.float64)
    want = d[:, i] * (1.0 - k) + d[:, (i + 1) % n] * k
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_carried_playhead_stays_in_the_loop(tmp_path):
    """A step far into the render carries its playhead wrapped, as the
    reference's buffer_time is: exactly (F + 16,384) mod L."""
    frame = 476_000_000
    dry = _dry()
    s = _restored_at(lambda: _loop(dry, FS, frame + STEP), frame,
                     float(frame), tmp_path)
    s.step(STEP)
    path = str(tmp_path / "after.npz")
    s.save(path)
    header, arrays = _leaves(path)
    i = next(i for i, p in enumerate(header["paths"])
             if p.endswith("/buffer_time"))
    assert float(arrays[f"leaf_{i}"]) == float((frame + STEP) % L)


@pytest.mark.parametrize("frame", [0, 2**26, 476_000_000])
def test_reverb_session_resumes_bit_equal(frame, tmp_path):
    """Tolerance 0: the steps after a save, restored into a fresh context,
    run the same plan and kernels on the same states."""
    _resumes_bit_equal(frame, tmp_path, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("frame", [0, 2**26, 476_000_000])
def test_reverb_session_resumes_bit_equal_on_the_card(frame, tmp_path):
    """The same on the card: the uninterrupted session replays its later
    steps from CUDA graphs while the restored one walks its first steps
    eagerly, and the source's playhead kernel reads frame0 from the host
    in one and from the card in the other."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    before = buffer_playhead.launches
    _resumes_bit_equal(frame, tmp_path, "cuda")
    assert buffer_playhead.launches > before


def _resumes_bit_equal(frame, tmp_path, device):
    dry = _dry(2)
    qpb = 16
    step = qpb * 128

    def make():
        return _reverb(dry, frame + 4 * step, device)

    s = _restored_at(make, frame, float(frame % L), tmp_path, qpb)
    whole = [s.step(step) for _ in range(4)]
    # the steps carry sound
    assert all(np.abs(w).max() > 0.05 for w in whole)
    path = str(tmp_path / "mid.npz")
    s2 = _restored_at(make, frame, float(frame % L), tmp_path, qpb)
    s2.step(step)
    s2.step(step)
    s2.save(path)
    r = RenderSession(make(), quanta_per_block=qpb)
    r.restore(path)
    rest = np.concatenate([r.step(step), r.step(step)], axis=1)
    np.testing.assert_array_equal(rest, np.concatenate(whole[2:], axis=1))
    assert r.frame == frame + 4 * step
