"""The automated-rate buffer-source graphs that tests/test_torch_playhead.py
renders through the JAX package and the port, and the JAX renders of them
kept in tests/playhead_jax.npz, so that a machine without JAX (a GPU
machine) holds the port's card path to the JAX package too
(tests/test_torch_playhead_kernel.py).  This module imports no JAX: each
builder takes the package it builds with.

Regenerate the renders with `python tests/test_torch_playhead.py --regen`.
"""

import os

import numpy as np

FS = 48000.0
JAX_RENDERS = os.path.join(os.path.dirname(__file__), "playhead_jax.npz")


def context(mod, channels, length, fs=FS, device="cpu"):
    """An OfflineAudioContext of `mod`; the port's on `device`."""
    if mod.__name__ == "webaudio_tpu_torch":
        return mod.OfflineAudioContext(channels, length, fs, device=device)
    return mod.OfflineAudioContext(channels, length, fs)


def data(channels, frames, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(frames)
    x = np.sin(t * rng.uniform(0.01, 0.2, (channels, 1)))
    return (0.8 * x + 0.1 * rng.standard_normal((channels, frames))
            ).astype(np.float32)


def source(mod, ctx, samples, rate, **kw):
    src = ctx.create_buffer_source(**kw)
    src.buffer = mod.AudioBuffer.from_array(samples, rate)
    return src


def automated(mod, case, length=6000, device="cpu"):
    ctx = context(mod, 2, length, device=device)
    src = source(mod, ctx, data(2, 2500, 7), 44100.0, loop=True)
    pr, dt = src.playback_rate, src.detune
    if case == "rate_ramp":
        pr.linear_ramp_to_value_at_time(2.5, length / FS)
    elif case == "rate_exp_ramp":
        pr.set_value_at_time(0.5, 0.0)
        pr.exponential_ramp_to_value_at_time(1.7, 0.1)
    elif case == "detune_ramp":
        dt.set_value_at_time(-700.0, 0.0)
        dt.linear_ramp_to_value_at_time(1200.0, 0.11)
    elif case == "set_value_at_time":
        pr.set_value_at_time(1.5, 0.02)
        pr.set_value_at_time(0.25, 0.05)
        dt.set_value_at_time(300.0, 0.07)
    elif case == "through_zero_into_reverse":
        pr.set_value_at_time(1.0, 0.0)
        pr.linear_ramp_to_value_at_time(-1.5, 0.1)
    elif case == "set_target":
        pr.set_target_at_time(0.3, 0.01, 0.02)
    src.connect(ctx.destination)
    src.start()
    return ctx


AUTOMATED = ["rate_ramp", "rate_exp_ramp", "detune_ramp", "set_value_at_time",
             "through_zero_into_reverse", "set_target"]


def looped(mod, loop_start, loop_end, start, offset, duration, rate_to,
           device="cpu"):
    ctx = context(mod, 1, 8192, device=device)
    src = source(mod, ctx, data(1, 3000, 3), FS, loop=True,
                 loop_start=loop_start, loop_end=loop_end)
    src.playback_rate.set_value_at_time(0.8, 0.0)
    src.playback_rate.linear_ramp_to_value_at_time(rate_to, 8192 / FS)
    src.connect(ctx.destination)
    src.start(start, offset, duration)
    return ctx


LOOPED = [
    (0.01, 0.04, 0.0, None, None, 2.0),        # loop points, forward
    (0.01, 0.04, 0.0, 0.05, None, -1.5),       # offset past the loop, reverse
    (0.0, 0.0, 0.0, None, None, 1.3),          # whole-buffer loop
    (0.02, 0.03, 1001.37 / FS, 0.001, None, 1.6),   # sub-sample start
    (0.01, 0.05, 0.003, 0.0, 0.07, 2.2),       # the duration limit
]


def one_shot(mod, start, offset, duration, device="cpu"):
    ctx = context(mod, 2, 6144, device=device)
    src = source(mod, ctx, data(2, 2000, 5), 22050.0)
    src.detune.set_value_at_time(-1200.0, 0.0)
    src.detune.linear_ramp_to_value_at_time(900.0, 0.1)
    src.connect(ctx.destination)
    src.start(start, offset, duration)
    return ctx


ONE_SHOT = [(0.0, None, None), (333.5 / FS, 0.01, None), (0.002, 0.0, 0.03)]


def two_blocks(mod, length=48000 * 3 + 77, device="cpu"):
    """A lowpass after the source makes the plan prefer power-of-two
    blocks, so the render spans two."""
    ctx = context(mod, 2, length, device=device)
    src = source(mod, ctx, data(2, 9000, 9), 44100.0, loop=True,
                 loop_start=0.05, loop_end=0.18)
    src.playback_rate.set_value_at_time(0.7, 0.0)
    src.playback_rate.linear_ramp_to_value_at_time(1.9, 2.0)
    src.detune.set_value_at_time(150.0, 1.1)
    filt = ctx.create_biquad_filter(frequency=5000.0)
    src.connect(filt)
    filt.connect(ctx.destination)
    src.start(0.01)
    return ctx


def suspended(mod, device="cpu"):
    ctx = context(mod, 1, 12000, device=device)
    src = source(mod, ctx, data(1, 4000, 13), FS, loop=True,
                 loop_start=0.02, loop_end=0.07)
    src.playback_rate.set_value_at_time(1.2, 0.0)
    src.playback_rate.linear_ramp_to_value_at_time(0.6, 0.1)

    def bend(c):
        src.playback_rate.linear_ramp_to_value_at_time(-0.9, 0.24)
        src.detune.set_value_at_time(200.0, 0.15)

    ctx.suspend_sync(0.08, bend)
    src.connect(ctx.destination)
    src.start(0.004)
    return ctx


def playback_position(ctx):
    """The source's playhead after a render (its `position`)."""
    (src,) = [n for n in ctx._nodes.values() if hasattr(n, "playback_rate")]
    return src.position


# name -> (builder, its arguments): every case kept in JAX_RENDERS
CASES = {**{f"automated.{c}": (automated, (c,)) for c in AUTOMATED},
         **{f"looped.{i}": (looped, a) for i, a in enumerate(LOOPED)},
         **{f"one_shot.{i}": (one_shot, a) for i, a in enumerate(ONE_SHOT)},
         "two_blocks": (two_blocks, ()), "suspended": (suspended, ())}


def render(mod, name, device="cpu"):
    """(the case's render as a host array, the source's playhead after
    it)."""
    build, args = CASES[name]
    ctx = build(mod, *args, device=device)
    out = np.asarray(ctx.start_rendering_sync().to_array())
    return out, playback_position(ctx)
