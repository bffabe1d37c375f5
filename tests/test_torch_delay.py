"""The DelayNode on the port (webaudio_tpu_torch) against the JAX package,
on the CPU, outside a feedback cycle.

The delay kernel is stepped block by block beside the JAX package's kernel
and a numpy delay line (the written signal, lerped at t - delay * fs, silent
before the first written sample), on seeded inputs: constant integer and
fractional delays, delays longer than a block, a-rate ramps, the in-cycle
clamp to one quantum, and blocks that cross the ring's end.  Whole renders
through both packages hold to 1e-6 x peak.  Cycles are in
tests/test_torch_cycles.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import webaudio_tpu as wa
import webaudio_tpu_torch as wt
from webaudio_tpu.graph import compiler as jcomp
from webaudio_tpu.nodes import delay as jdelay
from webaudio_tpu_torch.graph import compiler as tcomp
from webaudio_tpu_torch.nodes import delay as tdelay

FS = 48000.0
MAX_DELAY = 0.01                      # 480 frames


def _ring(block):
    # DelayNode.make_kernel's ring length, in both packages
    max_frames = int(math.ceil(MAX_DELAY * FS))
    return (-(-(max_frames + block + 1) // block)) * block


def _oracle(x, delay_frames, in_cycle):
    """numpy delay line: y[t] = lerp of x at t - d, with the f64 position
    and the f32 weight of the reference (delay.rs:688-706); x before 0 is
    silence.  x (C, T) f32, delay_frames a scalar or (T,) in frames."""
    C, T = x.shape
    d = np.broadcast_to(np.asarray(delay_frames, np.float64), (T,))
    if in_cycle:
        d = np.maximum(d, 128.0)
    pos = np.arange(T, dtype=np.float64) - d
    prev = np.floor(pos).astype(np.int64)
    k = (pos - prev).astype(np.float32)
    xp = np.concatenate([np.zeros((C, 1), np.float32), x], axis=1)
    a = xp[:, np.clip(prev + 1, 0, T)] * (prev >= 0)
    b = xp[:, np.clip(prev + 2, 0, T)] * (prev + 1 >= 0)
    return (np.float32(1.0) - k) * a + k * b


CASES = {
    # name: (block, delay in frames, in_cycle, first frame)
    "integer": (64, 100.0, False, 0),
    "fractional": (64, 100.37, False, 0),
    "longer_than_a_block": (64, 431.75, False, 0),
    "zero": (128, 0.0, False, 0),
    "in_cycle_clamped": (64, 3.5, True, 0),
    "arate_ramp": (64, "ramp", False, 0),
    "arate_in_cycle": (128, "ramp", True, 0),
    "block_crosses_ring_end": (256, 220.5, False, 640),
}


@pytest.mark.parametrize("case", list(CASES))
def test_delay_kernel_steps_match_jax_and_a_delay_line(case):
    B, delay, in_cycle, f_start = CASES[case]
    R = _ring(B)
    nb = 3 * R // B + 2                    # the ring wraps three times
    T = f_start + nb * B
    rng = np.random.default_rng(11)
    x = rng.uniform(-1.0, 1.0, (2, T)).astype(np.float32)
    x[:, :f_start] = 0.0
    if delay == "ramp":
        frames = np.linspace(0.0, 470.0, T)
        dense = (frames / FS).astype(np.float32)
        const = None
    else:
        dense = None
        const = float(np.float32(delay / FS))
    d_frames = (dense.astype(np.float64) if dense is not None
                else np.float64(const)) * FS

    tk = tdelay._DelayKernel(2, R, FS, in_cycle, const, "cpu")
    jk = jdelay._DelayKernel(2, R, B, FS, in_cycle)
    tstate = {"ring": tk.init_state()["ring"][None]}
    jstate = jk.init_state()
    got, ref = [], []
    for f0 in range(f_start, T, B):
        blk = x[:, f0:f0 + B]
        if dense is None:
            tp = torch.tensor(const, dtype=torch.float32)
            jp = jnp.float32(const)
        else:
            tp = torch.from_numpy(dense[f0:f0 + B].copy())[None, None]
            jp = jnp.asarray(dense[f0:f0 + B])
        tsc = tcomp.BlockScope(f0, B, 1, "cpu")
        jsc = jcomp.BlockScope(jnp.int32(f0), B, FS)
        if in_cycle:                      # the reader reads before the write
            tstate, (y,) = tk.process_reader(tsc, tstate, {"delay_time": tp})
            tstate = tk.process_writer(tsc, tstate,
                                       [torch.from_numpy(blk)[None]], {})
        else:
            tstate = tk.process_writer(tsc, tstate,
                                       [torch.from_numpy(blk)[None]], {})
            tstate, (y,) = tk.process_reader(tsc, tstate, {"delay_time": tp})
        got.append(y[0].numpy())
        if f0 % B == 0:
            # JAX writes a block that crosses the ring's end clamped
            # (dynamic_update_slice): it is held only where frames align
            if in_cycle:
                jstate, (jy,) = jk.process_reader(jsc, jstate,
                                                  {"delay_time": jp})
                jstate = jk.process_writer(jsc, jstate, [jnp.asarray(blk)], {})
            else:
                jstate = jk.process_writer(jsc, jstate, [jnp.asarray(blk)], {})
                jstate, (jy,) = jk.process_reader(jsc, jstate,
                                                  {"delay_time": jp})
            ref.append(np.asarray(jy))
    got = np.concatenate(got, axis=1)
    want = _oracle(x, d_frames, in_cycle)[:, f_start:]
    peak = float(np.abs(want).max())
    assert peak > 0.5
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * peak)
    if ref and f_start % B == 0:
        np.testing.assert_allclose(got, np.concatenate(ref, axis=1), rtol=0,
                                   atol=1e-6 * peak)


def test_constant_delay_reads_offsets_from_the_plan_on_the_host():
    # the read offset and weights are host numbers baked at make_kernel,
    # so the reader never reads the 0-d constant back from the device
    ctx = wt.OfflineAudioContext(1, 4096, FS, device="cpu")
    d = ctx.create_delay(max_delay_time=MAX_DELAY, delay_time=100.37 / FS)
    ctx.create_constant_source().connect(d)
    d.connect(ctx.destination)
    cg = tcomp.compile_graph(dict(ctx._nodes), list(ctx._edges), FS, 4096,
                             ctx._destination.node_id, "cpu")
    kern = cg.kernels[d.node_id]
    num = float(np.float32(100.37 / FS)) * FS
    k0 = np.float32(num - math.floor(num))
    assert kern.const_read == (101, float(k0), float(np.float32(1.0) - k0))


def _context(mod, channels, length):
    if mod is wt:
        return wt.OfflineAudioContext(channels, length, FS, device="cpu")
    return wa.OfflineAudioContext(channels, length, FS)


def delay_line(mod, length, delay, start=0.0, suspend=None):
    """seeded stereo noise -> DelayNode -> destination, outside a cycle."""
    ctx = _context(mod, 2, length)
    rng = np.random.default_rng(5)
    data = rng.uniform(-0.8, 0.8, (2, length)).astype(np.float32)
    src = ctx.create_buffer_source()
    src.buffer = mod.AudioBuffer.from_array(data, FS)
    d = ctx.create_delay(max_delay_time=0.1)
    if delay == "ramp":
        d.delay_time.set_value_at_time(10.5 / FS, 0.0)
        d.delay_time.linear_ramp_to_value_at_time(3000.25 / FS, length / FS)
    else:
        d.delay_time.value = delay / FS
    src.connect(d)
    d.connect(ctx.destination)
    src.start(start)
    if suspend is not None:
        ctx.suspend_sync(suspend / FS, lambda c: None)
    return ctx


RENDERS = {
    "integer": dict(delay=240.0),
    "fractional": dict(delay=240.6),
    "arate_ramp": dict(delay="ramp"),
    "reads_before_the_first_sample": dict(delay=1000.25, start=700.0 / FS),
    # two segments of 4096 frames: the same plan, so the ring crosses the
    # suspend, and the 3000-frame read reaches into the first segment
    "across_a_suspend": dict(delay=3000.5, suspend=4096),
}


@pytest.mark.parametrize("case", list(RENDERS))
def test_delay_render_matches_jax(case):
    length = 8192
    outs = [delay_line(mod, length, **RENDERS[case]).start_rendering_sync()
            .to_array() for mod in (wt, wa)]
    peak = float(np.abs(outs[1]).max())
    assert peak > 0.5
    np.testing.assert_allclose(outs[0], outs[1], rtol=0, atol=1e-6 * peak)


def test_delay_validation_as_jax():
    for mod in (wt, wa):
        ctx = _context(mod, 1, 128)
        for bad in (0.0, 180.0, -1.0):
            with pytest.raises(mod.NotSupportedError):
                ctx.create_delay(max_delay_time=bad)
        d = ctx.create_delay(max_delay_time=2.0, delay_time=0.5)
        assert d.max_delay_time == 2.0 and d.delay_time.value == 0.5
        assert d.delay_time.max_value == 2.0
        assert type(d).is_cycle_breaker
