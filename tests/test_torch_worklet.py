"""User code on the port (webaudio_tpu_torch): AudioWorkletNode and
ScriptProcessorNode against the JAX package, on the CPU.

- tests/test_worklet_and_online.py's worklet and script-processor cases
  (:47, :62, :77, :97, :360, :410) on the port, each against JAX's render
  of the same graph with the same processor written in PyTorch.
- The PyTorch port of examples/worklet_bitcrusher.py's processor
  (chip_smoke.py::bitcrusher_processor) against the JAX example's on the
  same graph, and against a per-sample numpy oracle on its recorded input:
  equal apart from rounding-boundary flips (a sample one quantization step
  off where the inputs, or the f32 pow of the two frameworks, put the
  quantizer's input within 1e-6 of a rounding boundary).
- Under the instance axis: a 4-instance GraphBatch runs the processor under
  torch.func.vmap and equals four single renders; a processor that cannot
  be vmapped runs per instance; one that raises fails its node, silently
  for the rest of the graph, with onprocessorerror called.
- The script processor's two-buffer latency is exact with blocks longer
  and shorter than its buffer (a 128-frame RenderSession) and per
  instance of a batch.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import webaudio_tpu as wa
import webaudio_tpu_torch as wt
from webaudio_tpu.checkpoint import RenderSession as JSession
from webaudio_tpu.param import (
    AudioParamDescriptor as JDesc, AutomationRate as JRate,
)
from webaudio_tpu_torch.checkpoint import RenderSession
from webaudio_tpu_torch.param import AudioParamDescriptor, AutomationRate
from webaudio_tpu_torch.parallel.segments import (
    NotTimeShardableError, render_time_sharded,
)

FS = 48000.0


def _context(mod, channels, length, fs=FS):
    if mod is wt:
        return wt.OfflineAudioContext(channels, length, fs, device="cpu")
    return wa.OfflineAudioContext(channels, length, fs)


# --- processors, one per package --------------------------------------------

class TBitcrusher(wt.AudioWorkletProcessor):
    @classmethod
    def parameter_descriptors(cls):
        return [AudioParamDescriptor("bits", AutomationRate.K, 8.0, 1.0,
                                     16.0)]

    def process(self, scope, state, inputs, params):
        steps = 2.0 ** params["bits"]
        return state, [torch.round(inputs[0] * steps) / steps]


class JBitcrusher(wa.AudioWorkletProcessor):
    @classmethod
    def parameter_descriptors(cls):
        return [JDesc("bits", JRate.K, 8.0, 1.0, 16.0)]

    def process(self, scope, state, inputs, params):
        steps = 2.0 ** params["bits"]
        return state, [jnp.round(inputs[0] * steps) / steps]


class JExampleCrusher(wa.AudioWorkletProcessor):
    """examples/worklet_bitcrusher.py's processor (the example renders a
    WAV file at import, so its class is restated here)."""

    @classmethod
    def parameter_descriptors(cls):
        return [JDesc("bit_depth", JRate.A, 12.0, 1.0, 16.0),
                JDesc("frequency_reduction", JRate.A, 0.5, 0.0, 1.0)]

    def init_state(self, render_ctx):
        return {"phase": jnp.zeros((), jnp.float32),
                "held": jnp.zeros((max(1, render_ctx.input_channel_counts[0]),),
                                  jnp.float32)}

    def process(self, scope, state, inputs, params):
        x = inputs[0]
        B = x.shape[1]
        depth = jnp.broadcast_to(params["bit_depth"], (B,))
        fred = jnp.broadcast_to(params["frequency_reduction"], (B,))
        step = jnp.power(0.5, depth)
        quant = step * jnp.floor(x / step + 0.5)
        P = state["phase"] + jnp.cumsum(fred)
        trig = P > (1.0 + jnp.maximum(0.0, jnp.ceil(
            jnp.concatenate([state["phase"][None], P[:-1]]) - 1.0)))
        phase_out = P[-1] - jnp.maximum(0.0, jnp.ceil(P[-1] - 1.0))
        idx = jnp.where(trig, jnp.arange(B), -1)
        last_idx = jax.lax.cummax(idx)
        held0 = state["held"][:, None]
        out = jnp.where(last_idx[None, :] >= 0,
                        jnp.take(quant, jnp.maximum(last_idx, 0), axis=1),
                        held0)
        return {"phase": phase_out, "held": out[:, -1]}, [out]


def crusher(mod, frames, depth_end=4.0, raw=False, proc=None):
    """chip_smoke.crusher_context's graph on either package, cut to
    `frames`: bench.py's looping buffer -> lowpass 2000 Hz, Q 2 (left out
    when `raw`) -> the bitcrusher, bit_depth 16 -> depth_end a-rate,
    frequency_reduction 0.5."""
    ctx = _context(mod, 2, frames)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = mod.AudioBuffer.from_array(chip_smoke._bench_data(), FS)
    src.start()
    head = src
    if not raw:
        head = ctx.create_biquad_filter(type="lowpass", frequency=2000.0,
                                        q=2.0)
        src.connect(head)
    proc = proc or (chip_smoke.bitcrusher_processor(wt) if mod is wt
                    else JExampleCrusher)
    node = ctx.create_audio_worklet(proc)
    node.parameters["bit_depth"].set_value_at_time(16.0, 0.0)
    node.parameters["bit_depth"].linear_ramp_to_value_at_time(
        depth_end, frames / FS)
    node.parameters["frequency_reduction"].value = chip_smoke.CRUSH_FRED
    head.connect(node)
    node.connect(ctx.destination)
    return ctx, node


# --- tests/test_worklet_and_online.py on the port ---------------------------

def test_worklet_bitcrusher():
    """:47: a constant through a 4-bit crusher."""
    outs = []
    for mod, proc in ((wt, TBitcrusher), (wa, JBitcrusher)):
        ctx = _context(mod, 1, 512)
        src = ctx.create_constant_source(offset=0.3337)
        node = ctx.create_audio_worklet(proc, parameter_data={"bits": 4})
        src.connect(node)
        node.connect(ctx.destination)
        src.start()
        outs.append(ctx.start_rendering_sync().get_channel_data(0))
        assert "bits" in node.parameters
    np.testing.assert_allclose(outs[0], np.round(0.3337 * 16) / 16,
                               atol=1e-6)
    np.testing.assert_array_equal(*outs)


def test_worklet_param_automation():
    """:62: a k-rate param automated mid-render."""
    outs = []
    for mod, proc in ((wt, TBitcrusher), (wa, JBitcrusher)):
        ctx = _context(mod, 1, 256)
        src = ctx.create_constant_source(offset=1.0)
        node = ctx.create_audio_worklet(proc)
        node.parameters["bits"].set_value_at_time(1.0, 128 / FS)
        src.connect(node)
        node.connect(ctx.destination)
        src.start()
        outs.append(ctx.start_rendering_sync().get_channel_data(0))
    assert outs[0][0] == pytest.approx(1.0)
    assert outs[0][200] == pytest.approx(1.0)
    np.testing.assert_array_equal(*outs)


def test_worklet_message_port():
    """:77: both directions, and messages posted before a handler exists
    wait for it."""
    ctx = _context(wt, 1, 128)
    node = ctx.create_audio_worklet(TBitcrusher)
    received = []
    node._proc_port.set_onmessage(lambda m: received.append(m))
    node.port.post_message({"hello": 1})
    back = []
    node.port.set_onmessage(lambda m: back.append(m))
    node._proc_port.post_message("pong")
    assert received == [{"hello": 1}]
    assert back == ["pong"]
    early = []
    a, b = wt.MessagePort.pair()
    a.post_message("before")
    b.set_onmessage(early.append)
    assert early == ["before"]


def _ramp_buffer(mod, n):
    ctx = _context(mod, 1, n)
    x = np.arange(1, n + 1, dtype=np.float32) / n
    buf = ctx.create_buffer(1, n, FS)
    buf.copy_to_channel(x, 0)
    return ctx, buf, x


def test_script_processor_passthrough_with_latency():
    """:97: the two-buffer latency (reference: script_processor.rs:190-275),
    as JAX renders it."""
    bufsize, n = 256, 2048
    outs = []
    for mod in (wt, wa):
        ctx, buf, x = _ramp_buffer(mod, n)
        src = ctx.create_buffer_source()
        src.buffer = buf
        sp = ctx.create_script_processor(bufsize, 1, 1)

        def handler(ev):
            ev.output_buffer[:] = ev.input_buffer * 2.0

        sp.set_onaudioprocess(handler)
        src.connect(sp)
        sp.connect(ctx.destination)
        src.start()
        outs.append(ctx.start_rendering_sync().get_channel_data(0))
    out = outs[0]
    np.testing.assert_array_equal(out[: 2 * bufsize], 0.0)
    np.testing.assert_allclose(out[2 * bufsize:], 2.0 * x[: n - 2 * bufsize],
                               atol=1e-6)
    np.testing.assert_array_equal(*outs)


def test_script_processor_blocks_shorter_than_its_buffer():
    """A 128-frame RenderSession (blocks < buffer_size): the buffer is
    processed at the block that completes it, with the same latency, and
    the playback times the handler sees are JAX's."""
    bufsize, n = 512, 4096
    outs, times = [], []
    for mod, S in ((wt, RenderSession), (wa, JSession)):
        ctx, buf, x = _ramp_buffer(mod, n)
        src = ctx.create_buffer_source()
        src.buffer = buf
        sp = ctx.create_script_processor(bufsize, 1, 1)
        seen = []

        def handler(ev, seen=seen):
            seen.append(float(ev.playback_time))
            ev.output_buffer[:] = ev.input_buffer * 2.0

        sp.set_onaudioprocess(handler)
        src.connect(sp)
        sp.connect(ctx.destination)
        src.start()
        s = S(ctx, quanta_per_block=1)
        outs.append(np.concatenate([s.step(1024)[0] for _ in range(4)]))
        times.append(seen)
        assert s._cg.block_frames == 128
    out = outs[0]
    np.testing.assert_array_equal(out[: 2 * bufsize], 0.0)
    np.testing.assert_array_equal(out[2 * bufsize:],
                                  2.0 * x[: n - 2 * bufsize])
    np.testing.assert_array_equal(*outs)
    assert times[0] == pytest.approx(times[1]) and len(times[0]) == 8


def test_script_processor_per_instance_of_a_batch():
    """In a GraphBatch the handler runs once per buffer and instance, each
    with that instance's input."""
    bufsize, n = 256, 2048
    ctx, buf, x = _ramp_buffer(wt, n)
    src = ctx.create_buffer_source()
    src.buffer = buf
    sp = ctx.create_script_processor(bufsize, 1, 1)
    calls = []

    def handler(ev):
        calls.append(ev.input_buffer[0, 0])
        ev.output_buffer[:] = ev.input_buffer * 2.0

    sp.set_onaudioprocess(handler)
    src.connect(sp)
    sp.connect(ctx.destination)
    src.start()
    gb = wt.GraphBatch(ctx, batch=3)
    gb.override_buffer(src, np.stack([x[None] * (i + 1) for i in range(3)]))
    out = gb.render().numpy()[:, 0, :n]
    assert len(calls) == 3 * n // bufsize
    for i in range(3):
        np.testing.assert_array_equal(out[i, : 2 * bufsize], 0.0)
        np.testing.assert_array_equal(
            out[i, 2 * bufsize:], 2.0 * (i + 1) * x[: n - 2 * bufsize])



class TScale(wt.AudioWorkletProcessor):
    """Scales its input by `processor_options["scale"]`."""

    def __init__(self, options=None, port=None):
        super().__init__(options, port)
        self.scale = float(self.options.get("scale", 1.0))

    def process(self, scope, state, inputs, params):
        return state, [inputs[0] * self.scale]


def _lanes_equal_own_renders(make, scales):
    """A MixedGraphBatch of make(s) for each s splits into one bucket an
    instance, and each lane equals its context's own render (1e-6 x
    peak)."""
    mb = wt.MixedGraphBatch([make(s) for s in scales])
    outs = mb.render()
    assert mb.num_buckets == len(scales)
    for s, out in zip(scales, outs):
        own = make(s).start_rendering_sync().to_array()
        peak = float(np.abs(own).max())
        assert peak > 0.1 and np.median(own) == pytest.approx(s, abs=1e-6)
        assert float(np.abs(out - own).max()) <= 1e-6 * peak


def test_worklet_processor_options_do_not_bleed_across_lanes():
    """tests/test_mixed_batch.py:240 on the port: two contexts that differ
    only in a worklet's processor_options bucket apart (the processor
    instance is fingerprinted by identity), each lane with its own
    options."""

    def make(scale):
        ctx = _context(wt, 1, 2048)
        src = ctx.create_constant_source(offset=1.0)
        src.start()
        w = wt.AudioWorkletNode(ctx, TScale,
                                processor_options={"scale": scale})
        src.connect(w)
        w.connect(ctx.destination)
        return ctx

    _lanes_equal_own_renders(make, (0.25, 0.75))


def test_script_processor_handlers_do_not_bleed_across_lanes():
    """Two contexts whose script processors' handlers differ (scaling by
    0.25 and 0.75) bucket apart on the port (the handler is fingerprinted
    by identity; the JAX package shares the first lane's), each lane with
    its own handler."""
    bufsize, n = 256, 4096

    def make(scale):
        ctx = _context(wt, 1, n)
        src = ctx.create_constant_source(offset=1.0)
        src.start()
        sp = ctx.create_script_processor(bufsize, 1, 1)

        def handler(ev):
            ev.output_buffer[:] = ev.input_buffer * scale

        sp.set_onaudioprocess(handler)
        src.connect(sp)
        sp.connect(ctx.destination)
        return ctx

    _lanes_equal_own_renders(make, (0.25, 0.75))


def test_worklet_lazy_construction_and_failure_isolation():
    """:360: the processor is built at first plan, not node creation; a
    constructor that throws silences only its node and fires
    onprocessorerror."""
    constructed = []

    class TracksCtor(wt.AudioWorkletProcessor):
        def __init__(self, options=None, port=None):
            super().__init__(options, port)
            constructed.append(True)

        def process(self, scope, state, inputs, params):
            return state, [inputs[0]]

    ctx = _context(wt, 1, 256)
    src = ctx.create_constant_source(offset=0.5)
    node = ctx.create_audio_worklet(TracksCtor)
    src.connect(node)
    node.connect(ctx.destination)
    src.start()
    assert constructed == []
    out = ctx.start_rendering_sync().get_channel_data(0)
    assert constructed == [True]
    assert out[0] == pytest.approx(0.5)

    class ExplodingCtor(wt.AudioWorkletProcessor):
        def __init__(self, options=None, port=None):
            raise RuntimeError("ctor boom")

    errors = []
    ctx = _context(wt, 1, 256)
    src = ctx.create_constant_source(offset=0.5)
    bad = ctx.create_audio_worklet(ExplodingCtor)
    bad.set_onprocessorerror(lambda e: errors.append(e))
    ok = ctx.create_constant_source(offset=0.25)
    src.connect(bad)
    bad.connect(ctx.destination)
    ok.connect(ctx.destination)
    src.start()
    ok.start()
    out = ctx.start_rendering_sync().get_channel_data(0)
    assert out[0] == pytest.approx(0.25)
    assert len(errors) == 1 and "ctor boom" in str(errors[0])
    assert bad.node_id in ctx.render_stats["segments"][0]["failed"]


@pytest.mark.parametrize("mod", [wt, wa], ids=["port", "jax"])
def test_worklet_spec_compliant_empty_inputs(mod, monkeypatch):
    """:410: with the opt-in a disconnected input is a zero-channel tensor,
    a connected-but-silent one (C, B) zeros; WEBAUDIO_SPEC_WORKLET_INPUTS=1
    opts in globally."""
    xp = torch if mod is wt else jnp
    seen = []

    class InputShapeProbe(mod.AudioWorkletProcessor):
        def process(self, scope, state, inputs, params):
            seen.append(tuple(inputs[0].shape))
            if inputs[0].shape[0] == 0:
                return state, [xp.full((1, inputs[0].shape[1]), 0.125)]
            return state, [inputs[0]]

    monkeypatch.setenv("WEBAUDIO_SPEC_WORKLET_INPUTS", "1")
    ctx = _context(mod, 1, 256)
    node = ctx.create_audio_worklet(InputShapeProbe)
    node.connect(ctx.destination)
    out = ctx.start_rendering_sync().get_channel_data(0)
    assert seen and seen[0][0] == 0
    assert out[0] == pytest.approx(0.125)

    seen.clear()
    ctx = _context(mod, 1, 256)
    silent = ctx.create_gain(gain=0.0)
    src = ctx.create_constant_source()
    src.connect(silent)
    node = ctx.create_audio_worklet(InputShapeProbe)
    silent.connect(node)
    node.connect(ctx.destination)
    src.start()
    ctx.start_rendering_sync()
    assert seen and seen[0][0] == 1


def test_worklet_outputs_and_channel_counts():
    """Several outputs with their channel counts, and the option errors,
    as the JAX node has them."""
    class Split(wt.AudioWorkletProcessor):
        def process(self, scope, state, inputs, params):
            x = inputs[0]
            return state, [x[:1] * 0.5, torch.cat([x[:1], 3.0 * x[:1]])]

    ctx = _context(wt, 2, 256)
    src = ctx.create_constant_source(offset=0.4)
    node = ctx.create_audio_worklet(Split, number_of_outputs=2,
                                    output_channel_count=[1, 2])
    merger = ctx.create_channel_merger(3)
    src.connect(node)
    node.connect(merger, 0, 0)
    node.connect(merger, 1, 1)
    merger.connect(ctx.destination)
    src.start()
    out = ctx.start_rendering_sync().to_array()
    # the merger mixes its 2-channel input down: (0.4 + 1.2) / 2
    assert out[0, 5] == pytest.approx(0.2) and out[1, 5] == pytest.approx(0.8)
    for mod in (wt, wa):
        c = _context(mod, 1, 128)
        with pytest.raises(mod.IndexSizeError):
            c.create_audio_worklet(mod.AudioWorkletProcessor,
                                   number_of_outputs=2,
                                   output_channel_count=[1])
        with pytest.raises(mod.NotSupportedError):
            c.create_audio_worklet(mod.AudioWorkletProcessor,
                                   number_of_inputs=0, number_of_outputs=0)
        assert c.create_audio_worklet(
            mod.AudioWorkletProcessor, number_of_inputs=2,
            number_of_outputs=3).output_channel_count([2, 2]) == [1, 1, 1]


def test_worklet_scope_frame0_is_a_device_tensor():
    """scope.frame0 is a 0-d int64 tensor on the render device (JAX: a
    traced int32) and t_idx the block's sample indices: a processor doing
    arithmetic on them renders as the JAX processor does."""
    class TClock(wt.AudioWorkletProcessor):
        def process(self, scope, state, inputs, params):
            assert scope.frame0.dtype == torch.int64 and scope.frame0.dim() == 0
            assert scope.frame0.device == torch.device("cpu") and not inputs
            n = scope.frame0 + torch.arange(scope.frames)
            assert torch.equal(n, scope.t_idx)
            t = n.double() * scope.dt
            return state, [torch.sin(2 * np.pi * 100.0 * t).float()[None]]

    class JClock(wa.AudioWorkletProcessor):
        def process(self, scope, state, inputs, params):
            t = (scope.frame0 + jnp.arange(scope.frames)) * scope.dt
            return state, [jnp.sin(2 * np.pi * 100.0 * t)
                           .astype(jnp.float32)[None]]

    outs = []
    for mod, proc in ((wt, TClock), (wa, JClock)):
        ctx = _context(mod, 1, 4096)
        node = ctx.create_audio_worklet(proc, number_of_inputs=0)
        node.connect(ctx.destination)
        s = (RenderSession if mod is wt else JSession)(ctx, 8)
        outs.append(np.concatenate([s.step(1024)[0] for _ in range(4)]))
    np.testing.assert_allclose(outs[0], outs[1], rtol=0, atol=2e-6)
    assert np.abs(outs[0]).max() > 0.9


# --- the example's bitcrusher --------------------------------------------------

def test_bitcrusher_example_matches_jax_and_the_oracle():
    """chip_smoke's PyTorch bitcrusher against the JAX example's on the
    bench graph, and against the per-sample numpy oracle on its recorded
    input, apart from rounding-boundary flips."""
    frames = 24000
    proc = chip_smoke.bitcrusher_processor(wt)
    proc.record = []
    ctx, node = crusher(wt, frames, proc=proc)
    got = ctx.start_rendering_sync().to_array()
    rec, proc.record = proc.record, None
    x = np.concatenate([r[0].numpy() for r in rec], axis=1)[:, :frames]
    d = np.concatenate([r[1].numpy() for r in rec])[:frames]
    want, src = chip_smoke.crusher_oracle(x, d)
    peak_in = float(np.abs(x).max())
    chip_smoke.crush_close("port vs oracle", got, want, d, 1e-6, x, src,
                           1e-6 * peak_in)
    jgot = crusher(wa, frames)[0].start_rendering_sync().to_array()
    # the two lowpass renders agree to ~1e-7 of the peak; the flips are
    # where that moves the quantizer's input across a boundary
    chip_smoke.crush_close("port vs JAX", got, jgot, d, 1e-6, x, src,
                           1e-6 * peak_in)
    assert np.abs(got).max() > 0.5 and d[0] == 16.0 and d[-1] < 4.01


# --- under the instance axis ---------------------------------------------------

def _lane_rows(n, frames):
    ends = 4.0 + 8.0 * np.arange(n) / max(n - 1, 1)
    return ends, np.stack([crusher(wt, frames, depth_end=e, raw=True)[1]
                           .parameters["bit_depth"]
                           .compile_for_render(FS, frames).dense
                           for e in ends])


def test_worklet_under_graph_batch_equals_single_renders():
    """4 instances, each with its own bit_depth ramp: the processor runs
    under torch.func.vmap, and each lane equals its own render."""
    frames = 8192
    ends, rows = _lane_rows(4, frames)
    ctx, node = crusher(wt, frames, raw=True)
    gb = wt.GraphBatch(ctx, batch=4)
    gb.override_param(node, "bit_depth", rows)
    out = gb.render().numpy()[..., :frames]
    (wk,) = [k for k in gb.cg.kernels.values()
             if type(k).__name__ == "_WorkletKernel"]
    assert wk.vmap_ok
    for i, e in enumerate(ends):
        own = crusher(wt, frames, depth_end=e, raw=True)[0] \
            .start_rendering_sync().to_array()
        np.testing.assert_array_equal(out[i], own)
    assert not np.array_equal(out[0], out[3])


def test_unvmappable_worklet_runs_per_instance():
    """Data-dependent Python control flow cannot run under vmap: the
    kernel falls back to a loop over the instances, with the same
    output as single renders."""
    class Gate(wt.AudioWorkletProcessor):
        def process(self, scope, state, inputs, params):
            x = inputs[0]
            if float(x.abs().max()) > 0.5:
                return state, [x * 0.5]
            return state, [x]

    def graph(level):
        ctx = _context(wt, 1, 1024)
        src = ctx.create_buffer_source()
        src.buffer = wt.AudioBuffer.from_array(
            np.full((1, 1024), level, np.float32), FS)
        node = ctx.create_audio_worklet(Gate)
        src.connect(node)
        node.connect(ctx.destination)
        src.start()
        return ctx, src

    ctx, src = graph(0.2)
    gb = wt.GraphBatch(ctx, batch=3)
    gb.override_buffer(src, np.stack([np.full((1, 1024), v, np.float32)
                                      for v in (0.2, 0.8, 0.4)]))
    out = gb.render().numpy()[:, 0, :1024]
    (wk,) = [k for k in gb.cg.kernels.values()
             if type(k).__name__ == "_WorkletKernel"]
    assert not wk.vmap_ok
    for i, v in enumerate((0.2, 0.8, 0.4)):
        np.testing.assert_array_equal(
            out[i], graph(v)[0].start_rendering_sync().get_channel_data(0))


def test_worklet_error_in_a_batch_fails_the_node():
    """A processor that raises under the instance axis is isolated as in
    a single render: its node goes silent, onprocessorerror fires, the
    rest renders."""
    class Boom(wt.AudioWorkletProcessor):
        def process(self, scope, state, inputs, params):
            raise ValueError("process boom")

    errors = []
    ctx = _context(wt, 1, 512)
    a = ctx.create_constant_source(offset=0.5)
    bad = ctx.create_audio_worklet(Boom)
    bad.set_onprocessorerror(errors.append)
    b = ctx.create_constant_source(offset=0.25)
    a.connect(bad)
    bad.connect(ctx.destination)
    b.connect(ctx.destination)
    a.start()
    b.start()
    out = wt.GraphBatch(ctx, batch=2).render().numpy()
    np.testing.assert_array_equal(out[:, 0, :512], 0.25)
    assert errors and all("process boom" in str(e) for e in errors)


def test_worklet_tail_frames_hook_opts_in_to_segments():
    """A processor declaring its state history (tail_frames) may render in
    time segments; one without the hook refuses, as in JAX."""
    class Memoryless(wt.AudioWorkletProcessor):
        def tail_frames(self):
            return 0

        def process(self, scope, state, inputs, params):
            return state, [inputs[0] * 0.5]

    def graph(proc):
        ctx = _context(wt, 1, 48000)
        osc = ctx.create_oscillator(frequency=330.0)
        node = ctx.create_audio_worklet(proc)
        osc.connect(node)
        node.connect(ctx.destination)
        osc.start()
        return ctx

    seq = graph(Memoryless).start_rendering_sync().to_array()
    got = render_time_sharded(graph(Memoryless), devices=["cpu"] * 4)
    np.testing.assert_allclose(got, seq, rtol=0, atol=1e-6)
    with pytest.raises(NotTimeShardableError):
        render_time_sharded(graph(TBitcrusher), devices=["cpu"] * 4)


def sp_cycle(mod, frames=int(FS)):
    """A feedback cycle holding a script processor: an oscillator burst
    into a 0.2 s delay fed back through 0.5, the delay's output through a
    ScriptProcessorNode(512) that halves it."""
    ctx = _context(mod, 1, frames)
    o = ctx.create_oscillator(frequency=330.0)
    o.start()
    o.stop(0.1)
    d = ctx.create_delay(max_delay_time=0.5)
    d.delay_time.value = 0.2
    fb = ctx.create_gain(gain=0.5)
    sp = ctx.create_script_processor(512, 1, 1)
    sp.set_onaudioprocess(
        lambda ev: ev.output_buffer.__setitem__(slice(None),
                                                ev.input_buffer * 0.5))
    o.connect(d)
    d.connect(fb)
    fb.connect(d)
    d.connect(sp)
    sp.connect(ctx.destination)
    o.connect(ctx.destination)
    return ctx


def test_pow2_constrained_cycle_plans_and_renders_as_jax():
    """A script processor's pow2 block constraint in a cyclic graph: the
    two-rate plan keeps a pow2 inner block and takes m from
    `_two_rate_steps`, as JAX does, and the render equals JAX's."""
    from webaudio_tpu.graph import compiler as jcomp
    from webaudio_tpu_torch.graph import compiler as tcomp

    plans = []
    for mod, comp, extra in ((wt, tcomp, ("cpu",)), (wa, jcomp, ())):
        ctx = sp_cycle(mod)
        cg = comp.compile_graph(dict(ctx._nodes), list(ctx._edges), FS,
                                ctx.length, ctx._destination.node_id, *extra)
        plans.append((cg.block_frames, cg.two_rate_m, cg.inner_frames or 0))
    assert plans[0] == plans[1] and plans[0][1] >= 2
    inner = plans[0][2]
    assert inner & (inner - 1) == 0
    got = sp_cycle(wt).start_rendering_sync().to_array()
    want = sp_cycle(wa).start_rendering_sync().to_array()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
