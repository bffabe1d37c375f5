"""The port's compiled block walk, on the CPU: what lets `scan_render`
capture one block of a plan as a CUDA graph and replay it for every block
(graph/compiler.py::BlockGraph), held without a card.

- An audit: a `TorchDispatchMode` records every host read of device data
  (`aten._local_scalar_dense`), every tensor made from host data
  (`aten.lift_fresh`), every `aten.nonzero` and every boolean-mask
  `aten.index.Tensor`, and a patched `torch.from_numpy` every host array
  turned into a tensor.  It watches block 1 of a walk of each capturable
  plan, run as a captured walk runs it (frame0 a device scalar, no host
  frame0: an eager walk reads frame0 on the host), (the slice, the a-rate sweep, config 2's fused bank and
  its `OscillatorBankNode`, a two-rate config 3, config 4 with HRTF, 5a,
  fused granular, a `GraphBatch`) and must record nothing.  The plain
  versions of the card's kernels run unwatched: on the card their wrapper
  launches the kernel instead (the detector's plain version is a host
  loop; the feedback loop's reads frame0 on the host, its kernel at a
  device pointer).
- A replay: `make_fx(block_fn)` traced at block 0 with frame0 as a tensor
  (`tracing_mode="real"`, so every host value the trace reads is baked
  in, as a CUDA graph bakes it) and replayed for blocks 1 ... nb-1 is
  bit-equal to the eager walk, on graphs whose output depends on frame0:
  a mid-render start, a looping aligned read, a delay ring that wraps, a
  cumsum playhead started mid-block, the fused grain bank (K2's plain
  version takes frame0 as a tensor).  The same renders hold to the JAX
  package within 1e-5 x peak (the granular render 3e-5 absolute, the
  known FMA contraction of XLA).
- Plans with a script processor, a media node or a worklet say why they
  stay eager in `CompiledGraph.capture`; every other plan here is True.
"""

import traceback

import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils._python_dispatch import (
    TorchDispatchMode, _disable_current_modes,
)

import jax  # noqa: F401  (the JAX package below runs on the CPU)

import webaudio_tpu as wa
import webaudio_tpu_torch as wt
from webaudio_tpu_torch.graph import compiler as tcomp
from webaudio_tpu_torch.ops import curve_kernel as tck
from webaudio_tpu_torch.ops import detector as tdet
from webaudio_tpu_torch.ops import feedback as tfb
from webaudio_tpu_torch.ops import grain_read as tgr
from webaudio_tpu_torch.parallel.batch import GraphBatch

from test_torch_drivers import granular, reverb_graph, slice_graph
from test_torch_mastering import mastering
from test_torch_spatial import config4
from test_torch_voices import bank, synth

FS = 48000.0
aten = torch.ops.aten


def _context(mod, channels, length, fs=FS):
    if mod is wt:
        return wt.OfflineAudioContext(channels, length, fs, device="cpu")
    return wa.OfflineAudioContext(channels, length, fs)


def _plan(ctx, **kw):
    return tcomp.compile_graph(dict(ctx._nodes), list(ctx._edges),
                               ctx.sample_rate, ctx.length,
                               ctx._destination.node_id, "cpu", **kw)


class _Audit(TorchDispatchMode):
    """Records the operations a captured walk cannot hold: a host read of
    device data, a tensor made from host data, a data-dependent shape."""

    def __init__(self):
        super().__init__()
        self.hits = []

    def hit(self, what):
        frames = [f for f in traceback.extract_stack()[:-2]
                  if "webaudio_tpu_torch" in f.filename]
        where = frames[-1] if frames else None
        self.hits.append(
            f"{what} at {where.filename.split('webaudio_tpu_torch/')[-1]}:"
            f"{where.lineno}" if where else what)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (aten._local_scalar_dense.default, aten.lift_fresh.default,
                    aten.lift_fresh_copy.default) \
                or func.overloadpacket is aten.nonzero:
            self.hit(str(func))
        elif func is aten.index.Tensor and any(
                i is not None and i.dtype == torch.bool for i in args[1]):
            self.hit("a boolean-mask index")
        return func(*args, **kwargs)


@pytest.fixture
def audit(monkeypatch):
    """audit(cg) watches block 1 of cg's next walk; returns the _Audit."""
    from_numpy = torch.from_numpy
    active = []

    def watched_from_numpy(a):
        if active:
            active[0].hit("torch.from_numpy")
        return from_numpy(a)

    monkeypatch.setattr(torch, "from_numpy", watched_from_numpy)

    def unwatched(fn):
        def run(*a, **k):
            with _disable_current_modes():
                saved = active[:]
                active.clear()
                try:
                    return fn(*a, **k)
                finally:
                    active.extend(saved)
        return run

    # the card's kernels' plain versions stand in for a launch here
    for mod, name in ((tdet, "detector_reference"),
                      (tck, "curve_lookup_reference"),
                      (tfb, "feedback_delay_reference"),
                      (tgr, "grain_bank_reference"),
                      (tgr, "grouped_lerp_reference")):
        monkeypatch.setattr(mod, name, unwatched(getattr(mod, name)))

    def watch(cg):
        mode = _Audit()
        inner = cg.block_fn
        calls = [0]

        def block_fn(states, frame0, xs, resources, frame0_host=None):
            calls[0] += 1
            if calls[0] != 2:
                return inner(states, frame0, xs, resources, frame0_host)
            # as a captured block: frame0 on the device, none on the host
            f0 = torch.tensor(frame0_host)
            active.append(mode)
            try:
                with mode:
                    return inner(states, f0, xs, resources)
            finally:
                active.clear()

        cg.block_fn = block_fn
        mode.calls = calls
        return mode
    return watch


def sweep(mod, n=8192):
    """The a-rate lowpass sweep (tests/test_torch_batch.py's graph)."""
    ctx = _context(mod, 1, n)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = mod.AudioBuffer.from_array(
        np.sin(np.arange(4096) * 0.05, dtype=np.float32)[None], FS)
    src.start()
    f = ctx.create_biquad_filter(type="lowpass", frequency=200.0, q=4.0)
    f.frequency.exponential_ramp_to_value_at_time(8000.0, n / FS)
    src.connect(f)
    f.connect(ctx.destination)
    return ctx


def _two_rate_config3(mod):
    """reverb_graph, 1.5 s: a two-rate plan, one block at the default
    budget (see test_block_walk_reads_nothing_from_the_host)."""
    return reverb_graph(mod, 66150)


def _rows(cg, frames):
    """cg's dense rows over `frames`, padded to whole blocks."""
    return tcomp.pack_dense_params(
        cg, tcomp._pad_len(frames, cg.block_frames))


def _walk_two(cg, frames):
    """The first two blocks of cg's eager walk over `frames`."""
    states, frame0s, xs, res = tcomp.render_args(cg, _rows(cg, frames))
    assert len(frame0s) >= 2
    return tcomp.scan_render(cg, states, frame0s[:2], xs[:, :2], res)


CASES = {
    "slice": lambda: (slice_graph(wt, 8192), dict(quanta_per_block=16)),
    "a-rate sweep": lambda: (sweep(wt), dict(quanta_per_block=16)),
    "config 2 fused bank": lambda: (synth(wt, n_osc=40, seconds=0.1),
                                    dict(quanta_per_block=8)),
    "config 2 bank node": lambda: (bank(wt, n=4096),
                                   dict(quanta_per_block=8)),
    "config 3 two-rate": lambda: (_two_rate_config3(wt), {}),
    "config 4 HRTF": lambda: (config4(wt, seconds=0.1),
                              dict(quanta_per_block=8)),
    "5a": lambda: (mastering(wt, 8192)[0], dict(quanta_per_block=16)),
    "fused granular": lambda: (granular(wt, n_grains=64, seconds=2.0),
                               dict(quanta_per_block=64)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_block_walk_reads_nothing_from_the_host(audit, monkeypatch, name):
    monkeypatch.setenv("WEBAUDIO_DETECTOR", "seq")        # the card's path
    monkeypatch.setenv("WEBAUDIO_FUSE_THRESHOLD", "8")
    # blocks of at most 384 quanta: the two-rate config 3 plans 2 blocks
    # of 3 sub-steps, so block 1 exists at a CPU size
    monkeypatch.setattr(tcomp, "_budget_quanta", lambda nodes: 384)
    ctx, kw = CASES[name]()
    cg = _plan(ctx, **kw)
    assert cg.capture is True
    if name == "config 3 two-rate":
        assert cg.two_rate_m >= 2
    if name == "fused granular":
        (fk,) = [k for k in cg.kernels.values()
                 if getattr(k, "read_mode", None) == "fused"]
    mode = audit(cg)
    _walk_two(cg, ctx.length)
    assert mode.calls[0] == 2
    assert not mode.hits, mode.hits


def test_graph_batch_walk_reads_nothing_from_the_host(audit):
    ctx = sweep(wt, 8192)
    gb = GraphBatch(ctx, batch=3, _cg=_plan(ctx, quanta_per_block=16))
    rng = np.random.default_rng(3)
    rows = np.exp(rng.uniform(np.log(200), np.log(8000), (3, 1))) * \
        np.linspace(1.0, 1.5, ctx.length)[None]
    (filt,) = [n for n in ctx._nodes.values()
               if type(n).__name__ == "BiquadFilterNode"]
    gb.override_param(filt, "frequency", rows.astype(np.float32))
    mode = audit(gb.cg)
    out = gb.render()
    assert mode.calls[0] == gb.nb >= 2
    assert not mode.hits, mode.hits
    assert out.shape[0] == 3 and torch.isfinite(out).all()


# --- replay: a trace of block 0 walks every block ------------------------

def mid_start(mod, n=6144):
    """A one-shot source started mid-render, mid-block."""
    ctx = _context(mod, 1, n)
    src = ctx.create_buffer_source()
    src.buffer = mod.AudioBuffer.from_array(
        np.sin(np.arange(3000) * 0.07, dtype=np.float32)[None], FS)
    src.start(1500.5 / FS)
    src.connect(ctx.destination)
    return ctx


def aligned_loop(mod, n=6144):
    """A looping unit-rate source: the aligned read, its start wrapping
    around the buffer from block to block."""
    ctx = _context(mod, 2, n)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = mod.AudioBuffer.from_array(
        np.stack([np.sin(np.arange(700) * 0.05), np.cos(np.arange(700) * 0.02)])
        .astype(np.float32), FS)
    src.start()
    src.connect(ctx.destination)
    return ctx


def delay_ring(mod, n=6144):
    """An oscillator through a constant delay and a feedback delay whose
    rings wrap every few blocks; the feedback delay's time is automated."""
    ctx = _context(mod, 1, n)
    osc = ctx.create_oscillator(frequency=330.0)
    d = ctx.create_delay(max_delay_time=0.01)
    d.delay_time.value = 0.0041
    osc.connect(d)
    d.connect(ctx.destination)
    fb_d = ctx.create_delay(max_delay_time=0.02)
    fb_d.delay_time.set_value_at_time(0.006, 0.0)
    fb_d.delay_time.linear_ramp_to_value_at_time(0.012, n / FS)
    fb = ctx.create_gain(gain=0.5)
    osc.connect(fb_d)
    fb_d.connect(fb)
    fb.connect(fb_d)
    fb.connect(ctx.destination)
    osc.start(0.002)
    return ctx


def cumsum_playhead(mod, n=6144):
    """An automated playback rate (the cumsum playhead) started inside the
    third block."""
    ctx = _context(mod, 1, n)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = mod.AudioBuffer.from_array(
        np.sin(np.arange(2000) * 0.03, dtype=np.float32)[None], FS)
    src.playback_rate.set_value_at_time(0.8, 0.0)
    src.playback_rate.linear_ramp_to_value_at_time(1.7, n / FS)
    src.start(2600.25 / FS)
    src.connect(ctx.destination)
    return ctx


def lane_granular(mod):
    """64 grains over 2 s: few enough overlap that the bank packs them
    into lanes and reads them with K2."""
    return granular(mod, n_grains=64, seconds=2.0)


REPLAYS = {
    "mid-render start": (mid_start, 8, 1e-5),
    "looping aligned read": (aligned_loop, 8, 1e-5),
    "delay ring wraps": (delay_ring, 1, 1e-5),
    "cumsum playhead mid-block": (cumsum_playhead, 8, 1e-5),
    "fused grain bank": (lane_granular, 64, None),
}


def _replayed(cg, frames):
    """(the eager walk's output, block_fn traced at block 0 and replayed
    for every block) over `frames`."""
    states, frame0s, xs, res = tcomp.render_args(cg, _rows(cg, frames))
    _, want = tcomp.scan_render(cg, states, frame0s, xs, res)
    gm = make_fx(lambda st, f0, x, r: cg.block_fn(st, f0, x, r),
                 tracing_mode="real")(
        states, torch.tensor(frame0s[0]), xs[:, 0], res)
    outs = []
    for b, f0 in enumerate(frame0s):
        states, y = gm(states, torch.tensor(f0), xs[:, b], res)
        outs.append(y)
    return want, torch.cat(outs, dim=-1)


@pytest.mark.parametrize("name", sorted(REPLAYS))
def test_block_traced_once_replays_every_block(monkeypatch, name):
    monkeypatch.setenv("WEBAUDIO_FUSE_THRESHOLD", "8")
    build, qpb, rel = REPLAYS[name]
    ctx = build(wt)
    cg = _plan(ctx, quanta_per_block=qpb)
    assert cg.capture is True
    nb = -(-ctx.length // cg.block_frames)
    assert nb >= 4
    if name == "fused grain bank":
        assert any(getattr(k, "read_mode", None) == "fused"
                   for k in cg.kernels.values())
    want, got = _replayed(cg, ctx.length)
    assert torch.equal(got, want)
    got = got[0, :, :ctx.length].numpy()
    peak = float(np.abs(got).max())
    assert peak > 0.05
    ref = np.asarray(build(wa).start_rendering_sync().to_array())
    if rel is None:
        # XLA contracts the grain playhead and lerp into FMAs
        np.testing.assert_allclose(got, ref, rtol=0, atol=3e-5)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=rel * peak)


def test_host_frame0_raises_inside_a_trace():
    """A kernel that reads the host frame0 where the walk is captured
    fails loudly instead of baking one block's value in."""
    scope = tcomp.BlockScope(torch.tensor(0), 128, 1, "cpu")
    with pytest.raises(wt.KernelError, match="captured"):
        scope.frame0_host
    assert tcomp.BlockScope(torch.tensor(256), 128, 1, "cpu",
                            256).frame0_host == 256


# --- plans that stay eager -------------------------------------------------

class _Half(wt.AudioWorkletProcessor):
    """A worklet processor: halves its input."""

    def process(self, scope, state, inputs, params):
        return state, [inputs[0] * 0.5]


def _eager_plans():
    from webaudio_tpu_torch.media.streams import MediaStream, PushStreamTrack
    from webaudio_tpu_torch.nodes.media_nodes import (
        MediaStreamAudioDestinationNode, MediaStreamAudioSourceNode,
    )

    return {
        "ScriptProcessorNode":
            lambda ctx: ctx.create_script_processor(256, 1, 1),
        "MediaStreamAudioDestinationNode": MediaStreamAudioDestinationNode,
        "MediaStreamAudioSourceNode": lambda ctx: MediaStreamAudioSourceNode(
            ctx, MediaStream([PushStreamTrack()])),
        "AudioWorkletNode": lambda ctx: ctx.create_audio_worklet(_Half),
    }


@pytest.mark.parametrize("kind", sorted(_eager_plans()))
def test_host_callback_and_user_code_plans_stay_eager(kind):
    ctx = _context(wt, 1, 2048)
    osc = ctx.create_oscillator(frequency=440.0)
    node = _eager_plans()[kind](ctx)
    if node.number_of_inputs:
        osc.connect(node)
    node.connect(ctx.destination)
    osc.connect(ctx.destination)
    osc.start()
    cg = _plan(ctx)
    assert isinstance(cg.capture, str)
    assert cg.capture.startswith(f"{kind} #{node.node_id}: ")


@pytest.mark.parametrize("build", [slice_graph, reverb_graph],
                         ids=["slice", "config 3"])
def test_builtin_plans_are_capturable(build):
    ctx = build(wt, 4096)
    assert _plan(ctx).capture is True


def test_diagnostics_report_the_capture_state():
    """collect_diagnostics names whether the last plan's walk is captured
    on the card and why not."""
    from webaudio_tpu_torch.diagnostics import collect_diagnostics

    ctx = slice_graph(wt, 4096)
    ctx.start_rendering_sync()
    cap = collect_diagnostics(ctx)["compiled"]["capture"]
    assert cap["capturable"] is True and cap["reason"] is None
    assert cap["graphs"] == []              # the CPU walks eagerly
    ctx = _context(wt, 1, 2048)
    osc = ctx.create_oscillator()
    sp = ctx.create_script_processor(256, 1, 1)
    osc.connect(sp)
    sp.connect(ctx.destination)
    osc.start()
    ctx.start_rendering_sync()
    cap = collect_diagnostics(ctx)["compiled"]["capture"]
    assert cap["capturable"] is False
    assert cap["reason"].startswith(f"ScriptProcessorNode #{sp.node_id}: ")
