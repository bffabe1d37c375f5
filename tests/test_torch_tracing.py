"""The port's host spans (`webaudio_tpu_torch/diagnostics.py::span`): which
`webaudio.*` ranges a recording profiler gets from an offline render and
a batch, where they sit, that they cost one check and build nothing with
no profiler, and that recording changes no output.

The file imports no JAX, so its card test runs on a GPU machine without
it:

    python -m pytest tests/test_torch_tracing.py --noconftest -q
"""

import contextlib

import numpy as np
import pytest
import torch

import webaudio_tpu_torch as wt
from webaudio_tpu_torch import convert, diagnostics
from webaudio_tpu_torch.diagnostics import SPANS, profile_render, span

FS = 44100.0
PLAN = ("plan.fuse", "plan.order", "plan.params", "plan.kernels")


def _reverb(device="cpu", frames=11025, seed=0):
    """A source into a convolver and a feedback delay (config 3's graph,
    short): planning, the two-rate plan and an eager walk."""
    rng = np.random.default_rng(seed)
    ctx = wt.OfflineAudioContext(2, frames, FS, device=device)
    src = ctx.create_buffer_source()
    src.buffer = wt.AudioBuffer.from_array(
        (0.1 * rng.standard_normal((2, frames))).astype(np.float32), FS)
    n = 2205
    ir = rng.standard_normal((2, n)) * np.exp(-np.arange(n) / 400.0)
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


def _spans(prof):
    """(name without "webaudio.", start ns, end ns) of the port's spans,
    and the same of the test's own "test." ranges, in start order."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() != torch.autograd.DeviceType.CPU:
            continue
        for prefix in (diagnostics.PREFIX, "test."):
            if name.startswith(prefix):
                s = ev.start_ns()
                out.append((name[len(diagnostics.PREFIX):]
                            if prefix == diagnostics.PREFIX else name,
                            s, s + ev.duration_ns()))
    return sorted(out, key=lambda x: x[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _known(name):
    return name in SPANS or name.startswith("walk.node.")


def test_an_offline_render_records_its_spans_nested(tmp_path):
    ctx = _reverb()
    with profile_render(str(tmp_path)) as p:
        with torch.profiler.record_function("test.render"):
            ctx.start_rendering_sync()
    assert (tmp_path / "trace.json").exists()
    got = _spans(p.profiler)
    outer = next(s for s in got if s[0] == "test.render")
    mine = [s for s in got if s[0] != "test.render"]
    names = {s[0] for s in mine}
    assert {"plan", *PLAN, "render.stage", "walk.block", "render.fetch",
            "render.finish"} <= names
    nodes = [s for s in mine if s[0].startswith("walk.node.")]
    assert {s[0] for s in nodes} >= {"walk.node._ConvolverKernel",
                                     "walk.node._BufferSourceKernel"}
    # the feedback loop (delay and gain) is one `walk.cycle` a block
    assert "walk.cycle" in names
    nodes += [s for s in mine if s[0] == "walk.cycle"]
    assert all(_inside(s, outer) for s in mine)
    one = {n: next(s for s in mine if s[0] == n)
           for n in ("plan", "render.stage", "walk.block", "render.fetch")}
    for n in PLAN:
        assert all(_inside(s, one["plan"]) for s in mine if s[0] == n), n
    assert all(_inside(s, one["walk.block"]) for s in nodes)
    # one after another: plan, staging, the walk, the copy back, the rest
    order = [one[n] for n in ("plan", "render.stage", "walk.block",
                              "render.fetch")]
    assert all(a[2] <= b[1] for a, b in zip(order, order[1:]))
    finish = [s for s in mine if s[0] == "render.finish"]
    assert finish and all(one["render.fetch"][2] <= s[1] for s in finish)
    assert all(_known(n) for n in names), names


def test_a_fused_feedback_loop_is_one_cycle_span_a_block(tmp_path):
    """Config 3's loop walks as one `walk.cycle` span a block, inside the
    block's `walk.block`, with no node span of the delay or the gain; a
    loop that steps (its gain automated) records their node spans and no
    `walk.cycle`."""
    ctx = _reverb(frames=4 * 44100)
    with profile_render(str(tmp_path)) as p:
        ctx.start_rendering_sync()
    got = _spans(p.profiler)
    blocks = [s for s in got if s[0] == "walk.block"]
    cycles = [s for s in got if s[0] == "walk.cycle"]
    assert "walk.cycle" in SPANS and len(blocks) == 2
    assert len(cycles) == len(blocks)
    assert all(_inside(c, b) for c, b in zip(cycles, blocks))
    names = {s[0] for s in got}
    assert not names & {"walk.node._DelayKernel", "walk.node._GainKernel"}
    stepped = _reverb(frames=4 * 44100)
    (fb,) = [n for n in stepped._nodes.values()
             if type(n).__name__ == "GainNode"]
    fb.gain.set_value_at_time(0.4, 0.01)
    with profile_render(str(tmp_path / "stepped")) as p:
        stepped.start_rendering_sync()
    names = {s[0] for s in _spans(p.profiler)}
    assert {"walk.node._DelayKernel", "walk.node._GainKernel"} <= names
    assert "walk.cycle" not in names


def _batch(device="cpu", n=4, frames=4096, seed=1):
    rng = np.random.default_rng(seed)
    ctx = wt.OfflineAudioContext(2, frames, FS, device=device)
    src = ctx.create_buffer_source()
    src.buffer = wt.AudioBuffer.from_array(
        (0.5 * rng.standard_normal((2, frames))).astype(np.float32), FS)
    g = ctx.create_gain(gain=1.0)
    g.gain.linear_ramp_to_value_at_time(0.5, frames / FS)
    shaper = ctx.create_wave_shaper(
        curve=np.tanh(np.linspace(-2, 2, 1024)).astype(np.float32))
    src.connect(g)
    g.connect(shaper)
    shaper.connect(ctx.destination)
    src.start()
    gb = wt.GraphBatch(ctx, batch=n)
    audio = (0.5 * rng.standard_normal((n, 2, frames))).astype(np.float32)
    gb.override_buffer(src, audio)

    def updates(gb, k):
        rows = np.linspace(0.2 + 0.1 * k, 1.0, frames, dtype=np.float32)
        gb.override_param(g, "gain", np.repeat(rows[None], n, 0))
        curves = np.stack([np.tanh((i + 1 + k) * np.linspace(-1, 1, 1024))
                           for i in range(n)]).astype(np.float32)
        gb.override_buffer(shaper, curves, key="curve")
    return gb, updates


def test_a_batch_records_its_spans(tmp_path):
    gb, updates = _batch()
    with profile_render(str(tmp_path)) as p:
        outs = list(gb.render_stream(2, updates, fetch="i16"))
    assert len(outs) == 2
    got = _spans(p.profiler)
    count = {n: sum(1 for s in got if s[0] == n) for n, *_ in got}
    assert count["batch.override_param"] == 2
    assert count["batch.override_buffer"] == 2
    assert count["batch.stage"] == 2
    # each request re-stages its rows through one host snapshot
    assert count["pin"] >= 2
    assert count["walk.block"] == 2
    assert all(_known(n) for n in count), count
    # a send a row or leaf, inside its stage: the second request sends
    # its gain row and its curves alone
    stages = [s for s in got if s[0] == "batch.stage"]
    sends = [[u for u in got if u[0] == "batch.upload" and _inside(u, st)]
             for st in stages]
    assert sum(map(len, sends)) == count["batch.upload"]
    assert len(sends[1]) == 2 < len(sends[0])


SESSION = ("session.rows", "session.walk", "session.advance", "session.fetch")


def test_a_session_records_its_spans_and_counts(tmp_path):
    """A traced session step records its rows, walk, advance and fetch
    one after another, the walk's blocks inside its walk; a save and a
    restore record theirs, the restore's plan inside it.  `stats` counts
    the steps, saves and restores, and holds the last save's bytes on disk
    and leaves."""
    import json
    import os

    from webaudio_tpu_torch.checkpoint import RenderSession

    s = RenderSession(_reverb(frames=4096), quanta_per_block=16)
    path = str(tmp_path / "s.npz")
    with profile_render(str(tmp_path / "trace")) as p:
        s.step(2048)
        s.save(path)
        r = RenderSession(_reverb(frames=4096), quanta_per_block=16)
        r.restore(path)
        r.step(2048)
    got = _spans(p.profiler)
    names = [n for n, *_ in got]
    assert all(_known(n) for n in names), names
    assert {*SESSION, "session.save", "session.restore"} <= set(names)
    assert all(names.count(n) == 2 for n in SESSION)
    first = [next(x for x in got if x[0] == n) for n in SESSION]
    assert all(a[2] <= b[1] for a, b in zip(first, first[1:]))
    blocks = [x for x in got if x[0] == "walk.block"]
    assert blocks and all(any(_inside(b, w) for w in got
                              if w[0] == "session.walk") for b in blocks)
    restore = next(x for x in got if x[0] == "session.restore")
    assert any(x[0] == "plan" and _inside(x, restore) for x in got)
    with np.load(path) as z:
        leaves = json.loads(str(z["__header__"]))["n_leaves"]
    assert s.stats == {"steps": 1, "saves": 1, "restores": 0,
                       "save_bytes": os.path.getsize(path),
                       "save_leaves": leaves}
    assert leaves >= 3
    assert (r.stats["steps"], r.stats["saves"], r.stats["restores"]) == \
        (1, 0, 1)


def test_every_span_of_the_source_is_in_spans():
    """Each `span("...")` the package opens names an entry of SPANS, and
    each entry is opened somewhere ("walk.node" with its kernel class)."""
    import pathlib
    import re

    pkg = pathlib.Path(wt.__file__).parent
    used = set()
    for path in pkg.rglob("*.py"):
        used |= set(re.findall(r'\bspan\("([a-z_.]+?)\.?"',
                               path.read_text()))
    assert len(set(SPANS)) == len(SPANS)
    assert used == set(SPANS), used ^ set(SPANS)


def test_no_profiler_no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function built with no profiler")

    monkeypatch.setattr(diagnostics, "record_function", refuse)
    first = span("plan")
    assert isinstance(first, contextlib.nullcontext)
    assert all(span(n) is first for n in SPANS + ("walk.node.X",))
    with first, first:
        pass
    # a whole render and a batch request build none either
    _reverb(frames=2048).start_rendering_sync()
    gb, updates = _batch(n=2, frames=1024)
    list(gb.render_stream(1, updates))


def test_no_node_span_while_a_graph_is_captured(tmp_path, monkeypatch):
    """A block walked while the stream captures records no node span (on
    the card that block is the capture); its other spans stay."""
    from webaudio_tpu_torch.graph import compiler

    monkeypatch.setattr(compiler, "_capturing", lambda: True)
    ctx = _reverb(frames=2048)
    with profile_render(str(tmp_path)) as p:
        ctx.start_rendering_sync()
    names = {s[0] for s in _spans(p.profiler)}
    assert "walk.block" in names
    assert not any(n.startswith("walk.node.") for n in names), names


def test_upload_snapshot_is_a_pin_span_and_a_copy(tmp_path):
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    with profile_render(str(tmp_path)) as p:
        got = convert.upload(arr, "cpu")
    arr[0, 0] = -1.0
    assert got.dtype == torch.float32 and got[0, 0].item() == 0.0
    assert [s[0] for s in _spans(p.profiler)] == ["pin"]


@pytest.mark.parametrize("what", ["offline", "batch"])
def test_recording_changes_no_output(tmp_path, what):
    def render():
        if what == "offline":
            return _reverb(seed=4).start_rendering_sync().to_array()
        gb, updates = _batch(seed=4)
        return np.stack(list(gb.render_stream(2, updates, fetch="f32")))

    want = render()
    with profile_render(str(tmp_path)):
        got = render()
    np.testing.assert_array_equal(got, want)


def test_build_span_only_when_compiling(tmp_path, monkeypatch):
    """The host library's g++ run is a `build` span; a build already on
    disk records none."""
    import shutil

    from webaudio_tpu_torch import native

    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    src = tmp_path / "tiny.cpp"
    src.write_text('extern "C" int tiny_one() { return 1; }\n')
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    for built in (False, True):
        with profile_render(str(tmp_path / "trace")) as p:
            assert native._build(src, ("-O0", "-shared", "-fPIC"))
        names = [s[0] for s in _spans(p.profiler)]
        assert names == ([] if built else ["build"]), built


# --- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_walk_captured_while_recording_equals_eager(cuda, monkeypatch,
                                                      tmp_path):
    """A plan captured while `profile_render` records replays bit-equal to
    its eager walk; the capture is a `capture` span with no node span
    inside it, each replay a `walk.replay`, and a batch's copy back waits
    in `batch.fetch_wait` after a `pin`."""
    from webaudio_tpu_torch.graph import compiler

    ctx = _reverb(cuda, frames=5 * 16384)
    cg = compiler.compile_graph(dict(ctx._nodes), list(ctx._edges),
                                ctx.sample_rate, ctx.length,
                                ctx._destination.node_id, ctx.device,
                                quanta_per_block=128)
    assert cg.capture is True
    monkeypatch.setenv("WEBAUDIO_CUDA_GRAPHS", "0")
    eager, _ = compiler.render_compiled(cg, ctx.length)
    monkeypatch.delenv("WEBAUDIO_CUDA_GRAPHS")
    with profile_render(str(tmp_path)) as p:
        got = [compiler.render_compiled(cg, ctx.length)[0]
               for _ in range(2)]
        gb, updates = _batch(cuda)
        list(gb.render_stream(2, updates))
    for g in got:
        assert torch.equal(g, eager)
    spans = _spans(p.profiler)
    captures = [s for s in spans if s[0] == "capture"]
    assert captures and any(s[0] == "walk.replay" for s in spans)
    assert not any(_inside(s, c) for c in captures for s in spans
                   if s[0].startswith("walk.node."))
    names = {s[0] for s in spans}
    assert {"batch.fetch_wait", "pin", "batch.stage"} <= names
    assert all(_known(n) for n in names), names
