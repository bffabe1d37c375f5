"""Sharding on the port (webaudio_tpu_torch/parallel/mesh.py, batch.py,
segments.py, graft_entry.py) on the CPU: meshes of repeated "cpu"
devices against the unsharded renders and against the JAX package's
sharded renders on the conftest's 8 virtual CPU devices.

Tolerances: a sharded render walks each shard with the same ops as the
unsharded batch, so sharded and unsharded are held bit for bit; the
bounces' Philox stream is indexed by the flat element, so sharded codes
are held bit for bit too.  Against JAX: 1e-5 x peak (the goldens' rule),
1e-4 x peak for a-rate sweeps (XLA and torch round the coefficients' f32
sin/cos apart in the last ulp, tests/test_torch_render.py).  The graft
entry's dry-run legs keep the JAX file's atol (2e-5; 2e-6 for cycles).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import __graft_entry__ as jgraft
import webaudio_tpu as wa
import webaudio_tpu_torch as wt
from test_torch_batch import (_assert_close, _buffers, _sweep_rows,
                              _write_host_row, gain_graph, sweep_graph)
from test_torch_drivers import segments_graph
from webaudio_tpu.parallel.batch import GraphBatch as JGraphBatch
from webaudio_tpu_torch import convert, graft_entry
from webaudio_tpu_torch.ops import dither as td
from webaudio_tpu_torch.parallel import batch as tbatch
from webaudio_tpu_torch.parallel.mesh import Mesh, default_mesh
from webaudio_tpu_torch.parallel.segments import render_time_sharded

FS = 48000.0
BATCH = 8


def _mesh(n, axis="graphs"):
    return Mesh(["cpu"] * n, (axis,))


def delay_graph(mod, length):
    """A looping buffer into a delay whose time is automated, mixed with
    the dry signal: the delay's f64 read positions and its ring."""
    ctx = (wt.OfflineAudioContext(1, length, FS, device="cpu") if mod is wt
           else wa.OfflineAudioContext(1, length, FS))
    src = ctx.create_buffer_source(loop=True)
    src.buffer = mod.AudioBuffer.from_array(
        np.sin(np.arange(3000) * 0.02, dtype=np.float32)[None], FS)
    src.start()
    d = ctx.create_delay(max_delay_time=0.05)
    d.delay_time.set_value_at_time(0.004, 0.0)
    d.delay_time.linear_ramp_to_value_at_time(0.02, length / FS)
    src.connect(d)
    src.connect(ctx.destination)
    d.connect(ctx.destination)
    return ctx, src, d


def _graph(mod, name, length):
    """(context, source, the overridden node, its param, per-lane rows)."""
    if name == "gain":
        ctx, src, node = gain_graph(mod, length)
        rows = np.linspace(0.1, 1.0, BATCH, dtype=np.float32)[:, None] * \
            np.linspace(0.0, 1.0, length, dtype=np.float32)[None]
        return ctx, src, node, "gain", rows
    if name == "sweep":
        ctx, src, node = sweep_graph(mod, length)
        return ctx, src, node, "frequency", _sweep_rows(BATCH, length)
    ctx, src, node = delay_graph(mod, length)
    rows = np.linspace(0.002, 0.04, BATCH, dtype=np.float32)[:, None] * \
        np.ones((1, length), np.float32)
    return ctx, src, node, "delay_time", rows


def _batch(name, mesh, length=6000):
    ctx, src, node, param, rows = _graph(wt, name, length)
    gb = wt.GraphBatch(ctx, batch=BATCH, mesh=mesh)
    gb.override_param(node, param, rows)
    return gb, src, node, param


# --- the mesh --------------------------------------------------------------


def test_mesh_holds_devices_as_jax_does(monkeypatch):
    mesh = Mesh(["cpu"] * 8, ("graphs",))
    assert mesh.devices.size == 8 and mesh.devices.ndim == 1
    assert mesh.axis_names == ("graphs",)
    assert all(d == torch.device("cpu") for d in mesh.devices)
    # a bare "cuda" names the current card with its index
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    cards = Mesh(["cuda", "cuda:0", torch.device("cuda")], ("time",))
    assert list(cards.devices) == [torch.device("cuda", 0)] * 3
    for bad in (([], ("graphs",)), (["cpu"], ("graphs", "time")),
                (["cpu"], ())):
        with pytest.raises(ValueError):
            Mesh(*bad)


def test_default_mesh_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError):
        default_mesh()
    with pytest.raises(RuntimeError):
        render_time_sharded(segments_graph(wt, seconds=0.1))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = tbatch.default_mesh("time")
    assert list(mesh.devices) == [torch.device("cuda", 0),
                                  torch.device("cuda", 1)]
    assert mesh.axis_names == ("time",)


# --- GraphBatch over a mesh --------------------------------------------------


@pytest.mark.parametrize("n", (2, 4, 8))
@pytest.mark.parametrize("graph", ("gain", "sweep", "delay"))
def test_sharded_batch_is_bit_equal_to_unsharded(graph, n):
    want = _batch(graph, None)[0].render()
    gb = _batch(graph, _mesh(n))[0]
    assert [(sh.lo, sh.hi) for sh in gb._shards] == \
        [(s * BATCH // n, (s + 1) * BATCH // n) for s in range(n)]
    # repeated devices share one plan: the context's
    assert all(sh.cg is gb.cg for sh in gb._shards)
    got = gb.render()
    assert got.shape == want.shape and got.device == want.device
    assert torch.equal(got, want)
    assert float(got.abs().max()) > 0.0


@pytest.mark.parametrize("graph", ("gain", "sweep"))
def test_overrides_after_staging_restage_the_shards(graph):
    """override_param and override_buffer after a render: the sharded
    batch re-stages and stays bit-equal to the unsharded one."""
    gbs = [_batch(graph, mesh) for mesh in (None, _mesh(4))]
    for gb, *_ in gbs:
        gb.render()
    length = gbs[0][0].total_frames
    rows = _graph(wt, graph, length)[4][::-1].copy() * 0.5
    bufs = _buffers(BATCH, gbs[0][1].buffer.number_of_channels,
                    gbs[0][1].buffer.length, seed=3)
    outs = []
    for gb, src, node, param in gbs:
        gb.override_param(node, param, rows)
        first = gb.render()
        gb.override_buffer(src, bufs)
        outs.append((first, gb.render()))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert not torch.equal(outs[1][0], outs[1][1])


@pytest.mark.parametrize("graph", ("gain", "sweep", "delay"))
def test_overrides_after_the_first_render_land_in_every_shard(graph):
    """A row override after the first render is sent to each shard alone
    (its own slice, on its own device), and the sharded render equals an
    unsharded batch with the row written into its staged rows."""
    gb, _, node, param = _batch(graph, _mesh(4))
    gb.render()
    rows = _graph(wt, graph, gb.total_frames)[4][::-1].copy() * 0.5
    gb.override_param(node, param, rows)
    got = gb.render()
    name = f"n{node.node_id}.{param}"
    assert gb.stage_stats["uploaded"] == [name] * 4
    ref = wt.GraphBatch(_graph(wt, graph, gb.total_frames)[0], batch=BATCH)
    _write_host_row(ref, node, param, rows)
    assert torch.equal(got, ref.render())


@pytest.mark.parametrize("mesh,error", [
    (_mesh(3), ValueError),                  # 8 instances over 3 shards
    (_mesh(16), ValueError),
    (_mesh(4, "time"), ValueError),          # not a "graphs" axis
    (["cpu"] * 4, TypeError),                # not a Mesh
])
def test_batch_the_mesh_does_not_split_raises(mesh, error):
    ctx = gain_graph(wt, 1024)[0]
    with pytest.raises(error):
        wt.GraphBatch(ctx, batch=BATCH, mesh=mesh)


@pytest.mark.parametrize("n", (2, 8))
@pytest.mark.parametrize("graph", ("gain", "sweep"))
def test_sharded_bounces_equal_one_whole_bounce(graph, n):
    plain = _batch(graph, None)[0]
    gb = _batch(graph, _mesh(n))[0]
    x = gb.render()
    for seed in (0, 11):
        q = gb.render_i16(seed)
        u = gb.render_u8(seed)
        assert q.dtype == torch.int16 and u.dtype == torch.uint8
        assert torch.equal(q, td.dither_i16_reference(x, seed))
        assert torch.equal(u, td.ulaw_u8_reference(x, seed))
        assert torch.equal(q, plain.render_i16(seed))
        assert torch.equal(u, plain.render_u8(seed))


@pytest.mark.parametrize("offset", (0, 4, 1000, 2**33 + 4))
def test_offset_codes_are_a_slice_of_the_whole_tensors(offset):
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.uniform(-1.2, 1.2, 4097).astype(np.float32))
    x[:3] = torch.tensor([np.nan, np.inf, -np.inf])
    lead = offset % 4096
    whole = torch.cat([torch.zeros(lead), x])
    base = offset - lead
    for ref, wrapper in ((td.dither_i16_reference, td.dither_i16),
                         (td.ulaw_u8_reference, td.ulaw_u8)):
        want = ref(whole, 5, base)[lead:]
        assert torch.equal(ref(x, 5, offset), want)
        assert torch.equal(wrapper(x, 5, offset=offset), want)
    if offset:
        assert not torch.equal(td.dither_i16_reference(x, 5, offset),
                               td.dither_i16_reference(x, 5))


@pytest.mark.parametrize("offset", (-4, 2, 5))
def test_offset_must_be_a_multiple_of_four(offset):
    x = torch.zeros(16)
    for fn in (td.dither_i16, td.ulaw_u8, td.dither_i16_reference):
        with pytest.raises(ValueError):
            fn(x, 0, offset=offset)


@pytest.mark.parametrize("fetch", ("f32", "i16", "u8"))
def test_sharded_render_stream_equals_unsharded(fetch):
    ctx, _, g = gain_graph(wt, 2048)

    def updates(gb_, k):
        gb_.override_param(
            g, "gain", np.full((BATCH, 2048), 0.1 * (k + 1), np.float32))

    streams = []
    for mesh in (None, _mesh(4)):
        gb = wt.GraphBatch(gain_graph(wt, 2048)[0], batch=BATCH, mesh=mesh)
        streams.append(list(gb.render_stream(3, updates=updates,
                                             fetch=fetch)))
    assert len(streams[1]) == 3
    for got, want in zip(*streams):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert not np.array_equal(streams[1][0], streams[1][1])


# --- MixedGraphBatch over a mesh ---------------------------------------------


def _osc_ctx(freq, ramp, length=4096):
    ctx = wt.OfflineAudioContext(1, length, FS, device="cpu")
    o = ctx.create_oscillator(frequency=freq)
    g = ctx.create_gain(gain=0.0)
    g.gain.linear_ramp_to_value_at_time(ramp, length / FS)
    o.connect(g)
    g.connect(ctx.destination)
    o.start()
    return ctx


def _filter_ctx(f0, f1, length=4096):
    ctx = wt.OfflineAudioContext(1, length, FS, device="cpu")
    o = ctx.create_oscillator(type="sawtooth", frequency=110.0)
    f = ctx.create_biquad_filter(type="lowpass", q=2.0)
    f.frequency.set_value_at_time(f0, 0.0)
    f.frequency.exponential_ramp_to_value_at_time(f1, length / FS)
    o.connect(f)
    f.connect(ctx.destination)
    o.start()
    return ctx


def _cycle_ctx(fbgain, length=9600):
    ctx = wt.OfflineAudioContext(1, length, FS, device="cpu")
    o = ctx.create_oscillator(frequency=330.0)
    o.start()
    o.stop(0.05)
    d = ctx.create_delay(max_delay_time=0.1)
    d.delay_time.value = 0.02
    fb = ctx.create_gain(gain=fbgain)
    # automated, so cycles of every gain share one bucket
    fb.gain.linear_ramp_to_value_at_time(0.5 * fbgain, length / FS)
    o.connect(d)
    d.connect(fb)
    fb.connect(d)
    fb.connect(ctx.destination)
    return ctx


def test_sharded_buckets_on_mesh():
    """tests/test_mixed_batch.py::test_sharded_buckets_on_mesh: a bucket of
    4 shards over the mesh, a bucket of 1 falls back to unsharded; every
    output equals the unsharded mixed batch's and its own render."""
    make = lambda: [_osc_ctx(220.0, 0.25 * (i + 1)) for i in range(4)] + \
        [_filter_ctx(300.0, 3000.0)]
    mb = wt.MixedGraphBatch(make(), mesh=_mesh(4))
    assert mb.num_buckets == 2
    sizes = {len(idxs): gb for idxs, gb in mb._buckets}
    assert sizes[4].mesh is not None and len(sizes[4]._shards) == 4
    assert sizes[1].mesh is None and len(sizes[1]._shards) == 1
    outs = mb.render()
    for got, want in zip(outs, wt.MixedGraphBatch(make()).render()):
        np.testing.assert_array_equal(got, want)
    for got, ctx in zip(outs, make()):
        want = ctx.start_rendering_sync().to_array()
        np.testing.assert_allclose(got, want, atol=1e-6)


def test_sharded_two_rate_cycles_match_their_own_renders():
    gains = [0.3 + 0.05 * i for i in range(4)]
    mb = wt.MixedGraphBatch([_cycle_ctx(g) for g in gains], mesh=_mesh(4))
    (idxs, gb), = mb._buckets
    assert gb.cg.two_rate_m > 1 and len(gb._shards) == 4
    for g, got in zip(gains, mb.render()):
        np.testing.assert_array_equal(
            got, _cycle_ctx(g).start_rendering_sync().to_array())


# --- time segments over a mesh -----------------------------------------------


def test_time_sharded_mesh_equals_devices():
    want = render_time_sharded(segments_graph(wt, seconds=0.5),
                               devices=["cpu"] * 8)
    got = render_time_sharded(segments_graph(wt, seconds=0.5),
                              mesh=_mesh(8, "time"))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        render_time_sharded(segments_graph(wt, seconds=0.5),
                            mesh=_mesh(8, "time"), devices=["cpu"] * 8)
    with pytest.raises(ValueError):
        render_time_sharded(segments_graph(wt, seconds=0.5), mesh=_mesh(8))


# --- against the JAX package --------------------------------------------------


@pytest.mark.parametrize("graph,rel", [("gain", 1e-5), ("sweep", 1e-4),
                                       ("delay", 1e-5)])
def test_sharded_lane_matches_jax_sharded_batch(graph, rel):
    length = 6000
    jctx, _, jnode, param, rows = _graph(wa, graph, length)
    jgb = JGraphBatch(jctx, batch=BATCH,
                      mesh=JMesh(np.array(jax.devices()[:4]), ("graphs",)))
    jgb.override_param(jnode, param, rows)
    want = np.asarray(jgb.render())[:, :, :length]
    got = _batch(graph, _mesh(4), length)[0].render().numpy()[:, :, :length]
    for lane in (0, 3, BATCH - 1):
        _assert_close(got[lane], want[lane], rel)


# --- the graft entry ----------------------------------------------------------


def test_graft_forward_matches_jax_on_carried_inputs():
    jforward, (jstates, jframe0s, jxs, jres) = jgraft.entry()
    want = np.asarray(jforward(jstates, jframe0s, jxs, jres))
    forward, (states, frame0s, xs, res) = graft_entry.entry(device="cpu")
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    got = forward(convert.states_from_jax(to_np(jstates), "cpu"),
                  np.asarray(jframe0s), torch.from_numpy(np.array(jxs)),
                  convert.resources_from_jax(to_np(jres), "cpu"))
    assert tuple(got.shape) == want.shape
    # the flagship graph is an a-rate sweep
    _assert_close(got.numpy(), want, 1e-4)
    assert np.array_equal(np.asarray(jframe0s), frame0s)
    assert xs.shape == np.asarray(jxs).shape


def test_graft_forward_is_the_context_render():
    forward, args = graft_entry.entry(device="cpu")
    got = forward(*args).numpy()
    want = graft_entry.flagship_context(device="cpu").start_rendering_sync() \
        .to_array()
    np.testing.assert_array_equal(got[:, :want.shape[1]], want)


def test_graft_dryrun_multichip_on_a_cpu_mesh():
    errs = graft_entry.dryrun_multichip(4, device="cpu")
    assert set(errs) == {"batch", "time", "mixed", "cycles"}
    assert errs["cycles"] <= 2e-6 and max(errs.values()) <= 2e-5
