"""Batched serving through the port (webaudio_tpu_torch/parallel/batch.py)
against the JAX package's GraphBatch and MixedGraphBatch, on the CPU.

Each graph is built twice by one function, once per package, from the
same numpy data.  Tolerances: 1e-5 x peak for the LTI and aligned-read
graphs (the goldens' rule), 1e-4 x peak for a-rate filter sweeps (XLA and
torch round the f32 sin/cos of the coefficients apart in the last ulp and
the resonant sweep amplifies it; tests/test_torch_render.py).
"""

import numpy as np
import pytest
import torch

import webaudio_tpu as wa
import webaudio_tpu_torch as wt
from webaudio_tpu.parallel.batch import GraphBatch as JGraphBatch
from webaudio_tpu.parallel.batch import MixedGraphBatch as JMixedGraphBatch
from webaudio_tpu_torch.ops import dither as td
from webaudio_tpu_torch.parallel import batch as tbatch

FS = 48000.0


def _context(mod, channels, length):
    if mod is wt:
        return wt.OfflineAudioContext(channels, length, FS, device="cpu")
    return wa.OfflineAudioContext(channels, length, FS)


def _bench_data():
    # bench.py:34-37's synthetic 2 s stereo buffer
    return np.sin(np.arange(2 * 48000) * 0.03, dtype=np.float32)[None].repeat(2, 0)


def _buffers(count, channels, length, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((count, channels, length)) * 0.4).astype(np.float32)


def sweep_graph(mod, length, data=None, rate=FS, f0=200.0, f1=8000.0):
    """benches/suite.py::_build_batched_ctx: a looping buffer into a
    lowpass (Q 3) whose frequency sweeps exponentially."""
    ctx = _context(mod, 2, length)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = mod.AudioBuffer.from_array(
        _bench_data() if data is None else data, rate)
    src.start()
    filt = ctx.create_biquad_filter(type="lowpass", q=3.0)
    filt.frequency.set_value_at_time(f0, 0.0)
    filt.frequency.exponential_ramp_to_value_at_time(f1, length / FS)
    src.connect(filt)
    filt.connect(ctx.destination)
    return ctx, src, filt


def lti_graph(mod, length, data=None, rate=FS, shaper=False, freq=2000.0):
    """A looping buffer into a constant lowpass (the FDL path), optionally
    into the mastering chain's WaveShaper."""
    ctx = _context(mod, 2, length)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = mod.AudioBuffer.from_array(
        _bench_data() if data is None else data, rate)
    src.start()
    filt = ctx.create_biquad_filter(type="lowpass", frequency=freq, q=2.0)
    src.connect(filt)
    if shaper:
        ws = ctx.create_wave_shaper(
            curve=np.tanh(np.linspace(-2, 2, 2048)).astype(np.float32))
        filt.connect(ws)
        ws.connect(ctx.destination)
    else:
        filt.connect(ctx.destination)
    return ctx, src, filt


def gain_graph(mod, length, data=None, ramp_to=0.8, gain=0.0):
    """A looping buffer into a gain with a linear-ramp envelope."""
    ctx = _context(mod, 1, length)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = mod.AudioBuffer.from_array(
        np.full((1, 256), 0.5, np.float32) if data is None else data, FS)
    src.start()
    g = ctx.create_gain(gain=gain)
    if ramp_to is not None:
        g.gain.linear_ramp_to_value_at_time(ramp_to, length / FS)
    src.connect(g)
    g.connect(ctx.destination)
    return ctx, src, g


def _sweep_rows(batch, length):
    sweeps = np.linspace(0.5, 2.0, batch, dtype=np.float32)
    base = np.geomspace(200.0, 8000.0, length, dtype=np.float32)
    return sweeps[:, None] * base[None, :]


def _pair_data():
    n = 44100
    t = np.arange(n)
    return np.stack([np.sin(t * 0.031), np.cos(t * 0.017)]).astype(np.float32)


def _assert_close(got, want, rel):
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=rel * max(np.abs(want).max(), 1e-6))


# (graph, length, batch, override, tolerance)
BATCH_CASES = [
    pytest.param("lti", 40000, 3, None, 1e-5, id="plain-lti-multiblock"),
    pytest.param("sweep", 40000, 3, "param", 1e-4, id="override-param-sweep"),
    pytest.param("lti", 20000, 2, "buffer", 1e-5, id="override-buffer-aligned"),
    pytest.param("pair", 20000, 2, "buffer", 1e-5, id="override-buffer-pair"),
]


def _build(mod, graph, length, batch, override):
    if graph == "sweep":
        ctx, src, filt = sweep_graph(mod, length)
    elif graph == "pair":
        ctx, src, filt = lti_graph(mod, length, _pair_data(), 44100.0)
    else:
        ctx, src, filt = lti_graph(mod, length)
    gb = (JGraphBatch if mod is wa else wt.GraphBatch)(ctx, batch=batch)
    if override == "param":
        gb.override_param(filt, "frequency", _sweep_rows(batch, length))
    elif override == "buffer":
        L = src.buffer.length
        gb.override_buffer(src, _buffers(batch, 2, L, seed=length))
    return gb


@pytest.mark.parametrize("graph,length,batch,override,rel", BATCH_CASES)
def test_graph_batch_matches_jax(graph, length, batch, override, rel):
    jgb = _build(wa, graph, length, batch, override)
    tgb = _build(wt, graph, length, batch, override)
    assert tgb.cg.block_frames == jgb.cg.block_frames
    assert tgb.cg.dense_params == jgb.cg.dense_params
    assert tgb.cg.order == jgb.cg.order
    assert not tgb.cg.failed
    if graph == "lti" and override is None:
        assert tgb.nb >= 2      # the FDL state crosses a block boundary
    got = tgb.render()
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    _assert_close(got.numpy(), np.asarray(jgb.render()), rel)


def test_override_buffer_restages_the_aligned_read_per_instance():
    tgb = _build(wt, "lti", 20000, 2, "buffer")
    nk = f"n{next(n for n, k in tgb.cg.kernels.items() if hasattr(k, 'read_mode'))}"
    assert tgb.cg.kernels[int(nk[1:])].read_mode == "aligned"
    batched = {lk for (k, lk) in tgb._batched_resources if k == nk}
    assert batched == {"data_rows", "edge_vals", "data_tiled"}
    res = tgb._stage()[0][2][nk]       # the one shard's resources
    assert res["data_tiled"].shape[0] == 2 and res["data_rows"].shape[0] == 2


# the CPU FFT library vectorizes across transforms and rounds the same
# transform differently for another batch count (by ~1e-7 of the signal),
# so the FDL path is held to 1e-6 x peak; a lane that bled would be off
# by the order of the signal
FFT_BATCH_REL = 1e-6


def _assert_same_lane(got, want, fft):
    if fft:
        _assert_close(got, want, FFT_BATCH_REL)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("graph", ["sweep", "lti"])
def test_lanes_do_not_bleed(graph):
    """Every lane of a batch equals a 1-instance batch with the same row
    and buffer: bit for bit on the CPU where no FFT runs."""
    length, batch = 20000, 3
    rows = _sweep_rows(batch, length)
    bufs = _buffers(batch, 2, 2 * 48000, seed=9)

    def run(lanes):
        if graph == "sweep":
            ctx, src, filt = sweep_graph(wt, length)
        else:
            ctx, src, filt = lti_graph(wt, length)
        gb = wt.GraphBatch(ctx, batch=len(lanes))
        if graph == "sweep":
            gb.override_param(filt, "frequency", rows[lanes])
        gb.override_buffer(src, bufs[lanes])
        return gb.render().numpy()

    together = run([0, 1, 2])
    for i in range(batch):
        _assert_same_lane(together[i], run([i])[0], graph == "lti")
    assert np.abs(together[0] - together[2]).max() > 1e-3


def test_batch_lane_matches_the_context_render():
    ctx, _, _ = lti_graph(wt, 30000, shaper=True)
    gb = wt.GraphBatch(ctx, batch=2)
    out = gb.render().numpy()
    want = lti_graph(wt, 30000, shaper=True)[0].start_rendering_sync().to_array()
    _assert_same_lane(out[0, :, :30000], want, fft=True)
    _assert_same_lane(out[1], out[0], fft=True)


def _mixed_corpus(mod):
    """Three ported topologies: filter sweeps, buffer -> constant lowpass ->
    WaveShaper (per-instance buffers), buffer -> gain envelope."""
    n = 12000
    bufs = _buffers(2, 2, 4096, seed=3)
    return [
        sweep_graph(mod, n, f0=200.0, f1=8000.0)[0],
        lti_graph(mod, n, bufs[0], shaper=True)[0],
        gain_graph(mod, n, ramp_to=1.0)[0],
        sweep_graph(mod, n, f0=500.0, f1=2000.0)[0],
        gain_graph(mod, n, ramp_to=0.25)[0],
        lti_graph(mod, n, bufs[1], shaper=True)[0],
    ]


def test_mixed_graph_batch_matches_jax():
    jmb = JMixedGraphBatch(_mixed_corpus(wa))
    tmb = wt.GraphBatch.from_contexts(_mixed_corpus(wt))
    assert isinstance(tmb, wt.MixedGraphBatch)
    assert tmb.num_buckets == jmb.num_buckets == 3
    got, want = tmb.render(), jmb.render()
    singles = [c.start_rendering_sync().to_array() for c in _mixed_corpus(wt)]
    for i, (g, w, s) in enumerate(zip(got, want, singles)):
        _assert_close(g, w, 1e-4 if i in (0, 3) else 1e-5)
        _assert_same_lane(g, s, fft=i in (1, 5))
    # lanes in one bucket differ (their own automation and buffers)
    assert np.abs(got[0] - got[3]).max() > 1e-3
    assert np.abs(got[1] - got[5]).max() > 1e-3


def test_baked_constant_split():
    # identical structure but a different CONSTANT param value must land in
    # different buckets (constants are shared tensors of the plan)
    def make(gain):
        return gain_graph(wt, 4096, ramp_to=None, gain=gain)[0]

    mb = wt.MixedGraphBatch([make(0.3), make(0.6)])
    assert mb.num_buckets == 2
    outs = mb.render()
    np.testing.assert_array_equal(outs[0], make(0.3).start_rendering_sync().to_array())
    np.testing.assert_array_equal(outs[1], make(0.6).start_rendering_sync().to_array())
    assert np.abs(outs[0] - outs[1]).max() > 0.1


def test_fingerprint_hashes_baked_tensors_by_value():
    a = torch.tensor([1.0, 2.0])
    b = torch.tensor([1.0, 3.0])

    def toks(v, staged=frozenset()):
        out = []
        tbatch._fp_tokens(v, out, staged_ids=staged)
        return out

    assert toks(a) != toks(b)
    assert toks(a) == toks(a.clone())
    # a staged resource keeps its shape/dtype token only
    assert toks(a, frozenset({id(a)})) == toks(b, frozenset({id(b)}))
    assert toks(torch.device("cpu")) != toks(torch.device("meta"))

    # a kernel that keeps baked values in a tensor (not a resource) splits
    ctxs = [gain_graph(wt, 4096)[0] for _ in range(2)]
    cgs = [wt.MixedGraphBatch([c])._buckets[0][1].cg for c in ctxs]
    fps = [tbatch.graph_fingerprint(cg) for cg in cgs]
    assert fps[0] == fps[1]
    for cg, v in zip(cgs, (0.5, 0.7)):
        cg.kernels[max(cg.kernels)].baked = torch.tensor([v])
    assert tbatch.graph_fingerprint(cgs[0]) != tbatch.graph_fingerprint(cgs[1])


def test_per_instance_buffers_share_one_compile():
    # same topology, different audio buffers (same shape): one bucket,
    # buffer contents stacked per instance through the resource path
    def make(seed):
        data = _buffers(1, 1, 2048, seed)[0]
        return gain_graph(wt, 4096, data=data, ramp_to=1.0)[0]

    mb = wt.MixedGraphBatch([make(s) for s in (1, 2, 3)])
    assert mb.num_buckets == 1
    outs = mb.render()
    for i, s in enumerate((1, 2, 3)):
        np.testing.assert_allclose(outs[i], make(s).start_rendering_sync().to_array(),
                                   atol=2e-5, err_msg=f"instance {i}")


def test_mixed_lengths_bucket_apart():
    mb = wt.MixedGraphBatch([gain_graph(wt, 4096)[0], gain_graph(wt, 8192)[0]])
    assert mb.num_buckets == 2
    outs = mb.render()
    assert outs[0].shape == (1, 4096)
    assert outs[1].shape == (1, 8192)


def test_render_stream_double_buffered_matches_direct():
    gb = wt.GraphBatch(gain_graph(wt, 2048)[0], batch=3)
    direct = gb.render_i16().numpy()
    assert direct.dtype == np.int16
    outs = list(gb.render_stream(3, fetch="i16"))
    assert len(outs) == 3
    for o in outs:
        np.testing.assert_array_equal(o, direct)


def test_render_stream_with_updates():
    ctx, _, g = gain_graph(wt, 2048)
    gb = wt.GraphBatch(ctx, batch=2)

    def updates(gb_, k):
        gb_.override_param(g, "gain", np.full((2, 2048), 0.1 * (k + 1), np.float32))

    outs = list(gb.render_stream(3, updates=updates, fetch="f32"))
    assert len(outs) == 3
    # batch k's output scales with the gain set before dispatch k
    np.testing.assert_allclose(outs[1], outs[0] * 2.0, atol=1e-5)
    np.testing.assert_allclose(outs[2], outs[0] * 3.0, atol=1e-5)
    for k, o in enumerate(outs):
        updates(gb, k)
        np.testing.assert_array_equal(o, gb.render().numpy())


def test_bounces_are_the_codecs_of_the_render():
    gb = wt.GraphBatch(gain_graph(wt, 2048)[0], batch=2)
    x = gb.render()
    q = gb.render_i16(seed=3)
    assert q.shape == x.shape and q.dtype == torch.int16
    torch.testing.assert_close(q, td.dither_i16_reference(x, 3), rtol=0, atol=0)
    u = gb.render_u8(seed=3)
    assert u.dtype == torch.uint8
    torch.testing.assert_close(u, td.ulaw_u8_reference(x, 3), rtol=0, atol=0)
    assert np.abs(td.ulaw_decode_u8(u.numpy()) - x.numpy()).max() < 0.06


def test_override_errors():
    ctx, src, g = gain_graph(wt, 1024, ramp_to=None, gain=0.5)
    gb = wt.GraphBatch(ctx, batch=2)
    with pytest.raises(ValueError, match="constant"):
        gb.override_param(g, "gain", np.ones((2, 1024), np.float32))
    with pytest.raises(ValueError, match="expected"):
        gb.override_param(g, "gain", np.ones((3, 1024), np.float32))
    with pytest.raises(ValueError, match="expected"):
        gb.override_buffer(src, np.ones((2, 1, 7), np.float32))
    with pytest.raises(ValueError, match="no staged resource"):
        gb.override_buffer(g, np.ones((2, 4), np.float32))
    # a fused grain bank's envelope rows are not read
    gb.cg.kernels[g.node_id].lane_env = True
    with pytest.raises(ValueError, match="grain bank"):
        gb.override_param(g, "v0.gain", np.ones((2, 1024), np.float32))


def test_per_instance_curves_share_one_bucket():
    # the curve rides the staged-resource path: two WaveShapers that differ
    # only in their curves bucket together and each lane uses its own curve
    def make(k):
        ctx, src, filt = lti_graph(wt, 8192)
        ws = ctx.create_wave_shaper(
            curve=np.tanh(k * np.linspace(-2, 2, 512)).astype(np.float32))
        filt.disconnect()
        filt.connect(ws)
        ws.connect(ctx.destination)
        return ctx

    mb = wt.MixedGraphBatch([make(1.0), make(3.0)])
    assert mb.num_buckets == 1
    gb = mb._buckets[0][1]
    assert any(lk == "curve" for _, lk in gb._batched_resources)
    outs = mb.render()
    for k, out in zip((1.0, 3.0), outs):
        _assert_same_lane(out, make(k).start_rendering_sync().to_array(), fft=True)
    assert np.abs(outs[0] - outs[1]).max() > 1e-2


@pytest.mark.parametrize("shared", [True, False])
def test_batched_ops_equal_per_instance_calls(shared):
    """The ops' leading instance axis against one call per instance."""
    from webaudio_tpu_torch.ops import bufread, fft_conv, mixing

    rng = np.random.default_rng(11)
    n, C, P, B = 3, 2, 256, 1024
    x = torch.from_numpy(rng.standard_normal((n, C, B)).astype(np.float32))
    ir = rng.standard_normal((n, 700)).astype(np.float32) * 0.1
    h = torch.from_numpy(np.stack([fft_conv.partition_ir(i, P) for i in ir]))
    h = h[:1] if shared else h                       # (1 or n, 1, K, P+1)
    K = h.shape[-2]
    st = fft_conv.init_state(C, K, P, "cpu")
    bst = {k: v.unsqueeze(0).repeat(n, *(1,) * v.dim()) for k, v in st.items()}
    for _ in range(2):
        bst, y = fft_conv.partitioned_conv_block(bst, x, h, P)
    for i in range(n):
        sti = st
        for _ in range(2):
            sti, yi = fft_conv.partitioned_conv_block(
                sti, x[i], h[0 if shared else i], P)
        np.testing.assert_allclose(y[i].numpy(), yi.numpy(), atol=1e-6)
        np.testing.assert_allclose(bst["tail"][i].numpy(), sti["tail"].numpy(),
                                   atol=0)

    data = rng.standard_normal((n, C, 50)).astype(np.float32)
    rows = torch.from_numpy(np.stack([bufread.pair_rows(d) for d in data]))
    rows = rows[:1] if shared else rows
    idx = torch.from_numpy(rng.integers(0, 49, size=40))
    a, b = bufread.gather_pairs(rows, idx)
    assert a.shape == (rows.shape[0], C, 40)
    for i in range(rows.shape[0]):
        ai, bi = bufread.gather_pairs(rows[i], idx)
        assert torch.equal(a[i], ai) and torch.equal(b[i], bi)

    sp = mixing.ChannelInterpretation.SPEAKERS
    for c_out in (1, 2, 6):
        got = mixing.mix(x, c_out, sp)
        for i in range(n):
            assert torch.equal(got[i], mixing.mix(x[i], c_out, sp))
    silent = mixing.sum_inputs([], 2, sp, 64, "cpu", batch=n)
    assert silent.shape == (n, 2, 64) and not silent.any()


def test_curve_table_rows_equal_single_curves():
    """An (R, n) curve table shapes x[r] through row r, as R calls would."""
    from webaudio_tpu_torch.ops import curve_kernel as ck

    rng = np.random.default_rng(12)
    x = rng.uniform(-1.4, 1.4, (3, 2, 500)).astype(np.float32)
    x[0, 0, :3] = [np.nan, np.inf, -np.inf]
    x = torch.from_numpy(x)
    table = torch.from_numpy(np.tanh(rng.uniform(0.5, 3.0, (3, 1))
                                     * np.linspace(-2, 2, 64)).astype(np.float32))
    got = ck.curve_lookup(table, x)
    for r in range(3):
        want = ck.curve_lookup_reference(table[r], x[r])
        assert torch.equal(got[r].isnan(), want.isnan())
        assert torch.equal(torch.nan_to_num(got[r]), torch.nan_to_num(want))
    assert torch.equal(torch.nan_to_num(ck.curve_lookup(table[:1], x)),
                       torch.nan_to_num(ck.curve_lookup(table[0], x)))


# --- change-tracked staging --------------------------------------------------


def _mastering(length=12000, n=4, seed=0):
    """The mastering chain as the augment benchmark builds it, at a CPU size
    (one block of 12,032 frames, so every row has a pad): a looping
    source -> WaveShaper (4x) -> compressor whose threshold and ratio carry
    automation (dense rows) -> analyser.  -> (GraphBatch, nodes) with each
    instance's clip overridden, as staged once at set-up."""
    rng = np.random.default_rng(seed)
    ctx = _context(wt, 2, length)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = wt.AudioBuffer.from_array(_buffers(1, 2, 3000, seed)[0], FS)
    src.start()
    shaper = ctx.create_wave_shaper(
        oversample="4x", curve=np.tanh(np.linspace(-2, 2, 256)).astype(np.float32))
    comp = ctx.create_dynamics_compressor(threshold=-20.0, ratio=4.0)
    for p, v in ((comp.threshold, -20.0), (comp.ratio, 4.0)):
        p.set_value_at_time(v, 0.0)
        p.set_value_at_time(v + 1.0, length / FS / 2)
    an = ctx.create_analyser(fft_size=2048)
    src.connect(shaper)
    shaper.connect(comp)
    comp.connect(an)
    an.connect(ctx.destination)
    gb = wt.GraphBatch(ctx, batch=n)
    nodes = {"source": src, "shaper": shaper, "compressor": comp}
    clips = _buffers(n, 2, 3000, seed + 1)
    gb.override_buffer(src, clips)
    nodes["clips"] = clips
    return gb, nodes


def _request(rng, n, length):
    """One augment request's settings: a curve, a threshold row and a ratio
    row an instance."""
    drive = rng.uniform(1.0, 5.0, n)
    curves = np.tanh(drive[:, None] * np.linspace(-1, 1, 256)[None])
    rows = {name: np.repeat(rng.uniform(lo, hi, (n, 1)), length, 1)
            for name, lo, hi in (("threshold", -30, -10), ("ratio", 2, 12))}
    return curves.astype(np.float32), {k: v.astype(np.float32)
                                       for k, v in rows.items()}


def _apply(gb, nodes, given):
    """Replay the overrides `given` names onto a batch, in one order."""
    if "clips" in given:
        gb.override_buffer(nodes["source"], given["clips"])
    if "curves" in given:
        gb.override_buffer(nodes["shaper"], given["curves"], key="curve")
    for name in ("threshold", "ratio"):
        if name in given:
            gb.override_param(nodes["compressor"], name, given[name])


def _write_host_row(gb, node, param, dense):
    """Write a row into the batch's staged device rows as staging did
    before it tracked changes: padded on the host with its last value
    repeated, then written strided into each shard's (k, nb, P, B)."""
    B = gb.cg.block_frames
    pad = gb.nb * B - dense.shape[1]
    arr = np.concatenate([dense, np.repeat(dense[:, -1:], pad, 1)], axis=1)
    key = (node.node_id, param)
    row = gb.cg.dense_params.index(gb.cg.param_alias.get(key, key))
    gb._stage()
    for sh, xs in zip(gb._shards, gb._staged_xs):
        xs[:, :, row, :] = torch.from_numpy(
            arr[sh.lo:sh.hi].reshape(sh.hi - sh.lo, gb.nb, B)).to(xs.device)


def _fresh(given, seed=7):
    """A new batch staged once with every override `given` holds, its rows
    written into its staged device rows (`_write_host_row`): its render
    and int16 bounce."""
    gb, nodes = _mastering()
    _apply(gb, nodes, {k: v for k, v in given.items()
                       if k not in ("threshold", "ratio")})
    for name in ("threshold", "ratio"):
        if name in given:
            _write_host_row(gb, nodes["compressor"], name, given[name])
    return gb.render(), gb.render_i16(seed)


def _names(gb, nodes):
    k = tbatch._compiler._k
    src, shaper, comp = (k(nodes[n].node_id)
                         for n in ("source", "shaper", "compressor"))
    return {"layouts": {f"{src}.{lk}" for lk in
                        ("data_rows", "edge_vals", "data_tiled")},
            "curve": f"{shaper}.curve",
            "threshold": f"{comp}.threshold", "ratio": f"{comp}.ratio"}


def test_staging_sends_only_what_an_override_changed():
    """The augment's request sequence on a mastering batch: every render is
    bit-equal to a fresh batch staged once with the same overrides, and
    `stage_stats` shows the clip layouts kept across requests, sent again
    only after the source's override, and one row sent after a one-row
    override."""
    gb, nodes = _mastering()
    names = _names(gb, nodes)
    n, T = gb.batch, gb.total_frames
    every = names["layouts"] | {names["curve"], names["threshold"],
                                names["ratio"]}
    rng = np.random.default_rng(3)
    given = {"clips": nodes["clips"]}

    def check():
        """Render and bounce; -> the render's stage_stats."""
        got = gb.render()
        stats = gb.stage_stats
        q = gb.render_i16(7)
        assert gb.stage_stats["uploaded"] == []       # nothing changed
        want, wq = _fresh(given)
        assert torch.equal(got, want) and torch.equal(q, wq)
        assert every <= set(stats["uploaded"]) | set(stats["kept"])
        assert not set(stats["uploaded"]) & set(stats["kept"])
        return stats

    # overrides made before the first render land, the threshold twice
    # before one stage (the last wins)
    curves, rows = _request(rng, n, T)
    gb.override_param(nodes["compressor"], "threshold", rows["ratio"])
    given.update(curves=curves, **rows)
    _apply(gb, nodes, given)
    stats = check()
    assert stats["kept"] == [] and stats["bytes_kept"] == 0
    row_bytes = 4 * n * gb.nb * gb.cg.block_frames
    for _ in range(2):
        curves, rows = _request(rng, n, T)
        given.update(curves=curves, **rows)
        _apply(gb, nodes, {"curves": curves, **rows})
        stats = check()
        assert sorted(stats["uploaded"]) == sorted(
            [names["curve"], names["threshold"], names["ratio"]])
        assert names["layouts"] <= set(stats["kept"])
        assert stats["bytes_uploaded"] == 4 * n * 256 + 2 * row_bytes
    given["clips"] = _buffers(n, 2, 3000, seed=9)
    gb.override_buffer(nodes["source"], given["clips"])
    stats = check()
    assert sorted(stats["uploaded"]) == sorted(names["layouts"])
    rows = _request(rng, n, T)[1]
    given["threshold"] = rows["threshold"]
    gb.override_param(nodes["compressor"], "threshold", rows["threshold"])
    stats = check()
    assert stats["uploaded"] == [names["threshold"]]
    assert stats["bytes_uploaded"] == row_bytes


@pytest.mark.parametrize("graph,length", [("sweep", 40000), ("sweep", 32768),
                                          ("gain", 2048)])
def test_row_override_equals_host_padded_rows(graph, length):
    """A row sent by a stage lands in its blocks of the device rows as the
    host pad and strided write put it there (3 blocks with a pad, 2 whole
    blocks, one block), and the other rows stay."""
    ctx, _, node = (sweep_graph if graph == "sweep" else gain_graph)(wt, length)
    param = "frequency" if graph == "sweep" else "gain"
    gb = wt.GraphBatch(ctx, batch=3)
    gb.render()
    want = gb._staged_xs[0].clone()
    rows = np.random.default_rng(length).uniform(
        100.0, 900.0, (3, length)).astype(np.float32)
    gb.override_param(node, param, rows)
    gb.render()
    assert gb.stage_stats["uploaded"] == [f"n{node.node_id}.{param}"]
    ref = wt.GraphBatch(ctx, batch=3)
    _write_host_row(ref, node, param, rows)
    assert torch.equal(gb._staged_xs[0], ref._staged_xs[0])
    assert not torch.equal(ref._staged_xs[0], want)


def test_mixed_bucket_takes_a_row_after_its_first_render():
    """A MixedGraphBatch bucket stages its members' own rows (row snapshots
    its first render sends); a row override after that sends that row
    alone, and the render equals a batch with the row written on the
    host."""
    ramps = (0.3, 0.9)
    ctxs = [gain_graph(wt, 2048, ramp_to=r)[0] for r in ramps]
    mb = wt.MixedGraphBatch(ctxs)
    assert mb.num_buckets == 1
    (_, gb), = mb._buckets
    for r, out in zip(ramps, mb.render()):
        np.testing.assert_array_equal(
            out, gain_graph(wt, 2048, ramp_to=r)[0].start_rendering_sync()
            .to_array())
    _, _, g = gain_graph(wt, 2048)
    rows = np.linspace(1.0, 0.2, 2048, dtype=np.float32)[None] * \
        np.array([[1.0], [0.5]], np.float32)
    gb.override_param(g, "gain", rows)
    outs = mb.render()
    assert gb.stage_stats["uploaded"] == [f"n{g.node_id}.gain"]
    ref = wt.GraphBatch(gain_graph(wt, 2048)[0], batch=2)
    _write_host_row(ref, g, "gain", rows)
    want = ref.render().numpy()[..., :2048]
    for j, out in enumerate(outs):
        np.testing.assert_array_equal(out, want[j])
