"""The port on an NVIDIA GPU: kernels against their plain versions and a
render on the card against the same render on the CPU.

Every test here needs CUDA and skips without it (the online context and
the media nodes included).  The file imports no JAX,
so on a GPU machine without JAX it runs on its own:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

import webaudio_tpu_torch as wt
from webaudio_tpu_torch.ops import curve_kernel as ck
from webaudio_tpu_torch.ops import dither as td

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _inputs(m, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.6, 1.6, m).astype(np.float32)
    x[:5] = [np.nan, np.inf, -np.inf, -1.0, 1.0]
    return x


def _same(got, want):
    """Bit for bit, NaN positions included."""
    return torch.equal(got.isnan(), want.isnan()) and torch.equal(
        torch.nan_to_num(got), torch.nan_to_num(want))


def _tanh_curve(n, device, scale=1.0):
    return torch.from_numpy(np.tanh(scale * np.linspace(-2, 2, n)).astype(
        np.float32)).to(device)


# one curve goes through the read-only cache at any length: 12288 was the
# last curve an earlier kernel kept in shared memory, 12289 the first it
# did not; 8192 and 8193 the table kernel's boundary; 44100 MDN's
# distortion curve
@pytest.mark.parametrize("n", (2, 2048, 8192, 8193, 12288, 12289, 44100,
                               65536))
def test_curve_kernel_equals_plain_version(cuda, n):
    x = torch.from_numpy(_inputs(2 * 262144)).reshape(2, -1).to(cuda)
    curve = _tanh_curve(n, cuda)
    before = ck.curve_lookup.launches
    got = ck.curve_lookup(curve, x)
    torch.cuda.synchronize()
    assert ck.curve_lookup.launches == before + 1
    assert _same(got, ck.curve_lookup_reference(curve, x))


# lengths that are not a multiple of 4, and none at all (nothing launches)
@pytest.mark.parametrize("m", (0, 1, 3, 5, 262147))
@pytest.mark.parametrize("n", (2048, 65536))
def test_curve_kernel_any_length(cuda, m, n):
    x = torch.from_numpy(_inputs(max(m, 8), seed=m)[:m].copy()).to(cuda)
    curve = _tanh_curve(n, cuda)
    before = ck.curve_lookup.launches
    got = ck.curve_lookup(curve, x)
    torch.cuda.synchronize()
    assert ck.curve_lookup.launches == before + (m > 0)
    assert got.shape == x.shape
    assert _same(got, ck.curve_lookup_reference(curve, x))


def _table(R, n, device, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.tanh(
        rng.uniform(0.5, 3.0, (R, 1)) * np.linspace(-2, 2, n)).astype(
            np.float32)).to(device)


# the kernel each launch plan names on a table of n-point curves: staged
# up to 8192 points, through the read-only cache beyond
_TABLE_MODES = {2048: "shared", 8192: "shared", 8193: "cached",
                65536: "cached"}


# x and y one float (or more) off a 16-byte boundary, through the launcher:
# one curve, and tables staged and through the cache
@pytest.mark.parametrize("x_off,y_off", [(1, 1), (1, 0), (0, 1), (3, 2)])
@pytest.mark.parametrize("rows,n", [(1, 2048), (3, 2048), (3, 8193)])
def test_curve_kernel_offset_pointers(cuda, x_off, y_off, rows, n):
    kern = ck._kernel()
    x = _offset(torch.from_numpy(_inputs(rows * (2 * 4099 + 7),
                                         seed=x_off)).to(cuda), x_off)
    x = x.reshape(rows, -1)
    curve = _tanh_curve(n, cuda) if rows == 1 else _table(rows, n, cuda, n)
    want = ck.curve_lookup_reference(curve, x)
    out = _offset(torch.full_like(want, float("nan")), y_off)
    ck._launch(kern, out, curve, x)
    torch.cuda.synchronize()
    assert _same(out, want)


# per-instance curves: R rows of 2 x L samples (4099: a row length that is
# not a multiple of 4; 16384: a shaper bucket's; 300 rows: more than one
# wave's blocks, so each block walks several rows and, staged, refills its
# copy), on each side of the longest staged curve
@pytest.mark.parametrize("R,L", [(1, 4099), (3, 4099), (32, 4099),
                                 (32, 16384), (300, 99)])
@pytest.mark.parametrize("n", (2048, 8192, 8193))
def test_curve_table_rows(cuda, R, L, n):
    x = torch.from_numpy(_inputs(R * 2 * L, seed=R)).reshape(R, 2, -1).to(
        cuda)
    table = _table(R, n, cuda, R)
    got = ck.curve_lookup(table, x)
    torch.cuda.synchronize()
    assert _same(got, ck.curve_lookup_reference(table, x))
    if R > 1:
        assert ck._kernel().plan(n, x.numel(), R).mode == _TABLE_MODES[n]


def test_curve_kernel_refuses_more_shared_memory_than_the_card_has(cuda):
    kern = ck._kernel()
    x = torch.zeros((2, 64), device=cuda)
    curve = _tanh_curve(2048, cuda)
    plan = ck.LaunchPlan("shared", (1, 1), 512, kern.limits()[1] + 16)
    with pytest.raises(wt.KernelError):
        ck._launch(kern, torch.empty_like(x), curve, x, plan)
    # and the refusal is not left behind for the next launch
    assert _same(ck.curve_lookup(curve, x), ck.curve_lookup_reference(curve, x))


@pytest.mark.parametrize("bad", ["non-contiguous", "f64", "curve on cpu"])
def test_curve_kernel_refuses_what_it_does_not_take(cuda, bad):
    x = torch.zeros((2, 64), device=cuda)
    curve = torch.linspace(-1, 1, 16, device=cuda)
    if bad == "non-contiguous":
        x = x.t()
    elif bad == "f64":
        x = x.double()
    else:
        curve = curve.cpu()
    with pytest.raises(wt.KernelError):
        ck.curve_lookup(curve, x)


def _slice(device, frames):
    ctx = wt.OfflineAudioContext(2, frames, 48000.0, device=device)
    data = np.sin(np.arange(2 * 48000) * 0.03, dtype=np.float32)[None].repeat(2, 0)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = wt.AudioBuffer.from_array(data, 48000.0)
    src.start()
    filt = ctx.create_biquad_filter(type="lowpass", frequency=2000.0, q=2.0)
    shaper = ctx.create_wave_shaper(
        curve=np.tanh(np.linspace(-2, 2, 2048)).astype(np.float32))
    src.connect(filt)
    filt.connect(shaper)
    shaper.connect(ctx.destination)
    return ctx


def test_slice_render_on_the_card_matches_cpu(cuda):
    frames = 3 * 48000
    ctx = _slice(cuda, frames)
    before = ck.curve_lookup.launches
    got = ctx.start_rendering_sync().to_array()
    assert ck.curve_lookup.launches > before
    assert not any(seg["failed"] for seg in ctx.render_stats["segments"])
    want = _slice("cpu", frames).start_rendering_sync().to_array()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


# (98304 + 3) samples a row: a ragged tail of groups of 4
@pytest.mark.parametrize("seed", (0, 7, 2**32 - 1))
@pytest.mark.parametrize("misaligned", (False, True))
def test_quantize_kernels_equal_plain_versions(cuda, seed, misaligned):
    x = torch.from_numpy(_inputs(4 * (98304 + 3) + 1, seed=seed & 0xFF)).to(cuda)
    # a view starting one float in is not 16-byte aligned: scalar loads
    x = x[1:] if misaligned else x[:-1]
    x = x.reshape(4, -1)
    before = (td.dither_i16.launches, td.ulaw_u8.launches)
    q = td.dither_i16(x, seed)
    u = td.ulaw_u8(x, seed)
    torch.cuda.synchronize()
    assert (td.dither_i16.launches, td.ulaw_u8.launches) == \
        (before[0] + 1, before[1] + 1)
    assert q.dtype == torch.int16 and u.dtype == torch.uint8
    assert torch.equal(q, td.dither_i16_reference(x, seed))
    # torch's log1p and the kernel's log1pf are both CUDA's libdevice
    # log1pf; should they ever round apart, a code moves by one at most,
    # and only at a rare floor boundary.  Any two uniforms give codes at
    # most one apart, so the count bounds the random stream: a wrong Philox
    # key, counter or word order moves about half of all codes
    diff = (u.int() - td.ulaw_u8_reference(x, seed).int()).abs()
    assert int(diff.max()) <= 1
    assert int(torch.count_nonzero(diff)) <= 1e-6 * diff.numel()


@pytest.mark.parametrize("fn", (td.dither_i16, td.ulaw_u8))
@pytest.mark.parametrize("bad", ["non-contiguous", "f64", "x on cpu"])
def test_quantize_kernels_refuse_what_they_do_not_take(cuda, fn, bad):
    x = torch.zeros((4, 64), device=cuda)
    out = None
    if bad == "non-contiguous":
        x = x.t()
    elif bad == "f64":
        x = x.double()
    else:
        out = torch.empty((4, 64), device=cuda,
                          dtype=torch.int16 if fn is td.dither_i16 else torch.uint8)
        x = x.cpu()
    with pytest.raises(wt.KernelError):
        fn(x, 0, out=out)


def test_write_wav_dithers_a_card_tensor_on_the_card(cuda):
    from webaudio_tpu_torch.media import wav

    x = _inputs(3001, seed=9)[5:]                     # one channel, 1-d
    before = td.dither_i16.launches
    blob = wav.write_wav(None, torch.from_numpy(x).to(cuda), 48000.0,
                         bits=16, dither=True)
    assert td.dither_i16.launches == before + 1
    assert blob == wav.write_wav(None, x, 48000.0, bits=16, dither=True)


@pytest.mark.parametrize("n", sorted(_TABLE_MODES))
def test_curve_table_kernel_equals_plain_version(cuda, n):
    # one curve per instance: x (R, C, B) through an (R, n) table; 8192
    # points the longest the plan stages, 8193 through the read-only cache
    x = torch.from_numpy(_inputs(3 * 2 * 4099)).reshape(3, 2, -1).to(cuda)
    table = _table(3, n, cuda, n)
    before = ck.curve_lookup.launches
    got = ck.curve_lookup(table, x)
    torch.cuda.synchronize()
    assert ck.curve_lookup.launches == before + 1
    want = ck.curve_lookup_reference(table, x)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    for r in range(3):
        assert torch.equal(torch.nan_to_num(got[r]), torch.nan_to_num(
            ck.curve_lookup_reference(table[r], x[r])))


def _sweep_batch(device, batch, frames=20000):
    ctx = wt.OfflineAudioContext(2, frames, 48000.0, device=device)
    data = np.sin(np.arange(2 * 48000) * 0.03, dtype=np.float32)[None].repeat(2, 0)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = wt.AudioBuffer.from_array(data, 48000.0)
    src.start()
    filt = ctx.create_biquad_filter(type="lowpass", q=3.0)
    filt.frequency.set_value_at_time(200.0, 0.0)
    filt.frequency.exponential_ramp_to_value_at_time(8000.0, frames / 48000.0)
    src.connect(filt)
    filt.connect(ctx.destination)
    gb = wt.GraphBatch(ctx, batch=batch)
    rows = np.linspace(0.5, 2.0, batch, dtype=np.float32)[:, None] * \
        np.geomspace(200.0, 8000.0, frames, dtype=np.float32)[None]
    gb.override_param(filt, "frequency", rows)
    return gb


def test_graph_batch_on_the_card_matches_cpu(cuda):
    got = _sweep_batch(cuda, 4)
    want = _sweep_batch("cpu", 4).render().numpy()
    out = got.render()
    assert out.device.type == "cuda"
    # the a-rate sweep's sin/cos ulps, as in test_slice_render_on_the_card
    np.testing.assert_allclose(out.cpu().numpy(), want,
                               atol=1e-4 * np.abs(want).max())
    before = td.dither_i16.launches
    direct = got.render_i16(seed=5)
    assert td.dither_i16.launches == before + 1
    assert torch.equal(direct, td.dither_i16_reference(out, 5))
    for host in got.render_stream(2, fetch="i16"):
        np.testing.assert_array_equal(host, got.render_i16().cpu().numpy())


def _monotone_playheads(rng, R, B, g, w, L):
    base = rng.integers(0, L - w, size=(R, B // g))
    step = rng.random((R, B // g)) * ((w - 3) / g)
    pif = base[:, :, None] + np.arange(g) * step[:, :, None]
    pi = np.floor(pif).astype(np.int32).reshape(1, R, B)
    fr = (pif - np.floor(pif)).astype(np.float32).reshape(1, R, B)
    return pi, fr


@pytest.mark.parametrize("g,w", ((16, 21), (32, 39), (128, 192)))
@pytest.mark.parametrize("C", (1, 2, 3))
@pytest.mark.parametrize("wrap", (False, True))
def test_grouped_lerp_kernel_equals_plain_version(cuda, g, w, C, wrap):
    from webaudio_tpu_torch.ops import grain_read as gr

    rng = np.random.default_rng(g + C + wrap)
    L, R, B = 5000, 3, 128 * 37
    pi, fr = _monotone_playheads(rng, R, B, g, w, L)
    ext = torch.from_numpy(rng.standard_normal((2, C, L + w + 2)).astype(
        np.float32)).to(cuda)
    p = torch.from_numpy(pi + (7 * L if wrap else 0)).to(cuda)
    f = torch.from_numpy(fr).to(cuda)
    before = gr.grouped_lerp.launches
    got = gr.grouped_lerp(ext, p, f, g, w, L if wrap else 0)
    torch.cuda.synchronize()
    assert gr.grouped_lerp.launches == before + 1
    assert got.shape == (2, C, R, B)
    assert torch.equal(got, gr.grouped_lerp_reference(ext, p, f, g, w,
                                                      L if wrap else 0))


@pytest.mark.parametrize("C", (1, 2))
@pytest.mark.parametrize("instances", (1, 3))
@pytest.mark.parametrize("own_buffers", (False, True))
def test_grain_bank_kernel_equals_plain_version(cuda, C, instances,
                                                own_buffers):
    from webaudio_tpu_torch.ops import grain_read as gr

    rng = np.random.default_rng(C * 10 + instances)
    K, nq, L, frame0 = 5, 40, 3000, 128 * 7
    B = nq * 128
    sv = frame0 + rng.integers(-300, B, (instances, K, nq))
    base = rng.integers(-150, L + 20, (instances, K, nq))
    base[..., ::4] = L - 60                  # grains crossing the end
    base[..., 1::7] = -40                    # and the start
    data = np.sin(np.arange(L) * 0.05)[None].repeat(C, 0)
    ext = np.zeros((1, C, L + 41), np.float32)
    ext[0, :, :L] = data
    ext[0, :, L] = 2.0 * data[:, L - 1] - data[:, L - 2]
    if own_buffers:                          # one buffer per instance
        ext = ext * np.linspace(0.5, 1.0, instances)[:, None, None] \
            .astype(np.float32)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in (
        ext, ext[:, :, L],
        (rng.random((instances, K, nq)) > 0.15).astype(np.int32),
        sv.astype(np.int32),
        (sv + rng.integers(0, 600, (instances, K, nq))).astype(np.int32),
        base.astype(np.int32),
        rng.random((instances, K, nq)).astype(np.float32),
        rng.uniform(0.9, 1.37, (instances, K, nq)).astype(np.float32),
        rng.uniform(-0.2, 1.3, (1, K, B)).astype(np.float32))]
    args += [frame0, L, 0.0, 1.0]
    before = gr.grain_bank.launches
    got = gr.grain_bank(*args)
    torch.cuda.synchronize()
    assert gr.grain_bank.launches == before + 1
    assert got.shape == (instances, C, B)
    assert torch.equal(got, gr.grain_bank_reference(*args))


def _offset(t, offset):
    """A contiguous copy of t that starts `offset` elements past a 16-byte
    boundary."""
    flat = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = flat[offset:].view(t.shape)
    view.copy_(t)
    return view


# groups of 1 and 3 on rows whose length is not a multiple of 4, 2, 8, 16
# and 128 (warp-shuffle group ends), 12 (a multiple of 4 that does not
# divide 128: the scalar path)
@pytest.mark.parametrize("g,w,B", [(1, 4, 1001), (1, 4, 1024), (2, 5, 1026),
                                   (3, 7, 999), (8, 12, 4736),
                                   (12, 16, 4740), (16, 21, 4736),
                                   (128, 192, 4736)])
@pytest.mark.parametrize("C", (1, 2, 3))
@pytest.mark.parametrize("wrap", (False, True))
def test_grouped_lerp_kernel_edge_shapes(cuda, g, w, B, C, wrap):
    from webaudio_tpu_torch.ops import grain_read as gr

    rng = np.random.default_rng(7 * g + B + C + wrap)
    L, R = 5000, 3
    pi, fr = _monotone_playheads(rng, R, B, g, w, L)
    ext = torch.from_numpy(rng.standard_normal((1, C, L + w + 2)).astype(
        np.float32)).to(cuda)
    pis = torch.from_numpy(np.concatenate(
        [pi, pi + 11]) + (7 * L if wrap else 0)).to(cuda)   # per instance
    frs = torch.from_numpy(np.concatenate([fr, fr[:, ::-1].copy()])).to(cuda)
    for p, f, offset in ((pis, frs, 0), (pis[:1], frs[:1], 1),
                         (pis, frs, 3)):
        p, f = _offset(p, offset), _offset(f, offset)
        want = gr.grouped_lerp_reference(ext, p, f, g, w, L if wrap else 0)
        before = gr.grouped_lerp.launches
        got = gr.grouped_lerp(ext, p, f, g, w, L if wrap else 0)
        torch.cuda.synchronize()
        assert gr.grouped_lerp.launches == before + 1
        assert torch.equal(got, want)
        # the kernel's own launcher, into an output off a 16-byte boundary
        out = _offset(torch.full_like(want, float("nan")), offset)
        gr._launch_lerp(gr._launchers()["grouped_lerp"], out, ext, p, f, g,
                        w, L if wrap else 0)
        torch.cuda.synchronize()
        assert torch.equal(out, want)


# one and three quanta and the 400-grain block's 3,446; one lane, 9 lanes
# (two load chunks) and 33 (more lanes than a warp has threads); which of
# (ext, the lane fields, gain) carry the instance axis; gain and out one
# float past a 16-byte boundary (the scalar path)
@pytest.mark.parametrize("nq,K", [(1, 1), (3, 9), (3, 33), (40, 33),
                                  (3446, 5), (3446, 9)])
@pytest.mark.parametrize("axes", [(False, True, True), (True, False, False),
                                  (True, True, True)])
@pytest.mark.parametrize("offset", (0, 1))
def test_grain_bank_kernel_edge_shapes(cuda, nq, K, axes, offset):
    from webaudio_tpu_torch.ops import grain_read as gr

    rng = np.random.default_rng(nq + K + offset + 10 * sum(axes))
    I, C, L, frame0 = 2, 2, 3000, 128 * 5
    B = nq * 128
    ext_i, fld_i, gain_i = axes
    nf = I if fld_i else 1
    sv = frame0 + 128 * np.arange(nq) + rng.integers(-200, 128, (nf, K, nq))
    base = rng.integers(-150, L + 20, (nf, K, nq))
    base[..., ::4] = L - 60                  # grains crossing the end
    base[..., 1::7] = -40                    # and the start
    ok = (rng.random((nf, K, nq)) > 0.15).astype(np.int32)
    ev = sv + rng.integers(0, 600, (nf, K, nq))
    ok[:, 0] = 1                             # lane 0 sounds throughout
    sv[:, 0], ev[:, 0] = frame0 - 200, frame0 + B
    data = np.sin(np.arange(L) * 0.05)[None].repeat(C, 0)
    ext = np.zeros((I if ext_i else 1, C, L + 41), np.float32)
    ext[:, :, :L] = data * np.float32([1.0, -0.5])[:ext.shape[0], None, None]
    ext[:, :, L] = 2.0 * ext[:, :, L - 1] - ext[:, :, L - 2]
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in (
        ext, ext[:, :, L], ok, sv.astype(np.int32), ev.astype(np.int32),
        base.astype(np.int32),
        rng.random((nf, K, nq)).astype(np.float32),
        rng.uniform(0.9, 1.37, (nf, K, nq)).astype(np.float32))]
    args.append(_offset(torch.from_numpy(rng.uniform(
        -0.2, 1.3, (I if gain_i else 1, K, B)).astype(np.float32)).to(cuda),
        offset))
    args += [frame0, L, 0.0, 1.0]
    before = gr.grain_bank.launches
    got = gr.grain_bank(*args)
    torch.cuda.synchronize()
    assert gr.grain_bank.launches == before + 1
    want = gr.grain_bank_reference(*args)
    assert float(want.abs().max()) > 0.1
    assert torch.equal(got, want)
    # the kernel's own launcher, into an output `offset` floats off a
    # 16-byte boundary
    out = _offset(torch.full_like(want, float("nan")), offset)
    gr._launch_bank(gr._launchers()["grain_bank"], out, *args)
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def test_grain_bank_kernel_keeps_signed_zeros_and_nans(cuda):
    # bit for bit, also in the sign of zeros and where NaN lands: lanes
    # whose playhead starts at -0.0 or stands still, envelopes of -0.0,
    # NaN and +-inf, a NaN in the buffer
    from webaudio_tpu_torch.ops import grain_read as gr

    rng = np.random.default_rng(3)
    K, nq, L, C = 6, 8, 2000, 2
    B = nq * 128
    ok = np.ones((1, K, nq), np.int32)
    sv = np.full((1, K, nq), -10, np.int32)
    ev = np.full((1, K, nq), B + 10, np.int32)
    base = rng.integers(100, L - 400, (1, K, nq)).astype(np.int32)
    base_f = rng.random((1, K, nq)).astype(np.float32)
    base_f[:, 0] = -0.0
    base_f[:, 1] = 0.0
    rate = rng.uniform(0.5, 1.5, (1, K, nq)).astype(np.float32)
    rate[:, 0, ::2] = -0.0
    rate[:, 1] = 0.0
    gain = rng.uniform(-0.2, 1.3, (1, K, B)).astype(np.float32)
    gain[:, 2, ::7] = -0.0
    gain[:, 3, ::11] = np.nan
    gain[:, 4, ::13] = np.inf
    gain[:, 4, 1::13] = -np.inf
    data = np.sin(np.arange(L) * 0.05)[None].repeat(C, 0).astype(np.float32)
    data[1, 700] = np.nan
    ext = np.zeros((1, C, L + 41), np.float32)
    ext[0, :, :L] = data
    ext[0, :, L] = 2.0 * data[:, L - 1] - data[:, L - 2]
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in (
        ext, ext[:, :, L], ok, sv, ev, base, base_f, rate, gain)]
    args += [0, L, 0.0, 1.0]
    got = gr.grain_bank(*args)
    want = gr.grain_bank_reference(*args)
    torch.cuda.synchronize()
    nan = torch.isnan(want)
    assert bool(nan.any()) and torch.equal(torch.isnan(got), nan)
    assert torch.equal(got.view(torch.int32)[~nan],
                       want.view(torch.int32)[~nan])


@pytest.mark.parametrize("bad", ["non-contiguous", "f64", "int64 pi",
                                 "pi on cpu", "bank: 3 channels"])
def test_grain_kernels_refuse_what_they_do_not_take(cuda, bad):
    from webaudio_tpu_torch.ops import grain_read as gr

    ext = torch.zeros((1, 2, 100), device=cuda)
    pi = torch.zeros((1, 2, 64), dtype=torch.int32, device=cuda)
    fr = torch.zeros((1, 2, 64), device=cuda)
    with pytest.raises(wt.KernelError):
        if bad == "non-contiguous":
            gr.grouped_lerp(ext, pi.transpose(1, 2), fr.transpose(1, 2), 16, 21)
        elif bad == "f64":
            gr.grouped_lerp(ext, pi, fr.double(), 16, 21)
        elif bad == "int64 pi":
            gr.grouped_lerp(ext, pi.long(), fr, 16, 21)
        elif bad == "pi on cpu":
            gr.grouped_lerp(ext, pi.cpu(), fr, 16, 21)
        else:
            f = torch.zeros((1, 1, 1), device=cuda)
            i = torch.zeros((1, 1, 1), dtype=torch.int32, device=cuda)
            gr.grain_bank(torch.zeros((1, 3, 100), device=cuda),
                          torch.zeros((1, 3), device=cuda), i, i, i, i, f, f,
                          torch.zeros((1, 1, 128), device=cuda), 0, 90, 0.0,
                          1.0)


def _grains(device, seconds=1.0, n=48):
    fs = 44100.0
    ctx = wt.OfflineAudioContext(2, int(fs * seconds), fs, device=device)
    data = np.sin(np.arange(2 * 44100) * 0.05, dtype=np.float32)[None] \
        .repeat(2, 0)
    sample = wt.AudioBuffer.from_array(data, fs)
    rng = np.random.RandomState(1)
    for i in range(n):
        when = i * (seconds - 0.2) / n
        src = ctx.create_buffer_source(
            playback_rate=float(0.9 + 0.2 * rng.rand()))
        src.buffer = sample
        env = ctx.create_gain(gain=0.0)
        env.gain.set_value_at_time(0.0, when)
        env.gain.linear_ramp_to_value_at_time(0.4, when + 0.045)
        env.gain.linear_ramp_to_value_at_time(0.0, when + 0.09)
        src.connect(env)
        env.connect(ctx.destination)
        src.start(when, 0.3 + 1.8 * i / n, 0.09)
    return ctx


@pytest.mark.parametrize("mode", ("auto", "grouped_v", "window"))
def test_granular_render_on_the_card_matches_cpu(cuda, monkeypatch, mode):
    from webaudio_tpu_torch.ops import grain_read as gr

    if mode == "auto":
        monkeypatch.delenv("WEBAUDIO_GRAIN_READ", raising=False)
    else:
        monkeypatch.setenv("WEBAUDIO_GRAIN_READ", mode)
    before = (gr.grain_bank.launches, gr.grouped_lerp.launches)
    got = _grains(cuda).start_rendering_sync().to_array()
    moved = (gr.grain_bank.launches - before[0],
             gr.grouped_lerp.launches - before[1])
    assert moved == ((1, 0) if mode == "auto" else (0, 1))
    want = _grains("cpu").start_rendering_sync().to_array()
    assert np.abs(want).max() > 0.1
    # the same f32 steps on both devices (the kernels equal their plain
    # versions bit for bit); the f64 playhead per quantum is IEEE on both
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _dense_bank(device):
    # 32 overlapping sources with per-voice gains: the (V, B) bank
    ctx = wt.OfflineAudioContext(1, 1024, 44100.0, device=device)
    buf = wt.AudioBuffer.from_array(
        np.linspace(-1.0, 1.0, 64, dtype=np.float32)[None], 44100.0)
    for i in range(32):
        s = ctx.create_buffer_source(playback_rate=0.75 + 0.01 * i)
        s.buffer = buf
        g = ctx.create_gain(gain=0.5 + 0.01 * i)
        if i == 3:
            g.gain.linear_ramp_to_value_at_time(0.9, 0.01)
        s.connect(g)
        g.connect(ctx.destination)
        s.start(i / 44100.0)
    return ctx


def test_dense_bank_on_the_card_matches_cpu(cuda):
    got = _dense_bank(cuda).start_rendering_sync().to_array()
    want = _dense_bank("cpu").start_rendering_sync().to_array()
    assert np.abs(want).max() > 1.0
    # the 32-voice sum runs in another order on each device
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("mode", ("grouped_v", "window"))
@pytest.mark.parametrize("loop", (True, False))
def test_single_source_grouped_read_on_the_card(cuda, monkeypatch, mode, loop):
    from webaudio_tpu_torch.ops import grain_read as gr

    def render(device):
        ctx = wt.OfflineAudioContext(2, 20000, 44100.0, device=device)
        data = np.random.default_rng(4).standard_normal((2, 5000)).astype(
            np.float32)
        src = ctx.create_buffer_source(playback_rate=0.73, loop=loop)
        src.buffer = wt.AudioBuffer.from_array(data, 44100.0)
        src.connect(ctx.destination)
        src.start(0.0, 0.0 if loop else 0.05)
        return ctx.start_rendering_sync().to_array()

    monkeypatch.setenv("WEBAUDIO_GRAIN_READ", mode)
    before = gr.grouped_lerp.launches
    got = render(cuda)
    assert gr.grouped_lerp.launches > before
    np.testing.assert_array_equal(got, render("cpu"))


# --- oscillator voice banks --------------------------------------------------


def test_curve_kernel_at_the_voice_table_shape(cuda):
    """K1 over a fused distortion bank's block (chip_smoke.py's S7): a
    (64, 2048) table of per-voice curves over (64, 96000) voices."""
    table = _table(64, 2048, cuda, seed=11)
    x = torch.from_numpy(_inputs(64 * 96000, seed=11)).reshape(64, -1).to(cuda)
    before = ck.curve_lookup.launches
    got = ck.curve_lookup(table, x)
    torch.cuda.synchronize()
    assert ck.curve_lookup.launches == before + 1
    assert _same(got, ck.curve_lookup_reference(table, x))


def _distortion_bank(device, seconds=1.0, voices=64):
    """Sawtooth voices, each through its own WaveShaper (a tanh curve at a
    drive of its own), a constant lowpass, a gain envelope and a constant
    StereoPanner, into the destination (chip_smoke.py's phase q, 1 s)."""
    ctx = wt.OfflineAudioContext(2, int(48000 * seconds), 48000.0,
                                 device=device)
    rng = np.random.RandomState(7)
    for _ in range(voices):
        o = ctx.create_oscillator(type="sawtooth",
                                  frequency=float(55 + 440 * rng.rand()))
        shaper = ctx.create_wave_shaper(curve=np.tanh(
            (1 + 7 * rng.rand()) * np.linspace(-1, 1, 2048)).astype(
                np.float32))
        filt = ctx.create_biquad_filter(
            type="lowpass", frequency=float(600 + 4000 * rng.rand()), q=1.0)
        env = ctx.create_gain(gain=0.0)
        t0 = 0.3 * rng.rand()
        env.gain.set_value_at_time(0.0, t0)
        env.gain.linear_ramp_to_value_at_time(0.1, t0 + 0.02)
        panner = ctx.create_stereo_panner(pan=float(2 * rng.rand() - 1))
        o.connect(shaper)
        shaper.connect(filt)
        filt.connect(env)
        env.connect(panner)
        panner.connect(ctx.destination)
        o.start(t0)
    return ctx


def test_distortion_bank_on_the_card_matches_cpu(cuda):
    """The four stages fuse into one bank whose shaper launches K1 over the
    table of per-voice curves; the render on the card within 1e-5 x peak of
    the CPU render."""
    before = ck.curve_lookup.launches
    got = _distortion_bank(cuda).start_rendering_sync().to_array()
    assert ck.curve_lookup.launches > before
    want = _distortion_bank("cpu").start_rendering_sync().to_array()
    peak = float(np.abs(want).max())
    assert np.isfinite(got).all() and peak > 0.1
    assert float(np.abs(got - want).max()) <= 1e-5 * peak


# --- the mastering chain: the detector kernel, the resamplers, the chain ----


def _detector_inputs(N, B, per_sample, seed=3):
    rng = np.random.default_rng(seed)
    x = (np.abs(rng.standard_normal((N, B))) * 20).astype(np.float32)
    x[:, B // 3: B // 2] = 25.0             # a held attack, then a release
    y0 = rng.uniform(0, 10, N).astype(np.float32)
    shape = (N, B) if per_sample else (N,)
    at = rng.uniform(0.5, 0.999, shape).astype(np.float32)
    rt = rng.uniform(0.9, 0.99999, shape).astype(np.float32)
    return y0, x, at, rt


def _detector_equal(cuda, y0, x, at, rt, offset=0):
    """detector_scan on the card against detector_reference, bit for bit,
    one launch counted.  offset > 0 puts every input `offset` floats into
    its storage, so its rows start off a 16-byte boundary."""
    from webaudio_tpu_torch.ops import detector as tdet

    want = tdet.detector_reference(*(torch.from_numpy(a)
                                     for a in (y0, x, at, rt)))

    def dev(a):
        if not offset:
            return torch.from_numpy(a).to(cuda)
        store = torch.zeros(a.size + offset, device=cuda)
        view = store[offset:].view(a.shape)
        view.copy_(torch.from_numpy(a))
        assert view.is_contiguous() and view.data_ptr() % 16
        return view

    before = tdet.detector_scan.launches
    got = tdet.detector_scan(*(dev(a) for a in (y0, x, at, rt)))
    torch.cuda.synchronize()
    assert tdet.detector_scan.launches == before + 1
    assert torch.equal(got.cpu(), want)


# N about the CTA sizes: 8 instances a CTA at 1,024 (1,025 leaves one in
# the last CTA), 1 up to the 132 SMs; B 4,097 crosses a tile and is not a
# multiple of 4 (the 4-byte cp.async path), B 1 and 3 are one short tile
@pytest.mark.parametrize("N", [1, 7, 8, 9, 132, 1024, 1025])
@pytest.mark.parametrize("B", [1, 3, 4097])
@pytest.mark.parametrize("per_sample", (False, True))
@pytest.mark.parametrize("edge", ("none", "attack 0", "release 0"))
def test_detector_kernel_equals_plain_version(cuda, N, B, per_sample, edge):
    """csrc/detector.cu against detector_reference, bit for bit: one or a
    tau an instance or a sample, attack 0 (y resets to x), release 0."""
    y0, x, at, rt = _detector_inputs(N, B, per_sample)
    if edge == "attack 0":
        at[:] = 0.0
    elif edge == "release 0":
        rt[:] = 0.0
    _detector_equal(cuda, y0, x, at, rt)


@pytest.mark.parametrize("N", [1, 1024])
@pytest.mark.parametrize("tiles,delta", [(1, -1), (1, 0), (1, 1), (4, 1),
                                         (9, -1)])
@pytest.mark.parametrize("per_sample", (False, True))
def test_detector_kernel_at_tile_boundaries(cuda, N, tiles, delta,
                                            per_sample):
    """B a tile's length (from the kernel's launch plan) times 1, 4 or 9,
    plus or minus one: the last tile short by one, exact, or one sample
    long; 9 tiles wrap the 4-slot ring twice."""
    from webaudio_tpu_torch.ops import detector as tdet

    tile = tdet.launch_plan(N, 1 << 20, per_sample)["tile"]
    B = tiles * tile + delta
    assert tdet.launch_plan(N, B, per_sample)["tile"] == tile
    _detector_equal(cuda, *_detector_inputs(N, B, per_sample, seed=B))


@pytest.mark.parametrize("N,B", [(1, 4096), (1, 4097), (1024, 4096),
                                 (9, 12288)])
@pytest.mark.parametrize("per_sample", (False, True))
def test_detector_kernel_unaligned_rows(cuda, N, B, per_sample):
    """Inputs one float into their storage (a column slice made contiguous
    at an odd offset): no row starts on a 16-byte boundary, so the kernel
    stages through 4-byte copies, and must agree all the same."""
    _detector_equal(cuda, *_detector_inputs(N, B, per_sample), offset=1)


@pytest.mark.parametrize("bad", ["non-contiguous", "f64", "x on cpu"])
def test_detector_kernel_refuses_what_it_does_not_take(cuda, bad):
    from webaudio_tpu_torch.ops import detector as tdet

    y0, x, at, rt = (torch.from_numpy(a).to(cuda)
                     for a in _detector_inputs(4, 256, False))
    if bad == "non-contiguous":
        x = x.t().contiguous().t()
    elif bad == "f64":
        x = x.double()
    else:
        x = x.cpu()
    with pytest.raises(wt.KernelError):
        tdet.detector_scan(y0, x, at, rt)


@pytest.fixture
def default_tf32(cuda):
    """PyTorch's own TF32 defaults (cuDNN convolutions in TF32), whatever
    the process set before."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    yield cuda
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.parametrize("factor", (2, 4))
def test_resamplers_on_the_card_match_cpu_under_default_tf32(default_tf32,
                                                             factor):
    """upsample and downsample on the card equal the CPU's to 1e-6 x peak
    with cuDNN allowed to run f32 convolutions in TF32: they convolve in
    f64, which has no TF32 path."""
    from webaudio_tpu_torch.ops import resample as trs

    rng = np.random.default_rng(factor)
    x = torch.from_numpy(rng.standard_normal((3, 2, 20000)).astype(np.float32))
    up_st = torch.from_numpy(rng.standard_normal((3, 2, 48)).astype(np.float32))
    dn_st = trs.down_fir_state(2, factor).expand(3, 2, -1)
    want_up, _ = trs.upsample(x, factor, up_st)
    want, _ = trs.downsample(want_up, factor, dn_st)
    got_up, _ = trs.upsample(x.to(default_tf32), factor, up_st.to(default_tf32))
    got, _ = trs.downsample(got_up, factor, dn_st.to(default_tf32))
    for g, w in ((got_up, want_up), (got, want)):
        assert float((g.cpu() - w).abs().max()) <= 1e-6 * float(w.abs().max())


def _mastering(device, seconds=1.0):
    """chip_smoke.py's phase t graph, cut to `seconds`: a looping buffer ->
    WaveShaper 4x (tanh over 2,048 points) -> DynamicsCompressor (threshold
    -18 dB, ratio 4) -> AnalyserNode -> destination."""
    n = int(48000 * seconds)
    ctx = wt.OfflineAudioContext(2, n, 48000.0, device=device)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = wt.AudioBuffer.from_array(np.sin(
        np.arange(2 * 48000) * 0.03, dtype=np.float32)[None].repeat(2, 0),
        48000.0)
    src.start()
    shaper = ctx.create_wave_shaper(oversample="4x", curve=np.tanh(
        np.linspace(-2, 2, 2048)).astype(np.float32))
    comp = ctx.create_dynamics_compressor(threshold=-18.0, ratio=4.0)
    an = ctx.create_analyser(fft_size=2048)
    src.connect(shaper)
    shaper.connect(comp)
    comp.connect(an)
    an.connect(ctx.destination)
    return ctx, comp, an


@pytest.mark.parametrize("detector", ("auto", "seq", "chunked"))
def test_mastering_chain_on_the_card_matches_cpu(default_tf32, monkeypatch,
                                                 detector):
    """The chain on the card under PyTorch's default TF32 flags within
    1e-5 x peak of the CPU render with the same WEBAUDIO_DETECTOR (by
    default the CPU runs the chunked fixed point and the card the detector
    kernel), K1 launched once (one block), the detector kernel once by
    default and for =seq, never for =chunked; the compressor's reduction
    and the analyser's ring as on the CPU."""
    from webaudio_tpu_torch.ops import detector as tdet

    monkeypatch.setenv("WEBAUDIO_DETECTOR", detector)
    k1, det = ck.curve_lookup.launches, tdet.detector_scan.launches
    ctx, comp, an = _mastering(default_tf32)
    got = ctx.start_rendering_sync().to_array()
    assert ck.curve_lookup.launches == k1 + 1
    assert tdet.detector_scan.launches == det + (detector != "chunked")
    cctx, ccomp, can = _mastering("cpu")
    want = cctx.start_rendering_sync().to_array()
    peak = float(np.abs(want).max())
    assert np.isfinite(got).all() and peak > 0.1
    assert float(np.abs(got - want).max()) <= 1e-5 * peak
    assert comp.reduction == pytest.approx(ccomp.reduction, abs=1e-4)
    ring, cring = np.zeros(2048, np.float32), np.zeros(2048, np.float32)
    an.get_float_time_domain_data(ring)
    can.get_float_time_domain_data(cring)
    assert float(np.abs(ring - cring).max()) <= 1e-5 * peak


# --- delay, feedback cycles, convolver, IIR ----------------------------------


def _delay_net(device, seconds=1.0, automate_fb=False):
    """tests/test_two_rate.py's delay network: a 330 Hz burst into a 0.2 s
    delay fed back through a 0.6 gain (a two-rate plan)."""
    ctx = wt.OfflineAudioContext(2, int(48000 * seconds), 48000.0,
                                 device=device)
    o = ctx.create_oscillator(frequency=330.0)
    o.start()
    o.stop(0.25)
    d = ctx.create_delay(max_delay_time=0.5, delay_time=0.2)
    fb = ctx.create_gain(gain=0.6)
    if automate_fb:
        fb.gain.set_value_at_time(0.7, 0.0)
        fb.gain.linear_ramp_to_value_at_time(0.2, seconds)
    o.connect(d)
    d.connect(fb)
    fb.connect(d)
    fb.connect(ctx.destination)
    o.connect(ctx.destination)
    return ctx


def _reverb(device, seconds=1.0, dry=None):
    """BASELINE config 3 at 44.1 kHz with bench.py's synthetic buffer and a
    0.5 s synthetic stereo IR: a looping source into a convolver and a
    0.31 s delay fed back through 0.4."""
    fs = 44100.0
    ctx = wt.OfflineAudioContext(2, int(fs * seconds), fs, device=device)
    if dry is None:
        dry = np.sin(np.arange(2 * 44100) * 0.03, dtype=np.float32)[None] \
            .repeat(2, 0)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = wt.AudioBuffer.from_array(dry, fs)
    src.start()
    rng = np.random.default_rng(3)
    n = int(fs * 0.5)
    ir = rng.standard_normal((2, n)) * np.exp(-np.arange(n) / fs / 0.4)
    verb = ctx.create_convolver(
        buffer=wt.AudioBuffer.from_array(ir.astype(np.float32), fs))
    src.connect(verb)
    verb.connect(ctx.destination)
    d = ctx.create_delay(max_delay_time=1.0, delay_time=0.31)
    fb = ctx.create_gain(gain=0.4)
    src.connect(d)
    d.connect(fb)
    fb.connect(d)
    fb.connect(ctx.destination)
    return ctx


@pytest.mark.parametrize("automate_fb", [False, True])
def test_two_rate_on_the_card_is_bit_equal_to_other_stepping(
        cuda, monkeypatch, automate_fb):
    """Two-rate, single-rate and one-quantum renders of a delay network are
    bit-equal on the card, and within 1e-5 x peak of the CPU render."""
    got = _delay_net(cuda, automate_fb=automate_fb).start_rendering_sync() \
        .to_array()
    for env in ({"WEBAUDIO_TWO_RATE": "0"}, {"WEBAUDIO_CYCLE_BLOCKS": "1"}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        other = _delay_net(cuda, automate_fb=automate_fb) \
            .start_rendering_sync().to_array()
        for k in env:
            monkeypatch.delenv(k)
        np.testing.assert_array_equal(got, other)
    want = _delay_net("cpu", automate_fb=automate_fb).start_rendering_sync() \
        .to_array()
    peak = float(np.abs(want).max())
    assert peak > 0.1 and float(np.abs(got - want).max()) <= 1e-5 * peak


def test_reverb_on_the_card_matches_cpu(cuda, monkeypatch):
    """Config 3 (two-rate, cuFFT) within 1e-5 x peak of the CPU render;
    its one-quantum render (K = 345 partitions of 128) within 3e-6."""
    got = _reverb(cuda).start_rendering_sync().to_array()
    want = _reverb("cpu").start_rendering_sync().to_array()
    peak = float(np.abs(want).max())
    assert peak > 0.1 and float(np.abs(got - want).max()) <= 1e-5 * peak
    monkeypatch.setenv("WEBAUDIO_CYCLE_BLOCKS", "1")
    one = _reverb(cuda).start_rendering_sync().to_array()
    assert float(np.abs(one - got).max()) <= 3e-6


def test_reverb_batch_on_the_card_repeats_and_matches_own_renders(cuda):
    """A GraphBatch of the reverb with a clip per instance: rendered twice
    it gives the same output (the ring is written out of place), and each
    lane is within 1e-6 x peak of its own render."""
    ctx = _reverb(cuda)
    (src,) = [n for n in ctx._nodes.values() if hasattr(n, "loop")]
    rng = np.random.default_rng(9)
    clips = rng.uniform(-0.5, 0.5, (3, 2, 88200)).astype(np.float32)
    gb = wt.GraphBatch(ctx, batch=3)
    gb.override_buffer(src, clips)
    first = gb.render().cpu().numpy()[..., :ctx.length]
    np.testing.assert_array_equal(first, gb.render().cpu().numpy()
                                  [..., :ctx.length])
    for i in (0, 2):
        want = _reverb(cuda, dry=clips[i]).start_rendering_sync().to_array()
        peak = float(np.abs(want).max())
        assert float(np.abs(first[i] - want).max()) <= 1e-6 * peak


def test_iir_filter_on_the_card_matches_cpu(cuda):
    from scipy.signal import butter

    outs = []
    for device in (cuda, "cpu"):
        ctx = wt.OfflineAudioContext(2, 48000, 48000.0, device=device)
        src = ctx.create_buffer_source(loop=True)
        src.buffer = wt.AudioBuffer.from_array(
            np.sin(np.arange(96000) * 0.03, dtype=np.float32)[None]
            .repeat(2, 0), 48000.0)
        src.start()
        f = ctx.create_iir_filter(*butter(4, 0.2))
        src.connect(f)
        f.connect(ctx.destination)
        outs.append(ctx.start_rendering_sync().to_array())
    peak = float(np.abs(outs[1]).max())
    assert float(np.abs(outs[0] - outs[1]).max()) <= 1e-5 * peak


# --- spatial audio and the automated-rate playhead ---------------------------

def _hrtf_orbit(device, seconds=1.0, fs=44100.0):
    """Config 4 (a sawtooth into an HRTF panner, the listener orbiting)
    cut to `seconds`."""
    ctx = wt.OfflineAudioContext(2, int(fs * seconds), fs, device=device)
    osc = ctx.create_oscillator(type="sawtooth", frequency=220.0)
    p = ctx.create_panner(panning_model="HRTF", position_z=-2.0)
    for t in np.linspace(0, 10.0, 64):
        ang = 2 * np.pi * t / 10.0
        ctx.listener.position_x.linear_ramp_to_value_at_time(
            float(np.sin(ang) * 3), float(t))
        ctx.listener.position_z.linear_ramp_to_value_at_time(
            float(np.cos(ang) * 3), float(t))
    osc.connect(p)
    p.connect(ctx.destination)
    osc.start()
    return ctx


def _close(got, want, rel):
    peak = float(np.abs(want).max())
    assert peak > 0.01 and np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= rel * peak


def test_hrtf_on_the_card_matches_cpu(cuda):
    """cuFFT's and the CPU's 256-point transforms, the gathers and the
    crossfade: within 1e-5 x peak."""
    _close(_hrtf_orbit(cuda).start_rendering_sync().to_array(),
           _hrtf_orbit("cpu").start_rendering_sync().to_array(), 1e-5)


def _playhead(device, model=None, x=(1.5, -1.5), z=-2.0):
    """A looping buffer with its playback rate ramped through 0 into
    reverse and its detune stepped (the cumsum playhead), optionally into
    a panner moving along x at depth z while the listener turns."""
    ctx = wt.OfflineAudioContext(2, 24000, 48000.0, device=device)
    src = ctx.create_buffer_source(loop=True, loop_start=0.01, loop_end=0.2)
    src.buffer = wt.AudioBuffer.from_array(
        np.sin(np.arange(12000) * 0.021, dtype=np.float32)[None], 44100.0)
    src.playback_rate.set_value_at_time(1.3, 0.0)
    src.playback_rate.linear_ramp_to_value_at_time(-0.7, 0.5)
    src.detune.set_value_at_time(250.0, 0.2)
    out = src
    if model is not None:
        out = ctx.create_panner(panning_model=model, distance_model="linear",
                                max_distance=20.0, position_x=x[0],
                                position_z=z)
        out.position_x.linear_ramp_to_value_at_time(x[1], 0.5)
        ctx.listener.forward_x.linear_ramp_to_value_at_time(0.5, 0.4)
        src.connect(out)
    out.connect(ctx.destination)
    src.start(0.001)
    return ctx


def test_automated_playhead_on_the_card_matches_cpu(cuda):
    """The cumsum playhead's within-quantum f32 sums run in XLA's order on
    every device (ops/oscillator.py::cumsum_f32), so the card holds to the
    CPU render within 1e-5 x peak."""
    _close(_playhead(cuda).start_rendering_sync().to_array(),
           _playhead("cpu").start_rendering_sync().to_array(), 1e-5)


@pytest.mark.parametrize("model", ("equalpower", "HRTF"))
def test_panner_on_the_card_matches_cpu(cuda, model):
    """The panners on the automated playhead, the source kept in front of
    the listener: within 1e-5 x peak of the CPU render."""
    _close(_playhead(cuda, model).start_rendering_sync().to_array(),
           _playhead("cpu", model).start_rendering_sync().to_array(), 1e-5)


def test_equal_power_across_the_ear_axis_on_the_card(cuda):
    """A source crossing the listener's ear axis: there the azimuth is an
    f32 arccos of a cosine within an ulp of -1, which moves it by
    hundredths of a degree and the far ear's gain sin(xx pi / 2) by up to
    ~2.5e-4 of its value from an f64 geometry's on this graph
    (tests/test_torch_spatial.py::test_f32_geometry_at_the_ear_axis).  The
    card's and the CPU's f32 trigonometry round apart there, so they are
    held to 3e-4 x peak, the geometry's own conditioning; away from the
    axis the test above holds 1e-5."""
    got = _playhead(cuda, "equalpower", x=(2.0, -4.0), z=-1.0)
    want = _playhead("cpu", "equalpower", x=(2.0, -4.0), z=-1.0)
    _close(got.start_rendering_sync().to_array(),
           want.start_rendering_sync().to_array(), 3e-4)


def test_binaural_batch_on_the_card_repeats_and_matches_own_renders(cuda):
    """Per-instance listener rows (override_param on the listener) and
    clips: a second render equals the first, each lane its own render
    within 1e-6 x peak."""
    fs, n = 44100.0, 8192
    rng = np.random.default_rng(4)
    clips = rng.uniform(-0.5, 0.5, (3, 1, 3000)).astype(np.float32)
    xs = rng.uniform(-3.0, 3.0, (3, 2)).astype(np.float32)

    def build(i=None):
        ctx = wt.OfflineAudioContext(2, n, fs, device=cuda)
        src = ctx.create_buffer_source(loop=True)
        src.buffer = wt.AudioBuffer.from_array(
            clips[0] if i is None else clips[i], fs)
        p = ctx.create_panner(panning_model="HRTF", position_z=-1.0)
        a, b = (0.0, 1.0) if i is None else xs[i]
        ctx.listener.position_x.set_value_at_time(float(a), 0.0)
        ctx.listener.position_x.linear_ramp_to_value_at_time(float(b), n / fs)
        src.connect(p)
        p.connect(ctx.destination)
        src.start()
        return ctx, src

    rows = np.stack([build(i)[0].listener.position_x.compile_for_render(
        fs, n).dense[:n] for i in range(3)])
    ctx, src = build()
    gb = wt.GraphBatch(ctx, batch=3)
    gb.override_buffer(src, clips)
    gb.override_param(ctx.listener, "position_x", rows)
    first = gb.render().cpu().numpy()[..., :n]
    np.testing.assert_array_equal(first, gb.render().cpu().numpy()[..., :n])
    for i in range(3):
        _close(first[i], build(i)[0].start_rendering_sync().to_array(), 1e-6)


# --- sessions, segments, futures and user code on the card ------------------

@pytest.mark.parametrize("graph", ["slice", "reverb"])
def test_session_save_and_restore_bit_equal_on_the_card(cuda, graph,
                                                        tmp_path):
    """A RenderSession saved mid-render and restored into a fresh context
    continues bit-equal to the uninterrupted session on the card; the card's
    session is within 1e-5 x peak of the CPU's."""
    def make(device):
        return _slice(device, 65536) if graph == "slice" else \
            _reverb(device, 1.5)

    def steps(s, n):
        return np.concatenate([s.step(16384) for _ in range(n)], axis=1)

    whole = steps(wt.RenderSession(make(cuda)), 4)
    s = wt.RenderSession(make(cuda))
    steps(s, 2)
    path = str(tmp_path / "s.npz")
    s.save(path)
    r = wt.RenderSession(make(cuda))
    r.restore(path)
    np.testing.assert_array_equal(steps(r, 2), whole[:, 32768:])
    want = steps(wt.RenderSession(make("cpu")), 4)
    np.testing.assert_allclose(whole, want, atol=1e-5 * np.abs(want).max())


def test_time_sharded_on_the_card_matches_sequential(cuda):
    """8 segments in turn on the card against the sequential render
    (tests/test_segments.py's bound), K1 once a block in each."""
    from webaudio_tpu_torch.parallel.segments import render_time_sharded

    seq = _slice(cuda, 96000).start_rendering_sync().to_array()
    before = ck.curve_lookup.launches
    got = render_time_sharded(_slice(cuda, 96000), devices=[cuda] * 8)
    assert ck.curve_lookup.launches - before >= 8
    np.testing.assert_allclose(got, seq, atol=5e-5 * np.abs(seq).max())


def _worklet_graph(device, frames=96000):
    class Crush(wt.AudioWorkletProcessor):
        @classmethod
        def parameter_descriptors(cls):
            return [wt.AudioParamDescriptor("bits", wt.AutomationRate.A,
                                            8.0, 1.0, 16.0)]

        def init_state(self, rc):
            return {"n": torch.zeros((), dtype=torch.int64,
                                     device=rc.device)}

        def process(self, scope, state, inputs, params):
            steps = torch.pow(2.0, torch.floor(params["bits"]))
            return ({"n": state["n"] + scope.frames},
                    [torch.round(inputs[0] * steps) / steps])

    ctx = wt.OfflineAudioContext(2, frames, 48000.0, device=device)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = wt.AudioBuffer.from_array(
        np.sin(np.arange(2 * 48000) * 0.03, dtype=np.float32)[None]
        .repeat(2, 0), 48000.0)
    src.start()
    node = ctx.create_audio_worklet(Crush)
    node.parameters["bits"].set_value_at_time(12.0, 0.0)
    node.parameters["bits"].linear_ramp_to_value_at_time(3.0,
                                                         frames / 48000.0)
    src.connect(node)
    node.connect(ctx.destination)
    return ctx, node


def test_worklet_on_the_card_matches_cpu(cuda):
    """A worklet processor (a looping buffer read exactly, integer bit
    depths, so both devices quantize the same values) renders on the card
    as on the CPU, alone and as lanes of a batch under vmap."""
    got = _worklet_graph(cuda)[0].start_rendering_sync().to_array()
    want = _worklet_graph("cpu")[0].start_rendering_sync().to_array()
    np.testing.assert_array_equal(got, want)
    ctx, node = _worklet_graph(cuda)
    gb = wt.GraphBatch(ctx, batch=4)
    out = gb.render().cpu().numpy()[..., :96000]
    (wk,) = [k for k in gb.cg.kernels.values()
             if type(k).__name__ == "_WorkletKernel"]
    assert wk.vmap_ok
    for i in range(4):
        np.testing.assert_array_equal(out[i], want)


def test_script_processor_latency_on_the_card(cuda):
    """The handler's input comes back x2, delayed by exactly two buffers."""
    seen = []

    def handler(ev):
        seen.append(np.array(ev.input_buffer))
        ev.output_buffer[:] = ev.input_buffer * 2.0

    ctx = _slice(cuda, 48000)
    shaper = [n for n in ctx._nodes.values()
              if type(n).__name__ == "WaveShaperNode"][0]
    shaper.disconnect()
    sp = ctx.create_script_processor(1024, 2, 2)
    sp.set_onaudioprocess(handler)
    shaper.connect(sp)
    sp.connect(ctx.destination)
    out = ctx.start_rendering_sync().to_array()
    inp = np.concatenate(seen, axis=1)
    np.testing.assert_array_equal(out[:, :2048], 0.0)
    np.testing.assert_array_equal(out[:, 2048:], 2.0 * inp[:, :48000 - 2048])
    assert np.abs(out).max() > 0.5


def test_start_rendering_future_with_suspend_and_resume_on_the_card(cuda):
    """start_rendering() renders on its own thread on the card; suspend(t)
    parks it until resume(), and a mutation made meanwhile renders as the
    same mutation through suspend_sync."""
    def filt_of(ctx):
        return [n for n in ctx._nodes.values()
                if type(n).__name__ == "BiquadFilterNode"][0]

    ctx = _slice(cuda, 96000)
    reached = ctx.suspend(1.0)
    fut = ctx.start_rendering()
    reached.result(timeout=120)
    assert ctx.state.value == "suspended" and not fut.done()
    filt_of(ctx).frequency.value = 500.0
    ctx.resume().result(timeout=10)
    got = fut.result(timeout=120).to_array()
    sync = _slice(cuda, 96000)
    sync.suspend_sync(1.0, lambda c: setattr(filt_of(c).frequency, "value",
                                             500.0))
    np.testing.assert_array_equal(got, sync.start_rendering_sync().to_array())


# --- the real-time context and media I/O on the card ------------------------

def _clip(seconds=1.0, fs=44100.0):
    t = np.arange(int(seconds * fs))
    return np.stack([0.6 * np.sin(t * 0.031) + 0.2 * np.sin(t * 0.0021),
                     0.5 * np.cos(t * 0.017)]).astype(np.float32)


def _online_stream(device, hint, frames):
    """chip_smoke.py's phase-zh graph (a 1 s clip looping through a
    lowpass, a WaveShaper 4x and a compressor), unpaced in an
    AudioContext on `device`: the callbacks after the resume, the K1 and
    detector launches and the chunks rendered."""
    import time

    from webaudio_tpu_torch.ops import detector as det

    chunks = []
    ctx = wt.AudioContext(latency_hint="playback", sample_rate=48000.0,
                          sink_id=lambda c, t: chunks.append(np.array(c)),
                          render_size_hint=hint, device=device)
    try:
        ctx.set_realtime_pacing(False)
        ctx.suspend_sync()
        del chunks[:]
        src = ctx.create_buffer_source(loop=True)
        src.buffer = wt.AudioBuffer.from_array(_clip(), 44100.0)
        filt = ctx.create_biquad_filter(type="lowpass", frequency=2000.0,
                                        q=2.0)
        shaper = ctx.create_wave_shaper(
            oversample="4x",
            curve=np.tanh(np.linspace(-2, 2, 2048)).astype(np.float32))
        comp = ctx.create_dynamics_compressor(threshold=-18.0, ratio=4.0)
        src.connect(filt)
        filt.connect(shaper)
        shaper.connect(comp)
        comp.connect(ctx.destination)
        src.start(ctx.current_time)
        f0 = ctx._frame
        kernels = (ck.curve_lookup, det.detector_scan)
        before = [k.launches for k in kernels]
        ctx.resume_sync()
        deadline = time.time() + 300
        while sum(c.shape[1] for c in chunks) < frames and \
                time.time() < deadline:
            time.sleep(0.005)
        ctx.suspend_sync()
        launches = [k.launches - b for k, b in zip(kernels, before)]
        n_chunks = (ctx._frame - f0) // ctx._buffer_frames
    finally:
        ctx.close_sync()
    return np.concatenate(chunks, axis=1)[:, :frames], launches, n_chunks


@pytest.mark.parametrize("hint", [None, 16384])
def test_online_stream_on_the_card_matches_cpu(cuda, monkeypatch, hint):
    """The AudioContext's callbacks at 1,024 and 16,384 frames on the card
    against the CPU's (both with the sequential detector), 1e-5 x peak;
    K1 and the detector kernel once a chunk on the card."""
    frames = 48000
    got, launches, n_chunks = _online_stream(cuda, hint, frames)
    assert launches == [n_chunks, n_chunks]
    monkeypatch.setenv("WEBAUDIO_DETECTOR", "seq")
    want, _, _ = _online_stream("cpu", hint, frames)
    _close(got, want, 1e-5)


def _element_render(device, path, frames):
    from webaudio_tpu_torch.media.element import MediaElement
    from webaudio_tpu_torch.nodes.media_nodes import (
        MediaElementAudioSourceNode)

    el = MediaElement(path)
    el.play()
    ctx = wt.OfflineAudioContext(2, frames, 48000.0, device=device)
    node = MediaElementAudioSourceNode(ctx, el)
    filt = ctx.create_biquad_filter(type="lowpass", frequency=2000.0, q=2.0)
    node.connect(filt)
    filt.connect(ctx.destination)
    try:
        return ctx.start_rendering_sync().to_array(), node
    finally:
        el.close()


def test_media_element_source_on_the_card_matches_cpu(cuda, tmp_path):
    """An element over a WAV file into a lowpass: one upload a block on
    the card, within 1e-5 x peak of the CPU render."""
    from webaudio_tpu_torch.media.wav import write_wav

    path = str(tmp_path / "clip.wav")
    write_wav(path, _clip(), 44100.0)
    got, node = _element_render(cuda, path, 40000)
    assert node.uploads == 3
    _close(got, _element_render("cpu", path, 40000)[0], 1e-5)


def _recorded(device):
    import time

    from webaudio_tpu_torch.media.recorder import MediaRecorder
    from webaudio_tpu_torch.media.wav import read_wav
    from webaudio_tpu_torch.nodes.media_nodes import (
        MediaStreamAudioDestinationNode)

    ctx = _slice(device, 40000)
    (shaper,) = [n for n in ctx._nodes.values()
                 if type(n).__name__ == "WaveShaperNode"]
    dest = MediaStreamAudioDestinationNode(ctx)
    shaper.connect(dest)
    rec = MediaRecorder(dest.stream)
    blobs = []
    rec.set_ondataavailable(lambda ev: blobs.append(ev.blob))
    rec.start()
    try:
        out = ctx.start_rendering_sync().to_array()
        deadline = time.time() + 30
        while dest._track._queue and time.time() < deadline:
            time.sleep(0.01)
    finally:
        rec.stop()
    return out, read_wav(blobs[0])[0], dest


def test_recorder_capture_on_the_card(cuda):
    """A MediaStreamAudioDestinationNode's recorder capture (f32 WAV)
    equals the card's render bit for bit, one host copy a block; the
    render is within 1e-5 x peak of the CPU's."""
    # warm the card's render: the recorder waits 1 s for a chunk
    _slice(cuda, 40000).start_rendering_sync()
    out, cap, dest = _recorded(cuda)
    np.testing.assert_array_equal(cap[:, :out.shape[1]], out)
    assert dest.host_copies == -(-40000 // dest.context._cg.block_frames)
    _close(out, _recorded("cpu")[0], 1e-5)


def test_decoding_into_a_context_on_the_card(cuda):
    """decode_audio_data_sync into a context on the card gives the CPU
    context's samples (decoding is host work), and a source of them
    renders on the card within 1e-5 x peak of the CPU."""
    from webaudio_tpu_torch.media.wav import write_wav

    blob = write_wav(None, _clip(), 44100.0, bits=16)
    bufs = [wt.OfflineAudioContext(2, 48000, 48000.0, device=d)
            .decode_audio_data_sync(blob) for d in (cuda, "cpu")]
    np.testing.assert_array_equal(bufs[0].to_array(), bufs[1].to_array())
    outs = []
    for d, buf in zip((cuda, "cpu"), bufs):
        ctx = wt.OfflineAudioContext(2, 48000, 48000.0, device=d)
        src = ctx.create_buffer_source()
        src.buffer = buf
        filt = ctx.create_biquad_filter(type="lowpass", frequency=2000.0,
                                        q=2.0)
        src.connect(filt)
        filt.connect(ctx.destination)
        src.start()
        outs.append(ctx.start_rendering_sync().to_array())
    _close(outs[0], outs[1], 1e-5)
