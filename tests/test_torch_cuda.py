"""The port on an NVIDIA GPU: kernels against their plain versions and a
render on the card against the same render on the CPU.

Every test here needs CUDA and skips without it.  The file imports no JAX,
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


@pytest.mark.parametrize("n", (2, 2048, 12288, 12289, 65536))
def test_curve_kernel_equals_plain_version(cuda, n):
    # 12288 is the largest curve kept in shared memory, 12289 the smallest
    # read through the read-only cache
    x = torch.from_numpy(_inputs(2 * 262144)).reshape(2, -1).to(cuda)
    curve = torch.from_numpy(
        np.tanh(np.linspace(-2, 2, n)).astype(np.float32)).to(cuda)
    before = ck.curve_lookup.launches
    got = ck.curve_lookup(curve, x)
    torch.cuda.synchronize()
    assert ck.curve_lookup.launches == before + 1
    want = ck.curve_lookup_reference(curve, x)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))


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


@pytest.mark.parametrize("n", (2048, 65536))
def test_curve_table_kernel_equals_plain_version(cuda, n):
    # one curve per instance: x (R, C, B) through an (R, n) table
    rng = np.random.default_rng(n)
    x = torch.from_numpy(_inputs(3 * 2 * 4099)).reshape(3, 2, -1).to(cuda)
    table = torch.from_numpy(np.tanh(
        rng.uniform(0.5, 3.0, (3, 1)) * np.linspace(-2, 2, n)).astype(
            np.float32)).to(cuda)
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
