"""The port's bounce codecs (webaudio_tpu_torch/ops/dither.py) on the CPU.

The TPU kernels K5 and K6 draw their dither from the TPU's own generator,
whose bits cannot be reproduced, so the port's Philox stream is held to
Random123's known answers, the codes to the JAX kernel bodies evaluated in
jnp with the port's uniforms fed in, and the dither to its statistics.
"""

import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from webaudio_tpu.media import wav as jwav
from webaudio_tpu.ops import dither as jdither
from webaudio_tpu_torch import KernelError
from webaudio_tpu_torch.media import wav as twav
from webaudio_tpu_torch.ops import dither as td

M = 0xFFFFFFFF


def _signal(n, seed=0, lo=-1.2, hi=1.2):
    rng = np.random.default_rng(seed)
    x = rng.uniform(lo, hi, n).astype(np.float32)
    x[:5] = [-np.inf, np.inf, -1.0, 1.0, 0.0]
    return x


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((M, M, M, M), (M, M), (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(counter, key, want):
    # Random123's kat_vectors for philox4x32_10
    words = td.philox4x32(tuple(torch.tensor([c]) for c in counter), key)
    assert tuple(int(w) for w in words) == want


def test_uniform_stream_is_per_element_and_exact():
    u8 = td.uniforms(8, 3, "cpu")
    u7 = td.uniforms(7, 3, "cpu")
    np.testing.assert_array_equal(u7.numpy(), u8[:7].numpy())
    u = td.uniforms(1 << 16, 3, "cpu").double().numpy()
    assert u.min() >= 0.0 and u.max() < 1.0
    assert np.all(u * 2**24 == np.floor(u * 2**24))     # multiples of 2^-24
    assert not torch.equal(td.uniforms(64, 3, "cpu"), td.uniforms(64, 4, "cpu"))


def test_dither_codes_equal_the_jax_kernel_body():
    x = _signal(50_000, seed=1)
    u = td.uniforms(x.size, 11, "cpu").numpy()
    # webaudio_tpu/ops/dither.py::_dither_kernel with the port's u
    scaled = jnp.asarray(x) * 32767.0
    want = jnp.clip(jnp.floor(scaled + jnp.asarray(u)), -32768.0, 32767.0
                    ).astype(jnp.int32)
    got = td.dither_i16_reference(torch.from_numpy(x), 11)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy().astype(np.int32), np.asarray(want))


def test_ulaw_codes_equal_the_jax_kernel_body():
    x = _signal(50_000, seed=2)
    u = td.uniforms(x.size, 12, "cpu").numpy()
    # webaudio_tpu/ops/dither.py::_ulaw_kernel with the port's u
    xc = jnp.clip(jnp.asarray(x), -1.0, 1.0)
    inv_log = jnp.float32(1.0 / np.log(1.0 + 255.0))
    y = jnp.sign(xc) * jnp.log1p(jnp.float32(255.0) * jnp.abs(xc)) * inv_log
    scaled = (y * 0.5 + 0.5) * 255.0
    want = np.asarray(jnp.clip(jnp.floor(scaled + jnp.asarray(u)), 0.0, 255.0
                               ).astype(jnp.int32))
    got = td.ulaw_u8_reference(torch.from_numpy(x), 12)
    assert got.dtype == torch.uint8
    got = got.numpy().astype(np.int32)
    # XLA's and torch's log1p may round the last ulp apart; a code can then
    # move across a floor boundary, never by more than one
    diff = np.abs(got - want)
    assert diff.max() <= 1
    assert np.count_nonzero(diff) <= 5, np.count_nonzero(diff)


def test_nan_is_quantized_as_zero_and_inf_clips():
    x = torch.tensor([np.nan, 0.0, np.inf, -np.inf] * 4, dtype=torch.float32)
    for fn, lo, hi in ((td.dither_i16_reference, -32768, 32767),
                       (td.ulaw_u8_reference, 0, 255)):
        codes = fn(x, 9).numpy().astype(np.int64)
        zero_codes = fn(torch.zeros(16), 9).numpy().astype(np.int64)
        np.testing.assert_array_equal(codes[0::4], zero_codes[0::4])
        assert (codes[2::4] == hi).all() and (codes[3::4] == lo).all()


def test_dither_statistics():
    rng = np.random.default_rng(4)
    x = rng.uniform(-0.99, 0.99, 400_000).astype(np.float32)
    q = td.dither_to_i16(x, 5).astype(np.int64)
    scaled = x.astype(np.float64) * 32767.0
    base = np.floor(x * np.float32(32767.0)).astype(np.int64)
    assert np.all((q == base) | (q == base + 1))
    # stochastic rounding is unbiased: E[q] = scaled
    frac = scaled - np.floor(scaled)
    sigma = np.sqrt(np.sum(frac * (1.0 - frac))) / x.size
    assert abs(np.mean(q - scaled)) < 3.0 * sigma


def test_ulaw_roundtrip_snr_and_range():
    rng = np.random.default_rng(3)
    x = np.clip(rng.standard_normal((2, 8192)) * 0.3, -1, 1).astype(np.float32)
    codes = td.ulaw_encode_u8(x)
    assert codes.dtype == np.uint8
    y = td.ulaw_decode_u8(codes)
    snr = 10 * np.log10(np.mean(x ** 2) / np.mean((y - x) ** 2))
    assert snr > 30.0, snr
    ramp = np.linspace(-1, 1, 4097, dtype=np.float32)[None]
    c = td.ulaw_encode_u8(ramp).astype(np.int32)[0]
    assert c.min() >= 0 and c.max() <= 255 and np.all(np.diff(c) >= -1)


def test_ulaw_decode_equals_jax():
    codes = np.arange(256, dtype=np.uint8).reshape(2, 128)
    np.testing.assert_array_equal(td.ulaw_decode_u8(codes),
                                  jdither.ulaw_decode_u8(codes))


def test_seeds_and_return_kinds():
    x = _signal(4099, seed=6)
    a = td.dither_to_i16(x, 1)
    assert isinstance(a, np.ndarray) and a.dtype == np.int16
    np.testing.assert_array_equal(a, td.dither_to_i16(x, 1))
    assert np.any(a != td.dither_to_i16(x, 2))
    t = td.dither_to_i16(torch.from_numpy(x), 1)
    assert isinstance(t, torch.Tensor) and t.dtype == torch.int16
    np.testing.assert_array_equal(t.numpy(), a)
    u = td.ulaw_encode_u8(torch.from_numpy(x), 1)
    assert u.dtype == torch.uint8
    np.testing.assert_array_equal(u.numpy(), td.ulaw_encode_u8(x, 1))


@pytest.mark.parametrize("fn,dtype", [(td.dither_i16, torch.int16),
                                      (td.ulaw_u8, torch.uint8)])
def test_wrappers_refuse_an_output_off_the_input_device(fn, dtype):
    x = torch.zeros(8)
    out = torch.empty(8, dtype=dtype)
    assert fn(x, 0, out=out) is out
    with pytest.raises(KernelError):
        fn(x, 0, out=torch.empty(8, dtype=dtype, device="meta"))


def test_write_wav_dither_is_header_plus_codes():
    x = _signal(2 * 3000, seed=7, lo=-0.9, hi=0.9).reshape(2, 3000)
    blob = twav.write_wav(None, x, 48000.0, bits=16, dither=True)
    codes = td.dither_to_i16(x)
    # the JAX writer's header for the same format and length
    header = jwav.write_wav(None, x, 48000.0, bits=16)[:44]
    assert blob[:44] == header
    assert blob[44:] == np.asarray(codes, "<i2").T.reshape(-1).tobytes()
    buf = io.BytesIO()
    twav.write_wav(buf, torch.from_numpy(x), 48000.0, bits=16, dither=True)
    assert buf.getvalue() == blob
    # float32 and plain 16-bit writes are byte-identical to JAX's
    for bits in (16, 32):
        assert twav.write_wav(None, x, 48000.0, bits=bits) == \
            jwav.write_wav(None, x, 48000.0, bits=bits)


def test_write_wav_dithers_a_1d_tensor_as_one_channel():
    x = _signal(3001, seed=8, lo=-0.9, hi=0.9)
    blob = twav.write_wav(None, torch.from_numpy(x), 48000.0, bits=16,
                          dither=True)
    assert blob == twav.write_wav(None, x[None], 48000.0, bits=16, dither=True)
    assert blob[44:] == td.dither_to_i16(x[None]).tobytes()
