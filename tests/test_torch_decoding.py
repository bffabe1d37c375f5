"""Decoding on the port (webaudio_tpu_torch) against the JAX package, on
the CPU: the same bytes through both packages' `decode_audio_data` give
bit-equal samples at the same rate, for every WAV encoding that
tests/test_native.py builds (PCM 8/16/24/32, float 32/64, G.711 mu-law
and A-law, IMA ADPCM, the extensible header), AIFF at 8/16/24/32 bits and
FLAC over every subframe type of tests/flac_ref.py; a context's
`decode_audio_data_sync` (resampled to its rate) is bit-equal too;
corrupt, empty and garbage streams raise the same exception types;
MediaDecoder chunks equal the whole decode; the FFmpeg codec host
(native/wacodec.cpp, where it builds) equals the JAX package's on a CAF
stream written here.

Also the port-side copies of the decode tests that read the absent
reference sample files (tests/test_native.py::
test_decode_samples_via_native, the three decoder tests of
tests/test_streaming_media.py, tests/test_async_api.py::
test_decode_audio_data_future_matches_sync), on WAV and FLAC files that
the port's `write_wav` and tests/flac_ref.py write, each held to the JAX
package on the same file.  The native libraries build from
webaudio_tpu_torch/native/ into webaudio_tpu_torch/build/.
"""

import io
import os
import struct

import numpy as np
import pytest

import webaudio_tpu as wa
import webaudio_tpu_torch as wt
from flac_ref import encode_flac
from webaudio_tpu.media import decoding as jdec
from webaudio_tpu_torch import native as tnative
from webaudio_tpu_torch.media import decoding as tdec
from webaudio_tpu_torch.media.wav import read_wav, write_wav


@pytest.fixture
def codec():
    """The port's FFmpeg codec host, or a skip where it does not build."""
    lib = tnative.get_codec_lib()
    if lib is None or not hasattr(lib, "wac_open"):
        pytest.skip("the native codec host does not build here (no FFmpeg "
                    f"headers or libraries): {tnative.builds.get('wacodec')}")
    return lib


def _riff(fmt: bytes, payload: bytes) -> bytes:
    return (b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(payload))
            + b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", len(payload)) + payload)


def _pcm_wav(codes: np.ndarray, tag: int, bits: int, rate=44100,
             extensible=False) -> bytes:
    """(channels, frames) codes, interleaved little-endian."""
    ch = codes.shape[0]
    inter = codes.T.reshape(-1)
    if bits == 24:
        v = inter.astype(np.int64) & 0xFFFFFF
        payload = np.stack([v & 0xFF, (v >> 8) & 0xFF, v >> 16],
                           axis=-1).astype(np.uint8).tobytes()
    else:
        payload = inter.tobytes()
    align = ch * bits // 8
    if extensible:
        fmt = struct.pack("<HHIIHHHHI", 0xFFFE, ch, rate, rate * align, align,
                          bits, 22, bits, 0) + struct.pack("<H", tag) + \
            b"\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71"
    else:
        fmt = struct.pack("<HHIIHH", tag, ch, rate, rate * align, align, bits)
    return _riff(fmt, payload)


def _adpcm_wav(seed=3, ch=2, block_align=256, nblocks=5) -> bytes:
    """tests/test_native.py::test_wav_ima_adpcm's stream."""
    rng = np.random.RandomState(seed)
    payload = rng.randint(0, 256, nblocks * block_align).astype(np.uint8)
    for b in range(nblocks):
        for c in range(ch):
            payload[b * block_align + 4 * c + 2] %= 89
    fmt = struct.pack("<HHIIHHH", 0x11, ch, 8000, 8000, block_align, 4, 0)
    return _riff(fmt, payload.tobytes())


def _wav_cases():
    rng = np.random.RandomState(11)
    x = np.clip(rng.randn(2, 3001) * 0.4, -1, 1).astype(np.float32)
    cases = {
        "f32": write_wav(None, x, 48000.0),
        "i16 (write_wav)": write_wav(None, x, 44100.0, bits=16),
        "u8": _pcm_wav(rng.randint(0, 256, (2, 777)).astype(np.uint8), 1, 8),
        "i16": _pcm_wav(rng.randint(-32768, 32768, (1, 999)).astype("<i2"),
                        1, 16, rate=22050),
        "i24": _pcm_wav(rng.randint(-(1 << 23), 1 << 23, (2, 555)), 1, 24,
                        rate=96000),
        "i32": _pcm_wav(rng.randint(-(1 << 31), (1 << 31) - 1, (3, 333),
                                    dtype=np.int64).astype("<i4"), 1, 32),
        "f64": _pcm_wav((rng.randn(2, 400) * 0.5).astype("<f8"), 3, 64,
                        rate=32000),
        "i16 extensible": _pcm_wav(
            rng.randint(-32768, 32768, (2, 640)).astype("<i2"), 1, 16,
            extensible=True),
        "mu-law": _pcm_wav(np.arange(256, dtype=np.uint8)[None], 7, 8,
                           rate=8000),
        "a-law": _pcm_wav(np.arange(256, dtype=np.uint8)[None].repeat(2, 0),
                          6, 8, rate=8000),
        "ima adpcm": _adpcm_wav(),
    }
    return cases


WAV_CASES = _wav_cases()


def _ext80(rate: float) -> bytes:
    """An AIFF COMM sample rate as an 80-bit IEEE extended float."""
    m, e = np.frexp(rate)
    mant = int(m * (1 << 64))
    return struct.pack(">HQ", 16383 + int(e) - 1, mant)


def _aiff(codes: np.ndarray, bits: int, rate: float) -> bytes:
    ch, n = codes.shape
    inter = codes.T.reshape(-1)
    if bits == 24:
        v = inter.astype(np.int64) & 0xFFFFFF
        payload = np.stack([v >> 16, (v >> 8) & 0xFF, v & 0xFF],
                           axis=-1).astype(np.uint8).tobytes()
    else:
        payload = inter.astype({8: ">i1", 16: ">i2", 32: ">i4"}[bits]).tobytes()
    comm = struct.pack(">HIH", ch, n, bits) + _ext80(rate)
    ssnd = struct.pack(">II", 0, 0) + payload
    body = (b"AIFF" + b"COMM" + struct.pack(">I", len(comm)) + comm
            + b"SSND" + struct.pack(">I", len(ssnd)) + ssnd)
    return b"FORM" + struct.pack(">I", len(body)) + body


def _aiff_cases():
    rng = np.random.RandomState(12)
    return {
        f"aiff {bits}": _aiff(rng.randint(-(1 << (bits - 1)),
                                          (1 << (bits - 1)) - 1, (2, 500),
                                          dtype=np.int64), bits, rate)
        for bits, rate in ((8, 8000.0), (16, 44100.0), (24, 48000.0),
                           (32, 22050.0))}


AIFF_CASES = _aiff_cases()


def _flac_cases():
    """tests/test_native.py::test_flac_decode_all_subframe_types' streams:
    constant, verbatim, fixed 0-4 and LPC subframes, rice / rice2 and
    escape partitions, wasted bits, every stereo decorrelation, 24 bits."""
    rng = np.random.RandomState(7)
    total = 256 * 5 + 250
    s = rng.randint(-2000, 2000, total).astype(np.int64)
    s[256:512] = 123
    s[1024:1280] = (s[1024:1280] // 8) * 8
    mono = encode_flac(s[None], 44100, 16, [
        (256, "independent", [dict(kind="verbatim")]),
        (256, "independent", [dict(kind="constant")]),
        (256, "independent", [dict(kind="fixed", order=0, porder=1, ks=[12])]),
        (256, "independent", [dict(kind="fixed", order=2, porder=2,
                                   ks=[3, 9, "escape:18", 5])]),
        (256, "independent", [dict(kind="fixed", order=4, wasted=3,
                                   ks=[11], method=1)]),
        (250, "independent", [dict(kind="lpc", order=8,
                                   coefs=[500, -200, 80, 60, -40, 20, 10, -5],
                                   prec=12, shift=9, porder=0, ks=[13])]),
    ])
    st = rng.randint(-3000, 3000, (2, 1024)).astype(np.int64)
    stereo = encode_flac(st, 48000, 16, [
        (256, "left_side", [dict(kind="verbatim"),
                            dict(kind="fixed", order=1, ks=[6])]),
        (256, "right_side", [dict(kind="fixed", order=3, ks=[7]),
                             dict(kind="verbatim")]),
        (256, "mid_side", [dict(kind="lpc", order=2, coefs=[900, -300],
                                prec=11, shift=9, ks=[8], method=1),
                           dict(kind="fixed", order=2, porder=1, ks=[6])]),
        (256, "independent", [dict(kind="verbatim"), dict(kind="verbatim")]),
    ])
    s24 = rng.randint(-(1 << 22), 1 << 22, 512).astype(np.int64)
    b24 = encode_flac(s24[None], 96000, 24, [
        (512, "independent", [dict(kind="fixed", order=2, porder=2,
                                   ks=[14])])])
    return {"flac mono": mono, "flac stereo": stereo, "flac 24": b24}


FLAC_CASES = _flac_cases()
ALL_CASES = {**WAV_CASES, **AIFF_CASES, **FLAC_CASES}


def _same_buffer(got, want):
    assert got.sample_rate == want.sample_rate
    assert got.number_of_channels == want.number_of_channels
    np.testing.assert_array_equal(got.to_array(), want.to_array())


@pytest.mark.parametrize("name", sorted(ALL_CASES))
def test_decode_bit_equal_to_jax(name):
    data = ALL_CASES[name]
    want = jdec.decode_audio_data(data)
    _same_buffer(tdec.decode_audio_data(data), want)
    # a file-like source reads the same bytes
    _same_buffer(tdec.decode_audio_data(io.BytesIO(data)), want)


@pytest.mark.parametrize("name", ["i24", "ima adpcm", "aiff 16",
                                  "flac stereo"])
def test_decode_from_path(tmp_path, name):
    path = str(tmp_path / "clip.bin")
    with open(path, "wb") as f:
        f.write(ALL_CASES[name])
    _same_buffer(tdec.decode_audio_data(path), jdec.decode_audio_data(path))


def test_read_wav_equals_jax_numpy_path():
    """G.711 and ADPCM take read_wav's numpy path in both packages (the
    native decoder refuses them); its tables are the JAX package's."""
    from webaudio_tpu.media.wav import read_wav as jread

    for name in ("mu-law", "a-law", "ima adpcm"):
        got, rate = read_wav(WAV_CASES[name])
        want, wrate = jread(WAV_CASES[name])
        assert rate == wrate
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["f32", "i16", "u8", "aiff 24",
                                  "flac stereo", "flac 24", "mu-law"])
def test_decode_sync_into_context_bit_equal(name):
    data = ALL_CASES[name]
    got = wt.OfflineAudioContext(2, 16, 48000.0, device="cpu") \
        .decode_audio_data_sync(data)
    want = wa.OfflineAudioContext(2, 16, 48000.0).decode_audio_data_sync(data)
    assert got.sample_rate == 48000.0
    _same_buffer(got, want)


BAD_STREAMS = {
    "empty": b"",
    "garbage": bytes(np.random.RandomState(5).randint(0, 256, 300)
                     .astype(np.uint8)),
    "corrupt flac": b"fLaC" + b"\x00" * 64,
    "riff without data": b"RIFF" + struct.pack("<I", 4) + b"WAVE",
    "wav without frames": write_wav(None, np.zeros((2, 0), np.float32),
                                    8000.0),
    "aiff without ssnd": b"FORM" + struct.pack(">I", 4) + b"AIFF",
    "wav format 0x55": _riff(struct.pack("<HHIIHH", 0x55, 1, 8000, 8000, 1,
                                         8), b"\x00" * 10),
}


@pytest.mark.parametrize("name", sorted(BAD_STREAMS))
def test_bad_streams_raise_the_same_types(name):
    data = BAD_STREAMS[name]
    raised = []
    for decode in (jdec.decode_audio_data, tdec.decode_audio_data):
        with pytest.raises(Exception) as info:
            decode(data)
        raised.append(type(info.value).__name__)
    assert raised[0] == raised[1], raised


def test_native_libraries_build_into_the_port(codec):
    lib = tnative.get_lib()
    assert lib is not None, tnative.builds.get("wahost")
    build = os.path.join(os.path.dirname(tnative.__file__), os.pardir, "build")
    for name in ("wahost", "wacodec"):
        path, _ = tnative.builds[name]
        assert os.path.samefile(os.path.dirname(path), build)


@pytest.mark.parametrize("name", ["f32", "i16 (write_wav)", "u8"])
def test_media_decoder_chunks_match_whole(tmp_path, name):
    """Port copy of tests/test_streaming_media.py::
    test_media_decoder_chunks_match_whole on files written here: the
    chunks (through the codec host where it builds, else the whole-file
    fallback) equal the whole decode and JAX's MediaDecoder's chunks."""
    path = str(tmp_path / "clip.bin")
    with open(path, "wb") as f:
        f.write(ALL_CASES[name])
    whole = tdec.decode_audio_data(path).to_array()
    got = [b.to_array() for b in tdec.MediaDecoder(path, chunk_frames=500)]
    assert all(c.shape[1] <= 500 for c in got)
    np.testing.assert_array_equal(np.concatenate(got, axis=1), whole)
    want = [b.to_array() for b in jdec.MediaDecoder(path, chunk_frames=500)]
    np.testing.assert_array_equal(np.concatenate(got, axis=1),
                                  np.concatenate(want, axis=1))


class _ForwardOnly(io.RawIOBase):
    def __init__(self, data):
        self._d = data
        self._p = 0

    def readable(self):
        return True

    def seekable(self):
        return False

    def read(self, n=-1):
        if n is None or n < 0:
            n = len(self._d) - self._p
        out = self._d[self._p:self._p + n]
        self._p += len(out)
        return out


def test_media_decoder_unseekable_stream(codec):
    """Port copy of test_streaming_media.py::
    test_media_decoder_unseekable_stream on a WAV stream."""
    data = WAV_CASES["i16 (write_wav)"]
    whole = tdec.decode_audio_data(data).to_array()
    got = np.concatenate([b.to_array() for b in tdec.MediaDecoder(
        _ForwardOnly(data), chunk_frames=300)], axis=1)
    np.testing.assert_array_equal(got, whole)
    want = np.concatenate([b.to_array() for b in jdec.MediaDecoder(
        _ForwardOnly(data), chunk_frames=300)], axis=1)
    np.testing.assert_array_equal(got, want)


def _caf(fs=22050.0, n=4000):
    """tests/test_streaming_media.py::test_caf_container_decodes' stream:
    s16 big-endian LPCM in a Core Audio Format container, which only the
    codec host decodes."""
    t = np.arange(n)
    sig = np.stack([np.sin(2 * np.pi * 440.0 * t / fs),
                    np.sin(2 * np.pi * 660.0 * t / fs)]) * 0.4
    codes = np.round(sig * 32767.0).astype(">i2")
    desc = struct.pack(">d4sIIIII", fs, b"lpcm", 0, 4, 1, 2, 16)
    data = struct.pack(">I", 0) + codes.T.reshape(-1).tobytes()
    return (b"caff" + struct.pack(">HH", 1, 0)
            + b"desc" + struct.pack(">q", len(desc)) + desc
            + b"data" + struct.pack(">q", len(data)) + data), sig


def test_decode_audio_data_streams_path_without_slurp(tmp_path, codec):
    """Port copy of test_streaming_media.py::
    test_decode_audio_data_streams_path_without_slurp on a CAF file: the
    path goes through the codec host's incremental decode and equals the
    in-memory decode, and JAX's decode of the same file."""
    blob, sig = _caf()
    path = str(tmp_path / "t.caf")
    with open(path, "wb") as f:
        f.write(blob)
    via_path = tdec.decode_audio_data(path)
    via_bytes = tdec.decode_audio_data(blob)
    _same_buffer(via_path, via_bytes)
    _same_buffer(via_path, jdec.decode_audio_data(path))
    np.testing.assert_allclose(via_path.to_array()[:, :sig.shape[1]], sig,
                               atol=2e-4)


def test_ffmpeg_path_equals_jax(tmp_path, codec):
    """The codec host (FFmpeg) decodes WAV files through MediaDecoder and
    the CAF stream from memory as the JAX package's does, bit for bit.
    (FFmpeg's FLAC demuxer finds no frames in tests/flac_ref.py's streams,
    in both packages; wahost.cpp decodes them.)"""
    blob, _ = _caf()
    _same_buffer(tdec.decode_audio_data(blob), jdec.decode_audio_data(blob))
    for name in ("i16 (write_wav)", "u8", "f32"):
        path = str(tmp_path / f"{name}.bin")
        with open(path, "wb") as f:
            f.write(ALL_CASES[name])
        md = tdec.MediaDecoder(path, chunk_frames=256)
        assert md._stream is not None       # the codec host's stream
        got = np.concatenate([b.to_array() for b in md], axis=1)
        want = np.concatenate([b.to_array() for b in jdec.MediaDecoder(
            path, chunk_frames=256)], axis=1)
        assert got.shape[1] > 0
        np.testing.assert_array_equal(got, want)


def _written_wav(tmp_path, n=142187, fs=44100.0, bits=16):
    """A stereo clip written by the port's write_wav, standing in for the
    reference's samples/sample.wav (2 channels, 142,187 frames)."""
    t = np.arange(n)
    sig = np.stack([0.6 * np.sin(t * 0.021), 0.5 * np.cos(t * 0.013)])
    path = str(tmp_path / "sample.wav")
    write_wav(path, sig.astype(np.float32), fs, bits=bits)
    return path, n


def test_decode_samples_via_native(tmp_path):
    """Port copy of tests/test_native.py::test_decode_samples_via_native."""
    path, n = _written_wav(tmp_path)
    buf = tdec.decode_audio_data(path)
    assert buf.number_of_channels == 2
    assert buf.length == n == 142187
    _same_buffer(buf, jdec.decode_audio_data(path))


def test_decode_audio_data_future_matches_sync(tmp_path):
    """Port copy of tests/test_async_api.py::
    test_decode_audio_data_future_matches_sync."""
    path, _ = _written_wav(tmp_path)
    ctx = wt.OfflineAudioContext(2, 16, 48000.0, device="cpu")
    fut = ctx.decode_audio_data(path)
    sync = ctx.decode_audio_data_sync(path)
    buf = fut.result(timeout=60)
    assert buf.length == sync.length
    assert buf.sample_rate == sync.sample_rate
    np.testing.assert_array_equal(buf.to_array(), sync.to_array())
    _same_buffer(sync, wa.OfflineAudioContext(2, 16, 48000.0)
                 .decode_audio_data_sync(path))
