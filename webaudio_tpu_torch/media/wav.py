"""WAV (RIFF) codec, host-side.

Ported from `webaudio_tpu/media/wav.py`: the analog of the reference's
symphonia-wav decode path (decoding.rs) and hound-based encode
(media_recorder/mod.rs:40-48).  `read_wav` parses RIFF in numpy: PCM
u8/i16/i24/i32, float32/float64, G.711 mu-law and A-law and IMA ADPCM,
any channel count; the native host runtime (native/wahost.cpp) decodes
PCM and float first when it builds, as in the JAX package, so both give
the same samples.  Decoded audio stays host numpy.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..constants import NotSupportedError


def read_wav(source) -> tuple[np.ndarray, float]:
    """Decode a WAV file/path/bytes -> ((channels, frames) f32, sample_rate)."""
    if isinstance(source, (str, bytes)) and not (
            isinstance(source, bytes) and source[:4] == b"RIFF"):
        with open(source, "rb") as f:
            data = f.read()
    elif isinstance(source, bytes):
        data = source
    elif hasattr(source, "read"):
        data = source.read()
    else:
        raise TypeError(f"cannot read WAV from {type(source)}")

    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise NotSupportedError("not a RIFF/WAVE stream")

    # native fast path (native/wahost.cpp)
    from ..native import wav_decode_native

    native = wav_decode_native(data)
    if native is not None:
        return native

    pos = 12
    fmt = None
    payload = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        body = data[pos + 8: pos + 8 + size]
        if cid == b"fmt ":
            fmt = body
        elif cid == b"data":
            payload = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned

    if fmt is None or payload is None:
        raise NotSupportedError("missing fmt/data chunk")

    (audio_format, channels, sample_rate, _byte_rate, block_align,
     bits) = struct.unpack_from("<HHIIHH", fmt, 0)
    if audio_format == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = struct.unpack_from("<H", fmt, 24)[0]

    frames = len(payload) // block_align if block_align else 0
    payload = payload[: frames * block_align]

    if audio_format == 1:  # integer PCM
        if bits == 8:
            x = np.frombuffer(payload, dtype=np.uint8).astype(np.float32)
            x = (x - 128.0) / 128.0
        elif bits == 16:
            x = np.frombuffer(payload, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            raw = np.frombuffer(payload, dtype=np.uint8).reshape(-1, 3)
            x = (raw[:, 0].astype(np.int32)
                 | (raw[:, 1].astype(np.int32) << 8)
                 | (raw[:, 2].astype(np.int32) << 16))
            x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / float(1 << 23)
        elif bits == 32:
            x = np.frombuffer(payload, dtype="<i4").astype(np.float32) / 2147483648.0
        else:
            raise NotSupportedError(f"unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        if bits == 32:
            x = np.frombuffer(payload, dtype="<f4").astype(np.float32)
        elif bits == 64:
            x = np.frombuffer(payload, dtype="<f8").astype(np.float32)
        else:
            raise NotSupportedError(f"unsupported float bit depth {bits}")
    elif audio_format == 6:  # G.711 A-law
        x = _ALAW_TABLE[np.frombuffer(payload, dtype=np.uint8)]
    elif audio_format == 7:  # G.711 mu-law
        x = _MULAW_TABLE[np.frombuffer(payload, dtype=np.uint8)]
    elif audio_format == 0x11:  # IMA / DVI ADPCM
        out = _decode_ima_adpcm(payload, channels, block_align)
        return out, float(sample_rate)
    else:
        raise NotSupportedError(f"unsupported WAV format tag {audio_format}")

    x = x.reshape(-1, channels).T.copy()  # (channels, frames)
    return x, float(sample_rate)


def _build_g711_tables():
    """G.711 expansion tables (symphonia-adpcm/pcm decode these formats via
    the reference's `all` feature set, Cargo.toml:63-66)."""
    b = np.arange(256, dtype=np.uint32)
    # mu-law
    u = (~b) & 0xFF
    sign = (u & 0x80) != 0
    exp = (u >> 4) & 7
    mant = u & 0xF
    mag = (((mant << 3) + 0x84) << exp) - 0x84
    mu = np.where(sign, -mag.astype(np.int32), mag.astype(np.int32))
    # A-law
    a = b ^ 0x55
    sign = (a & 0x80) != 0
    exp = (a >> 4) & 7
    mant = a & 0xF
    mag = np.where(exp > 0, ((mant << 4) + 0x108) << np.maximum(exp, 1) - 1,
                   (mant << 4) + 8)
    al = np.where(sign, -mag.astype(np.int32), mag.astype(np.int32))
    return (mu.astype(np.float32) / 32768.0), (al.astype(np.float32) / 32768.0)


_MULAW_TABLE, _ALAW_TABLE = _build_g711_tables()

_IMA_STEPS = np.array([
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37,
    41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173,
    190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658,
    724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
    2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894, 6484,
    7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289, 16818,
    18500, 20350, 22385, 24623, 27086, 29794, 32767], np.int32)
_IMA_INDEX = np.array([-1, -1, -1, -1, 2, 4, 6, 8], np.int32)


def _decode_ima_adpcm(payload: bytes, channels: int,
                      block_align: int) -> np.ndarray:
    """IMA/DVI ADPCM (WAV format 0x11): 4-byte per-channel block headers
    (i16 predictor, u8 step index), then nibbles in per-channel 4-byte
    groups.  Decoded vectorized across blocks x channels (the nibble
    recurrence is serial only within a block)."""
    nblocks = len(payload) // block_align
    raw = np.frombuffer(payload, np.uint8)[:nblocks * block_align]
    raw = raw.reshape(nblocks, block_align)
    hdr = raw[:, :4 * channels].reshape(nblocks, channels, 4)
    pred = (hdr[:, :, 0].astype(np.int32)
            | (hdr[:, :, 1].astype(np.int32) << 8))
    pred = np.where(pred >= 1 << 15, pred - (1 << 16), pred)
    index = np.clip(hdr[:, :, 2].astype(np.int32), 0, 88)

    body = raw[:, 4 * channels:]
    groups = body.reshape(nblocks, -1, channels, 4)  # per-channel 4-byte runs
    lo = groups & 0xF
    hi = groups >> 4
    nib = np.stack([lo, hi], axis=-1).reshape(nblocks, groups.shape[1],
                                              channels, 8)
    # (nblocks, channels, samples_per_block-1)
    nib = np.transpose(nib, (0, 2, 1, 3)).reshape(nblocks, channels, -1)
    spb = nib.shape[2] + 1

    out = np.empty((nblocks, channels, spb), np.float32)
    out[:, :, 0] = pred / 32768.0
    for t in range(spb - 1):
        n = nib[:, :, t].astype(np.int32)
        step = _IMA_STEPS[index]
        diff = step >> 3
        diff += np.where(n & 1, step >> 2, 0)
        diff += np.where(n & 2, step >> 1, 0)
        diff += np.where(n & 4, step, 0)
        pred = np.clip(np.where(n & 8, pred - diff, pred + diff),
                       -32768, 32767)
        index = np.clip(index + _IMA_INDEX[n & 7], 0, 88)
        out[:, :, t + 1] = pred / 32768.0
    return np.transpose(out, (1, 0, 2)).reshape(channels, -1).copy()


def write_wav(path_or_file, data, sample_rate: float, bits: int = 32,
              dither: bool = False) -> bytes | None:
    """Encode (channels, frames) audio as WAV: float32 by default, or i16.

    `data` is an array-like or a tensor on any device.  `dither=True`
    quantizes to 16 bits with the port's RPDF dither
    (ops/dither.py::dither_to_i16, the CUDA kernel for a tensor on the
    card); without it the samples are clipped and rounded."""
    if isinstance(data, torch.Tensor):
        data = data.detach()
    else:
        data = np.asarray(data, dtype=np.float32)
    if data.ndim == 1:
        data = data[None, :]
    channels, frames = data.shape

    if bits == 16 and dither:
        from ..ops.dither import dither_to_i16

        # a tensor is quantized on its own device; only the codes come back
        fmt_tag = 1
        codes = dither_to_i16(data)
        if isinstance(codes, torch.Tensor):
            codes = codes.cpu().numpy()
        payload = np.asarray(codes, "<i2").T.reshape(-1).tobytes()
    else:
        if isinstance(data, torch.Tensor):
            data = data.cpu().numpy()
        data = np.asarray(data, dtype=np.float32)
        if bits == 32:
            fmt_tag = 3
            payload = data.T.reshape(-1).astype("<f4").tobytes()
        elif bits == 16:
            fmt_tag = 1
            clipped = np.clip(data.T.reshape(-1), -1.0, 1.0)
            payload = (clipped * 32767.0).round().astype("<i2").tobytes()
        else:
            raise NotSupportedError(f"unsupported write bit depth {bits}")

    block_align = channels * bits // 8
    hdr = b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, fmt_tag, channels,
                                 int(sample_rate),
                                 int(sample_rate) * block_align,
                                 block_align, bits)
    hdr += b"data" + struct.pack("<I", len(payload))
    blob = hdr + payload
    if path_or_file is None:
        return blob
    if hasattr(path_or_file, "write"):
        path_or_file.write(blob)
    else:
        with open(path_or_file, "wb") as f:
            f.write(blob)
    return None
