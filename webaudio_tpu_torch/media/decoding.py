"""Host-side media decoding -> AudioBuffer.

reference: src/decoding.rs (symphonia probe over wav/mp3/ogg/flac/aac/...).
This build decodes WAV and AIFF (numpy, plus the optional C++ wahost
fast path) and FLAC (native wahost decoder, wahost.cpp:wah_flac_decode)
natively; every other container/codec (mp3, ogg-vorbis, aac/m4a, alac,
webm-opus, caf, ...) routes through the native codec host
(wacodec.cpp over the system FFmpeg libraries — the C++ analog of the
reference's symphonia probe).  Decode is host-side: the samples stay
host numpy in the AudioBuffer until a source's kernel stages them on the
context's device; on a machine without libavformat the compressed formats
raise NotSupportedError.  Ported from `webaudio_tpu/media/decoding.py`;
the native libraries are this package's own copies (native/).
"""

from __future__ import annotations

import struct

import numpy as np

from ..buffer import AudioBuffer
from ..constants import NotSupportedError
from . import wav as wav_codec

_MAGIC = {
    b"ID3": "mp3", b"\xff\xfb": "mp3", b"\xff\xf3": "mp3", b"\xff\xf2": "mp3",
    b"OggS": "ogg", b"fLaC": "flac", b"\x00\x00\x00 ftyp": "m4a",
    b"\x1a\x45\xdf\xa3": "webm",
}


def _sniff(data: bytes) -> str:
    if data[:4] == b"RIFF" and data[8:12] == b"WAVE":
        return "wav"
    if data[:4] == b"FORM" and data[8:12] in (b"AIFF", b"AIFC"):
        return "aiff"
    for magic, name in _MAGIC.items():
        if data[: len(magic)] == magic:
            return name
    if data[4:8] == b"ftyp":
        return "m4a"
    return "unknown"


class MediaDecoder:
    """Streaming chunk decoder: iterate AudioBuffer chunks off any
    (possibly unseekable) encoded source with memory bounded by the chunk
    size — the analog of the reference's `MediaDecoder` packet iterator
    over a `MediaInput` Read adapter (reference: src/decoding.rs:60-92,
    97+).

    Prefers the native codec host's incremental pull-decoder
    (`CodecStream` over libavformat); when that is unavailable the source
    decodes whole-file and is re-chunked (functional, not bounded —
    documented degradation)."""

    def __init__(self, source, chunk_frames: int = 8192):
        import io

        self.chunk_frames = int(chunk_frames)
        self._owns_file = False
        if hasattr(source, "read"):
            f = source
        elif isinstance(source, str) or hasattr(source, "__fspath__"):
            f = open(source, "rb")
            self._owns_file = True
        else:
            f = io.BytesIO(bytes(source))
        self._f = f
        self._stream = None
        self._whole = None
        start_pos = None
        if hasattr(f, "tell") and getattr(f, "seekable", lambda: False)():
            try:
                start_pos = f.tell()
            except OSError:
                start_pos = None
        try:
            from ..native import codec_open_stream

            self._stream = codec_open_stream(f)
        except Exception:
            self._stream = None
        if self._stream is None and start_pos is not None:
            # codec_open_stream's container probe consumed bytes through the
            # read callback before failing; rewind so the whole-file
            # fallback doesn't decode from a mid-stream position
            try:
                f.seek(start_pos)
            except OSError:
                pass
        if self._stream is not None:
            self.sample_rate = float(self._stream.rate)
            self.number_of_channels = int(self._stream.channels)
        else:
            # fallback: whole-file decode, then chunk
            buf = decode_audio_data(f.read())
            if self._owns_file:
                f.close()
            self._whole = buf
            self.sample_rate = float(buf.sample_rate)
            self.number_of_channels = buf.number_of_channels

    def __iter__(self):
        if self._stream is not None:
            while True:
                chunk = self._stream.read(self.chunk_frames)
                if chunk is None:
                    break
                yield AudioBuffer.from_array(chunk, self.sample_rate)
            self.close()
            return
        data = self._whole.to_array()
        for i in range(0, data.shape[1], self.chunk_frames):
            yield AudioBuffer.from_array(
                np.ascontiguousarray(data[:, i:i + self.chunk_frames]),
                self.sample_rate)

    def close(self):
        if self._stream is not None:
            self._stream.close()
            self._stream = None
        if self._owns_file:
            try:
                self._f.close()
            except Exception:
                pass


def _decode_via_stream(source) -> AudioBuffer | None:
    """Incremental decode of a path / file-like through the codec host:
    the input is never slurped into memory first (the container is read
    chunk-by-chunk as packets are needed).  Returns None when the host
    cannot stream this source (caller falls back to in-memory decode)."""
    close_after = False
    if hasattr(source, "read"):
        f = source
    elif isinstance(source, str) or hasattr(source, "__fspath__"):
        f = open(source, "rb")
        close_after = True
    else:
        return None
    try:
        from ..native import codec_open_stream

        st = codec_open_stream(f)
    except Exception:
        st = None
    if st is None:
        if close_after:
            f.close()
            return None
        # file-like already partially consumed? codec_open_stream only
        # fails before reading in that path (host unavailable), so the
        # stream is still positioned at the start
        return None
    try:
        chunks = []
        while True:
            c = st.read(1 << 16)
            if c is None:
                break
            chunks.append(c)
        if not chunks:
            raise NotSupportedError("stream contains no audio frames")
        arr = np.concatenate(chunks, axis=1)
        return AudioBuffer.from_array(arr, st.rate)
    finally:
        st.close()
        if close_after:
            f.close()


def decode_audio_data(source) -> AudioBuffer:
    """Decode an encoded stream (path / bytes / file-like) to an AudioBuffer
    at the *media's* sample rate; callers resample to the context rate
    (reference: context/base.rs:68-103).

    Paths and file-like sources whose container the native codec host
    recognizes decode incrementally (the input is streamed, not slurped);
    in-memory bytes and fallback formats use the validated whole-buffer
    paths (native WAV/AIFF/FLAC decoders first)."""
    if hasattr(source, "read"):
        head = source.read(16)
        kind = _sniff(head)
        if kind in ("wav", "aiff", "flac"):
            # keep the whole-buffer native decoders for these
            data = head + source.read()
        else:
            try:
                if getattr(source, "seekable", lambda: False)():
                    source.seek(-len(head), 1)
                    buf = _decode_via_stream(source)
                    if buf is not None:
                        return buf
                    source.seek(0)
                    data = source.read()
                else:
                    data = head + source.read()
            except NotSupportedError:
                raise
            except Exception:
                source.seek(0)
                data = source.read()
    elif isinstance(source, str):
        with open(source, "rb") as f:
            head = f.read(16)
        kind = _sniff(head)
        if kind not in ("wav", "aiff", "flac"):
            try:
                buf = _decode_via_stream(source)
                if buf is not None:
                    return buf
            except NotSupportedError:
                raise
            except Exception:
                pass  # stream path failed: retry via the in-memory path
        with open(source, "rb") as f:
            data = f.read()
    else:
        data = bytes(source)

    kind = _sniff(data)
    if kind == "wav":
        arr, rate = wav_codec.read_wav(data)
        if arr.shape[1] == 0:
            raise NotSupportedError("WAV stream contains no audio frames")
        return AudioBuffer.from_array(arr, rate)
    if kind == "flac":
        from ..native import flac_decode_native
        res = flac_decode_native(data)
        if res is None:
            raise NotSupportedError(
                "FLAC decode failed (corrupt stream or native wahost "
                "library unavailable)")
        arr, rate = res
        if arr.shape[1] == 0:
            raise NotSupportedError("FLAC stream contains no audio frames")
        return AudioBuffer.from_array(arr, rate)
    if kind == "aiff":
        arr, rate = _read_aiff(data)
        return AudioBuffer.from_array(arr, rate)
    # compressed codecs (mp3, ogg/vorbis, aac/m4a, alac, webm/opus, ...)
    # go through the native codec host (wacodec.cpp over the system FFmpeg
    # libraries) — the C++ equivalent of the reference's symphonia probe
    # (reference: src/decoding.rs:15-54)
    from ..native import codec_decode_native
    try:
        res = codec_decode_native(data)
    except ValueError as e:
        raise NotSupportedError(f"decoding '{kind}' stream failed: {e}")
    if res is None:
        raise NotSupportedError(
            f"decoding '{kind}' streams requires the native codec host "
            f"(libwacodec.so over libavformat), which is unavailable here; "
            f"always supported: WAV (PCM/float/G.711/ADPCM), AIFF, FLAC")
    arr, rate = res
    if arr.shape[1] == 0:
        raise NotSupportedError(f"'{kind}' stream contains no audio frames")
    return AudioBuffer.from_array(arr, rate)


def _read_aiff(data: bytes) -> tuple[np.ndarray, float]:
    """Minimal AIFF (big-endian PCM) parser."""
    pos = 12
    comm = ssnd = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = struct.unpack_from(">I", data, pos + 4)[0]
        body = data[pos + 8: pos + 8 + size]
        if cid == b"COMM":
            comm = body
        elif cid == b"SSND":
            ssnd = body
        pos += 8 + size + (size & 1)
    if comm is None or ssnd is None:
        raise NotSupportedError("missing COMM/SSND chunk")
    channels, _frames, bits = struct.unpack_from(">HIH", comm, 0)
    # 80-bit extended float sample rate
    exp = struct.unpack_from(">H", comm, 8)[0]
    mant = struct.unpack_from(">Q", comm, 10)[0]
    sample_rate = mant * 2.0 ** (exp - 16383 - 63) if mant else 0.0
    offset = struct.unpack_from(">I", ssnd, 0)[0]
    payload = ssnd[8 + offset:]
    if bits == 16:
        x = np.frombuffer(payload, dtype=">i2").astype(np.float32) / 32768.0
    elif bits == 8:
        x = np.frombuffer(payload, dtype=np.int8).astype(np.float32) / 128.0
    elif bits == 24:
        raw = np.frombuffer(payload, dtype=np.uint8)
        raw = raw[: len(raw) // 3 * 3].reshape(-1, 3)
        x = ((raw[:, 0].astype(np.int32) << 16)
             | (raw[:, 1].astype(np.int32) << 8) | raw[:, 2].astype(np.int32))
        x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / float(1 << 23)
    elif bits == 32:
        x = np.frombuffer(payload, dtype=">i4").astype(np.float32) / 2147483648.0
    else:
        raise NotSupportedError(f"unsupported AIFF bit depth {bits}")
    n = len(x) // channels * channels
    return x[:n].reshape(-1, channels).T.copy(), float(sample_rate)
