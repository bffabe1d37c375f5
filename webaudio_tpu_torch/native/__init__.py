"""ctypes bindings for the native host runtime (wahost.cpp, wacodec.cpp).

Copies of `webaudio_tpu/native/`'s two C++ sources sit beside this file.
At first use each builds with `g++` into the git-ignored
`webaudio_tpu_torch/build/` (never next to the source); the library's name
carries a hash of the source and the flags, so an edited source is
rebuilt, and a build lands under a temporary name and is renamed into
place, so processes building at once never load half a file.  Nothing
builds at import time.  The codec host links the system FFmpeg; where its
headers or libraries are absent it does not build and the compressed
formats raise `NotSupportedError` (media/decoding.py).  WAV, AIFF and FLAC
never need FFmpeg; WAV keeps its numpy path when no library builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parent / "build"
_SRC = _HERE / "wahost.cpp"
_HOST_FLAGS = ("-O3", "-shared", "-fPIC")
_CODEC_SRC = _HERE / "wacodec.cpp"
_CODEC_FLAGS = ("-O2", "-shared", "-fPIC")
_CODEC_LIBS = ("-lavformat", "-lavcodec", "-lavutil", "-lswresample")

_lock = threading.Lock()
_lib = None
_unavailable = False
# library name -> (path, build seconds or 0.0 when it was already built,
# or the compiler's error)
builds: dict[str, tuple] = {}


def _build(src: Path, flags, libs=(), timeout=180) -> Path | None:
    """g++ `src` into BUILD_DIR (once per source and flags); the library's
    path, or None when the compiler fails (its message in `builds`)."""
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(flags + libs).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{src.stem}-{digest}.so"
    if out.exists():
        builds[src.stem] = (str(out), 0.0)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(["g++", *flags, str(src), "-o", str(tmp), *libs],
                              capture_output=True, text=True, timeout=timeout)
    except (OSError, subprocess.TimeoutExpired) as exc:
        builds[src.stem] = (None, str(exc))
        return None
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        builds[src.stem] = (None, proc.stderr[-2000:])
        return None
    os.replace(tmp, out)
    builds[src.stem] = (str(out), time.perf_counter() - t0)
    return out


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _unavailable
    with _lock:
        if _lib is not None or _unavailable:
            return _lib
        path = _build(_SRC, _HOST_FLAGS, timeout=120)
        if path is None:
            _unavailable = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _unavailable = True
            return None

        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.wah_wav_probe.argtypes = [
            u8p, ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_double)]
        lib.wah_wav_probe.restype = ctypes.c_int
        lib.wah_wav_decode.argtypes = [u8p, ctypes.c_uint64, f32p]
        lib.wah_wav_decode.restype = ctypes.c_int
        lib.wah_resample_linear.argtypes = [
            f32p, ctypes.c_uint32, ctypes.c_uint64, f32p, ctypes.c_uint64,
            ctypes.c_double]
        lib.wah_resample_linear.restype = None
        if hasattr(lib, "wah_flac_probe"):
            lib.wah_flac_probe.argtypes = [
                u8p, ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint64)]
            lib.wah_flac_probe.restype = ctypes.c_int
            lib.wah_flac_decode.argtypes = [u8p, ctypes.c_uint64, f32p,
                                            ctypes.c_uint64]
            lib.wah_flac_decode.restype = ctypes.c_int64
        _lib = lib
        return _lib


def wav_decode_native(data: bytes):
    """-> ((channels, frames) f32, sample_rate) or None if unsupported."""
    lib = get_lib()
    if lib is None:
        return None
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    ch = ctypes.c_uint32()
    frames = ctypes.c_uint32()
    rate = ctypes.c_double()
    if lib.wah_wav_probe(buf, len(data), ctypes.byref(ch),
                         ctypes.byref(frames), ctypes.byref(rate)) != 0:
        return None
    out = np.empty((ch.value, frames.value), np.float32)
    rc = lib.wah_wav_decode(
        buf, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        return None
    return out, rate.value


def resample_linear_native(data: np.ndarray, ratio: float,
                           out_frames: int):
    """-> (channels, out_frames) f32 or None."""
    lib = get_lib()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, np.float32)
    out = np.empty((data.shape[0], out_frames), np.float32)
    lib.wah_resample_linear(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        data.shape[0], data.shape[1],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out_frames, ratio)
    return out


def flac_decode_native(data: bytes):
    """-> ((channels, frames) f32, sample_rate) or None if unsupported.

    Native FLAC decode (wahost.cpp wah_flac_decode); the analog of the
    reference's symphonia FLAC path (src/decoding.rs)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "wah_flac_probe"):
        return None
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    ch = ctypes.c_uint32()
    rate = ctypes.c_uint32()
    total = ctypes.c_uint64()
    if lib.wah_flac_probe(buf, len(data), ctypes.byref(ch),
                          ctypes.byref(rate), ctypes.byref(total)) != 0:
        return None
    cap = total.value
    if cap == 0:
        # unknown length: bound by the worst-case bits-per-sample ratio
        cap = max(len(data) * 4, 65536)
    out = np.zeros((ch.value, cap), np.float32)
    n = lib.wah_flac_decode(
        buf, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cap)
    if n < 0:
        return None
    if total.value and n != total.value:
        return None  # truncated / corrupt stream
    return out[:, :n].copy() if n != cap else out, float(rate.value)


_READ_CB = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p,
                            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int)
_SEEK_CB = ctypes.CFUNCTYPE(ctypes.c_int64, ctypes.c_void_p,
                            ctypes.c_int64, ctypes.c_int)
_AVSEEK_SIZE = 0x10000


# --- compressed-codec host (wacodec.cpp over system FFmpeg libs) -----------
# The native analog of the reference's symphonia dependency
# (reference: src/decoding.rs:15-54): mp3, ogg/vorbis, aac/m4a, alac,
# webm/opus and anything else libavformat demuxes.  Built as a separate
# shared object so the core wahost library never depends on libav.

_codec_lib = None
_codec_unavailable = False


def get_codec_lib():
    """Load (building if needed) the codec host, or None if libav is not
    present on this machine."""
    global _codec_lib, _codec_unavailable
    with _lock:
        if _codec_lib is not None or _codec_unavailable:
            return _codec_lib
        path = _build(_CODEC_SRC, _CODEC_FLAGS, _CODEC_LIBS)
        if path is None:
            _codec_unavailable = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _codec_unavailable = True
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_float))
        lib.wac_decode.argtypes = [
            u8p, ctypes.c_uint64, f32pp,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_char_p, ctypes.c_int]
        lib.wac_decode.restype = ctypes.c_int
        lib.wac_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        lib.wac_free.restype = None
        if hasattr(lib, "wac_open"):
            lib.wac_open.argtypes = [
                _READ_CB, _SEEK_CB, ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_char_p, ctypes.c_int]
            lib.wac_open.restype = ctypes.c_void_p
            lib.wac_stream_read.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
                ctypes.c_char_p, ctypes.c_int]
            lib.wac_stream_read.restype = ctypes.c_int64
            lib.wac_stream_seek.argtypes = [
                ctypes.c_void_p, ctypes.c_double,
                ctypes.POINTER(ctypes.c_double), ctypes.c_char_p,
                ctypes.c_int]
            lib.wac_stream_seek.restype = ctypes.c_int
            lib.wac_close.argtypes = [ctypes.c_void_p]
            lib.wac_close.restype = None
        _codec_lib = lib
        return _codec_lib


def codec_decode_native(data: bytes):
    """Decode any libav-supported compressed stream.

    -> ((channels, frames) f32, sample_rate) on success,
       None if the codec host is unavailable,
       or raises ValueError with the decoder's message on a bad stream."""
    lib = get_codec_lib()
    if lib is None:
        return None
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    out = ctypes.POINTER(ctypes.c_float)()
    ch = ctypes.c_uint32()
    rate = ctypes.c_uint32()
    frames = ctypes.c_uint64()
    err = ctypes.create_string_buffer(256)
    rc = lib.wac_decode(buf, len(data), ctypes.byref(out), ctypes.byref(ch),
                        ctypes.byref(rate), ctypes.byref(frames), err, 256)
    if rc != 0:
        raise ValueError(err.value.decode("utf-8", "replace") or
                         f"decode failed (rc={rc})")
    try:
        arr = np.ctypeslib.as_array(
            out, shape=(ch.value, frames.value)).copy()
    finally:
        lib.wac_free(out)
    return arr, float(rate.value)


class CodecStream:
    """Incremental pull-decoder over the native codec host.

    The analog of the reference's `MediaDecoder` chunk iterator over a
    `MediaInput` source (reference: src/decoding.rs:60-92, :97+):
    decodes any libav-supported container from a file-like object
    chunk-by-chunk with memory bounded by the chunk size, forward-only when
    the source is unseekable.  `read(n)` -> (channels, m<=n) f32 (None at
    end of stream); `seek(t)` -> actual landing time (container sync point;
    callers discard forward for sample accuracy)."""

    def __init__(self, fileobj, seekable: bool | None = None):
        lib = get_codec_lib()
        if lib is None or not hasattr(lib, "wac_open"):
            raise RuntimeError("native codec host unavailable")
        self._lib = lib
        self._f = fileobj
        if seekable is None:
            seekable = bool(getattr(fileobj, "seekable", lambda: False)())
        self.seekable = seekable
        self._size = None
        if seekable:
            cur = fileobj.tell()
            self._size = fileobj.seek(0, 2)
            fileobj.seek(cur)

        def _read(_opaque, buf, n):
            try:
                data = self._f.read(n)
                if not data:
                    return -1
                ctypes.memmove(buf, data, len(data))
                return len(data)
            except Exception:
                return -1

        def _seek(_opaque, offset, whence):
            try:
                if whence == _AVSEEK_SIZE:
                    return -1 if self._size is None else self._size
                self._f.seek(offset, whence)
                return self._f.tell()
            except Exception:
                return -1

        # keep callback objects alive for the handle's lifetime
        self._read_cb = _READ_CB(_read)
        self._seek_cb = _SEEK_CB(_seek) if seekable else \
            ctypes.cast(None, _SEEK_CB)
        ch = ctypes.c_uint32()
        rate = ctypes.c_uint32()
        dur = ctypes.c_double()
        err = ctypes.create_string_buffer(256)
        self._h = lib.wac_open(self._read_cb, self._seek_cb, None,
                               ctypes.byref(ch), ctypes.byref(rate),
                               ctypes.byref(dur), err, 256)
        if not self._h:
            raise ValueError(err.value.decode("utf-8", "replace")
                             or "open failed")
        self.channels = ch.value
        self.rate = float(rate.value)
        self.duration = dur.value if dur.value >= 0 else None

    def read(self, max_frames: int):
        """-> (channels, n<=max_frames) f32, or None at end of stream."""
        if self._h is None:
            return None
        out = np.empty((self.channels, int(max_frames)), np.float32)
        pos = ctypes.c_int64()
        err = ctypes.create_string_buffer(256)
        n = self._lib.wac_stream_read(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            int(max_frames), ctypes.byref(pos), err, 256)
        if n < 0:
            raise ValueError(err.value.decode("utf-8", "replace")
                             or "decode failed")
        if n == 0:
            return None
        self.position = pos.value + n  # next source frame index
        return out[:, :n]

    def seek(self, seconds: float) -> float:
        """Container-level seek; returns the actual landing time in
        seconds (<= seconds at a sync point)."""
        if not self.seekable:
            raise ValueError("stream is not seekable")
        actual = ctypes.c_double()
        err = ctypes.create_string_buffer(256)
        rc = self._lib.wac_stream_seek(self._h, float(seconds),
                                       ctypes.byref(actual), err, 256)
        if rc != 0:
            raise ValueError(err.value.decode("utf-8", "replace")
                             or "seek failed")
        return actual.value

    def close(self):
        if self._h is not None:
            self._lib.wac_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __iter__(self):
        while True:
            chunk = self.read(8192)
            if chunk is None:
                return
            yield chunk


def codec_open_stream(fileobj, seekable=None):
    """-> CodecStream or None when the codec host is unavailable."""
    lib = get_codec_lib()
    if lib is None or not hasattr(lib, "wac_open"):
        return None
    return CodecStream(fileobj, seekable=seekable)
