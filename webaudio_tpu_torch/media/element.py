"""MediaElement: an <audio>-element shim for controllable file playback.

reference: src/media_element.rs (creek real-time-safe disk streaming with
seek / loop / playback-rate / pause via atomics).  Host-side equivalent:
a `CodecStream` pull-decoder over the native codec host streams the file
from disk chunk-by-chunk into a small rolling window, so peak memory is
bounded by the window (a few hundred KB) independent of media length —
an hour-long file no longer costs ~1.3 GB resident.  Controls are live
and thread-safe: the render loop pulls chunks while the user mutates
pause/seek/rate/loop.

Fallback: sources the codec host cannot stream (no libavformat, exotic
in-memory bytes) decode whole-file — same API, larger
footprint.

A copy of `webaudio_tpu/media/element.py`, which is framework-free.
"""

from __future__ import annotations

import math
import os
import threading

import numpy as np

from .decoding import decode_audio_data

# rolling-window pull granularity (source frames per disk/codec read)
_CHUNK = 8192
# when seeking in lossy codecs, land this far before the target so the
# decoder reconverges (mp3 bit-reservoir / ogg priming) before the first
# delivered sample
_SEEK_PREROLL = 0.2


class MediaElement:
    """reference: media_element.rs:12-223."""

    def __init__(self, source, stream: bool = True):
        self._lock = threading.Lock()
        self._position = 0.0          # seconds (element time)
        self._playback_rate = 1.0
        self._loop = False
        self._paused = True

        self._stream = None
        self._file = None
        self._buffer = None
        if stream and isinstance(source, (str, os.PathLike)):
            try:
                from ..native import codec_open_stream

                f = open(source, "rb")
                st = codec_open_stream(f, seekable=True)
                if st is None:
                    f.close()
                else:
                    self._stream = st
                    self._file = f
            except Exception:
                if self._file is not None:
                    self._file.close()
                self._stream = None
                self._file = None
        if self._stream is not None:
            st = self._stream
            self._rate = float(st.rate)
            self._channels = int(st.channels)
            # total source frames: trusted only once EOF is observed; the
            # container duration seeds the public `duration` before that
            self._n_total = None
            self._container_duration = st.duration
            self._eof = False
            self._win = np.zeros((self._channels, 0), np.float32)
            self._win_start = 0       # source frame index of win[:, 0]
        else:
            self._buffer = decode_audio_data(source)
            self._rate = float(self._buffer.sample_rate)
            self._channels = self._buffer.number_of_channels

    # --- introspection ------------------------------------------------------
    @property
    def number_of_channels(self) -> int:
        return self._channels

    @property
    def streaming(self) -> bool:
        """True when playback streams from disk with bounded memory."""
        return self._stream is not None

    @property
    def duration(self) -> float:
        if self._buffer is not None:
            return self._buffer.duration
        with self._lock:
            if self._n_total is not None:
                return self._n_total / self._rate
            if self._container_duration is not None:
                return self._container_duration
            return math.inf

    # --- controls -----------------------------------------------------------
    @property
    def current_time(self) -> float:
        with self._lock:
            return self._position

    @current_time.setter
    def current_time(self, t: float):
        self.set_current_time(t)

    def set_current_time(self, t: float):
        with self._lock:
            t = max(float(t), 0.0)
            if self._buffer is not None:
                self._position = min(t, self._buffer.duration)
                return
            if self._n_total is not None:
                t = min(t, self._n_total / self._rate)
            self._seek_stream_locked(t)
            self._position = t

    @property
    def playback_rate(self) -> float:
        return self._playback_rate

    @playback_rate.setter
    def playback_rate(self, r: float):
        with self._lock:
            # forward-only playback, matching the reference element
            # (media_element.rs playback_rate is a non-negative factor)
            self._playback_rate = max(float(r), 0.0)

    @property
    def loop(self) -> bool:
        return self._loop

    @loop.setter
    def loop(self, v: bool):
        with self._lock:
            self._loop = bool(v)

    @property
    def paused(self) -> bool:
        return self._paused

    def play(self):
        with self._lock:
            self._paused = False

    def pause(self):
        with self._lock:
            self._paused = True

    def close(self):
        """Release the disk stream (no-op in whole-buffer mode)."""
        with self._lock:
            if self._stream is not None:
                self._stream.close()
                self._stream = None
            if self._file is not None:
                self._file.close()
                self._file = None

    # --- streaming window ---------------------------------------------------
    def _seek_stream_locked(self, t: float):
        """Reposition the decode stream so the window can serve frames from
        `t` seconds.  Lands early (container sync point + lossy preroll);
        the extra frames simply sit at the head of the window and are
        skipped by the gather."""
        target = max(t - _SEEK_PREROLL, 0.0)
        try:
            actual = self._stream.seek(target)
        except ValueError:
            # unseekable / seek failure: forward seeks can still be served
            # by reading ahead; backward seeks cannot
            if t * self._rate >= self._win_start:
                return
            raise
        self._win = np.zeros((self._channels, 0), np.float32)
        self._win_start = int(round(actual * self._rate))
        self._eof = False

    def _fill_to_locked(self, end_frame: int):
        """Grow the window until it covers source frame `end_frame`
        (exclusive) or EOF."""
        while not self._eof and \
                self._win_start + self._win.shape[1] < end_frame:
            need = end_frame - (self._win_start + self._win.shape[1])
            chunk = self._stream.read(max(_CHUNK, need))
            if chunk is None:
                self._eof = True
                self._n_total = self._win_start + self._win.shape[1]
                break
            self._win = np.concatenate([self._win, chunk], axis=1)

    def _trim_locked(self, keep_from_frame: int):
        drop = min(max(keep_from_frame - 1, 0) - self._win_start,
                   self._win.shape[1])
        if drop > 0:
            self._win = self._win[:, drop:]
            self._win_start += drop

    # --- chunk production (pulled by MediaElementAudioSourceNode) -----------
    def _pull_chunk(self, frames: int, out_rate: float) -> np.ndarray:
        """Produce `frames` frames at `out_rate` honoring rate/loop/pause
        (linear-interp resampling like the reference's slow track)."""
        if self._buffer is not None:
            return self._pull_chunk_buffer(frames, out_rate)
        c = self._channels
        with self._lock:
            if self._paused or self._stream is None:
                return np.zeros((c, frames), np.float32)
            rate = self._playback_rate * self._rate / out_rate
            out = np.zeros((c, frames), np.float32)
            pos = self._position * self._rate   # fractional source frame
            produced = 0
            while produced < frames:
                m = frames - produced
                if rate <= 0.0:
                    break  # rate 0: hold position, emit the current sample
                span_end = int(math.floor(pos + (m - 1) * rate)) + 2
                self._fill_to_locked(span_end)
                limit = self._n_total if self._eof else \
                    self._win_start + self._win.shape[1]
                # furthest producible output count: idx + 1 must stay
                # inside the window for the lerp's k+1 tap
                avail = int(math.floor((limit - 1 - pos) / rate)) + 1 \
                    if limit - 1 >= pos else 0
                take = min(m, max(avail, 0))
                if take > 0:
                    idx = pos + np.arange(take, dtype=np.float64) * rate
                    k = np.floor(idx).astype(np.int64)
                    frac = (idx - k).astype(np.float32)
                    o = k - self._win_start
                    seg = self._win[:, o] * (1 - frac) + \
                        self._win[:, np.minimum(o + 1, self._win.shape[1] - 1)] * frac
                    out[:, produced:produced + take] = seg
                    produced += take
                    pos = pos + take * rate
                if produced >= frames:
                    break
                # ran out of source material
                if self._eof and self._loop and self._n_total and \
                        self._n_total > 0:
                    self._seek_stream_locked(0.0)
                    pos = pos - self._n_total
                    if pos < 0.0:
                        pos = 0.0
                    continue
                if self._eof:
                    self._paused = True  # ended
                    pos = float(self._n_total or pos)
                    break
                break  # defensive: no progress possible
            if rate <= 0.0 and frames > 0 and self._win.shape[1] > 0:
                self._fill_to_locked(int(pos) + 2)
                o = min(max(int(pos) - self._win_start, 0),
                        self._win.shape[1] - 1)
                out[:] = self._win[:, o:o + 1]
            self._position = pos / self._rate
            self._trim_locked(int(math.floor(pos)))
            return out

    def _pull_chunk_buffer(self, frames: int, out_rate: float) -> np.ndarray:
        buf = self._buffer
        data = buf.to_array()
        c = buf.number_of_channels
        with self._lock:
            if self._paused:
                return np.zeros((c, frames), np.float32)
            rate = self._playback_rate * buf.sample_rate / out_rate
            pos = self._position * buf.sample_rate
            idx = pos + np.arange(frames, dtype=np.float64) * rate
            n = buf.length
            if self._loop:
                idx = np.mod(idx, n)
                valid = np.ones(frames, bool)
            else:
                valid = idx < n - 1
                idx = np.clip(idx, 0, n - 1)
            k = np.floor(idx).astype(np.int64)
            frac = (idx - k).astype(np.float32)
            k1 = np.minimum(k + 1, n - 1)
            out = data[:, k] * (1 - frac) + data[:, k1] * frac
            out = np.where(valid[None, :], out, 0.0).astype(np.float32)
            new_pos = pos + frames * rate
            if self._loop:
                new_pos = np.mod(new_pos, n)
            else:
                new_pos = min(new_pos, float(n))
                if new_pos >= n:
                    self._paused = True
            self._position = float(new_pos) / buf.sample_rate
            return out
