"""MediaRecorder: capture a MediaStream into encoded blobs.

reference: src/media_recorder/mod.rs (polls a stream on a thread, encodes
WAV via hound, fires ondataavailable/onstop/onerror).

A copy of `webaudio_tpu/media/recorder.py`, which is framework-free.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import numpy as np

from ..constants import InvalidStateError
from .streams import MediaStream
from . import wav as wav_codec


class BlobEvent:
    def __init__(self, blob: bytes, timecode: float):
        self.blob = blob
        self.timecode = timecode


class MediaRecorder:
    """reference: media_recorder/mod.rs:22-200."""

    def __init__(self, stream: MediaStream):
        self._stream = stream
        self._thread: Optional[threading.Thread] = None
        self._recording = False
        self._ondataavailable: Optional[Callable] = None
        self._onstop: Optional[Callable] = None
        self._onerror: Optional[Callable] = None
        self._chunks: list[np.ndarray] = []
        self._sample_rate: Optional[float] = None

    def set_ondataavailable(self, cb: Callable):
        self._ondataavailable = cb

    def set_onstop(self, cb: Callable):
        self._onstop = cb

    def set_onerror(self, cb: Callable):
        self._onerror = cb

    @property
    def state(self) -> str:
        return "recording" if self._recording else "inactive"

    def start(self):
        if self._recording:
            raise InvalidStateError("recorder already started")
        self._recording = True
        self._chunks = []

        def run():
            track = self._stream.get_audio_tracks()[0]
            start = time.monotonic()
            while self._recording:
                try:
                    chunk = track.next_chunk()
                except Exception as exc:
                    if self._onerror:
                        self._onerror(exc)
                    break
                if chunk is None:
                    break
                self._sample_rate = chunk.sample_rate
                self._chunks.append(chunk.to_array().copy())
            self._finalize(time.monotonic() - start)

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="webaudio-recorder")
        self._thread.start()

    def stop(self):
        # no-op when inactive (W3C MediaRecorder stop() step 1 and the
        # reference's idempotent stop, media_recorder/mod.rs:299-302) —
        # the polling thread may have self-finalized already (track end
        # or error), and racing user code must not blow up
        if not self._recording:
            if self._thread is not None:
                self._thread.join(timeout=5.0)
                self._thread = None
            return
        self._recording = False
        track = self._stream.get_audio_tracks()[0]
        close = getattr(track, "close", None)
        if close:
            close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _finalize(self, elapsed: float):
        self._recording = False
        if self._chunks and self._sample_rate:
            data = np.concatenate(self._chunks, axis=1)
            blob = wav_codec.write_wav(None, data, self._sample_rate)
        else:
            blob = wav_codec.write_wav(
                None, np.zeros((1, 0), np.float32), self._sample_rate or 44100.0)
        if self._ondataavailable:
            self._ondataavailable(BlobEvent(blob, elapsed))
        if self._onstop:
            self._onstop()
