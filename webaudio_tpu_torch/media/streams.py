"""MediaStreams API: track/stream plumbing for streaming audio.

reference: src/media_streams/mod.rs.  A MediaStreamTrack wraps an iterator
of AudioBuffer chunks (the reference's `FallibleBuffer` iterator behind
arc-swap slots); a MediaStream is an ordered track list.  Consumers
(media source nodes, MediaRecorder) pull chunks; real-time safety concerns
disappear because pulling happens on the host control/render-loop side.

A copy of `webaudio_tpu/media/streams.py`, which is framework-free.
"""

from __future__ import annotations

import itertools
import threading
from typing import Iterable, Iterator, Optional

from ..buffer import AudioBuffer


class MediaStreamTrack:
    """reference: media_streams/mod.rs:30-120."""

    _ids = itertools.count(1)

    def __init__(self, chunks: Iterator, kind: str = "audio",
                 label: str = ""):
        self.id = f"track-{next(self._ids)}"
        self.kind = kind
        self.label = label
        self._lock = threading.Lock()
        self._iter = iter(chunks)
        self._ended = False
        # broadcast state for multi-consumer iter(): a lagging consumer
        # catches up to the LATEST chunk, skipping missed ones
        # (reference: media_streams/mod.rs arc-swap slots,
        # test_lazy_multiple_consumers)
        self._seq = 0
        self._latest = None

    @classmethod
    def from_iterator(cls, it: Iterable, label: str = "") -> "MediaStreamTrack":
        return cls(iter(it), label=label)

    @classmethod
    def from_buffer(cls, buffer: AudioBuffer, chunk_frames: int = 128,
                    label: str = "") -> "MediaStreamTrack":
        def gen():
            data = buffer.to_array()
            for i in range(0, buffer.length, chunk_frames):
                yield AudioBuffer.from_array(
                    data[:, i:i + chunk_frames], buffer.sample_rate)

        return cls(gen(), label=label)

    @property
    def ready_state(self) -> str:
        return "ended" if self._ended else "live"

    def next_chunk(self) -> Optional[AudioBuffer]:
        """Pull the next chunk; None when the track has ended."""
        with self._lock:
            if self._ended:
                return None
            try:
                chunk = next(self._iter)
            except StopIteration:
                self._ended = True
                return None
            self._seq += 1
            self._latest = chunk
            if isinstance(chunk, Exception):
                # fallible chunks surface as errors but don't end the track
                # (reference: FallibleBuffer)
                raise chunk
            return chunk

    def iter(self) -> "_TrackIterator":
        """A consumer cursor over the shared stream.  Multiple consumers
        share one underlying iterator; one that falls behind receives the
        most recent chunk and skips the rest (reference:
        media_streams/mod.rs test_lazy_multiple_consumers)."""
        return _TrackIterator(self)

    def __iter__(self):
        return self.iter()

    def close(self):
        with self._lock:
            self._ended = True


class _TrackIterator:
    def __init__(self, track: MediaStreamTrack):
        self._track = track
        self._seen = track._seq

    def __iter__(self):
        return self

    def __next__(self) -> AudioBuffer:
        t = self._track
        with t._lock:
            if t._seq > self._seen:
                # catch up to the newest chunk the stream has produced
                self._seen = t._seq
                chunk = t._latest
                if isinstance(chunk, Exception):
                    raise chunk
                return chunk
        chunk = t.next_chunk()
        self._seen = t._seq
        if chunk is None:
            raise StopIteration
        return chunk

    # convenience for transcribed tests: None at end instead of raising
    def next(self) -> Optional[AudioBuffer]:
        try:
            return self.__next__()
        except StopIteration:
            return None


class MediaStream:
    """reference: media_streams/mod.rs:150-251."""

    _ids = itertools.count(1)

    def __init__(self, tracks: list[MediaStreamTrack]):
        self.id = f"stream-{next(self._ids)}"
        self._tracks = list(tracks)

    @classmethod
    def from_tracks(cls, tracks: list[MediaStreamTrack]) -> "MediaStream":
        return cls(tracks)

    @classmethod
    def from_iterator(cls, it: Iterable) -> "MediaStream":
        return cls([MediaStreamTrack.from_iterator(it)])

    @classmethod
    def from_buffer(cls, buffer: AudioBuffer) -> "MediaStream":
        return cls([MediaStreamTrack.from_buffer(buffer)])

    def get_tracks(self) -> list[MediaStreamTrack]:
        return list(self._tracks)

    def get_audio_tracks(self) -> list[MediaStreamTrack]:
        return [t for t in self._tracks if t.kind == "audio"]


class PushStreamTrack(MediaStreamTrack):
    """A live track fed by a producer (used by
    MediaStreamAudioDestinationNode): chunks pushed from the render loop,
    pulled by consumers; keeps only the latest chunks like the reference's
    microphone channel (io/microphone.rs:9-68, skip-to-latest policy)."""

    def __init__(self, max_queue: int = 128, label: str = ""):
        import collections

        self._queue = collections.deque(maxlen=max_queue)
        self._cond = threading.Condition()
        self._closed = False
        super().__init__(iter(()), label=label)

    def push(self, chunk: AudioBuffer):
        with self._cond:
            self._queue.append(chunk)
            self._cond.notify_all()

    def next_chunk(self, timeout: float = 1.0) -> Optional[AudioBuffer]:
        with self._cond:
            if not self._queue and not self._closed:
                self._cond.wait(timeout=timeout)
            if not self._queue:
                return None
            return self._queue.popleft()

    def close(self):
        with self._cond:
            self._closed = True
            self._ended = True
            self._cond.notify_all()
