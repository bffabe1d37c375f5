"""Output sinks: where online-rendered audio goes.

reference: src/io/ (cpal/cubeb OS backends + the `none` virtual backend,
io/none.rs:38-74).  GPU servers have no sound card; the equivalents are
a deadline-paced null sink, a user-callback sink (the programmatic
consumer), and a WAV file sink.  All implement the AudioBackend protocol
(the analog of AudioBackendManager, io/mod.rs:207-257).  A copy of
`webaudio_tpu/io_backends.py`, which is framework-free.  Each sink takes
host numpy chunks: the online loop copies a chunk off the card once.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

# latency category -> callback buffer size in frames
# (reference: io/mod.rs:260-286)
LATENCY_BUFFER_SIZES = {
    "interactive": 128,
    "balanced": 512,
    "playback": 1024,
}


class AudioBackend:
    """Sink protocol (reference: io/mod.rs:207-257)."""

    sink_id = "none"

    def write(self, chunk: np.ndarray, timestamp: float) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass

    @property
    def output_latency(self) -> float:
        return 0.0


class NoneBackend(AudioBackend):
    """Discards audio; the render loop's deadline timer provides pacing
    (reference: io/none.rs:45-74)."""

    sink_id = "none"

    def write(self, chunk, timestamp):
        pass


class CallbackBackend(AudioBackend):
    """Delivers rendered chunks to a user callback — the programmatic
    equivalent of an OS audio callback."""

    sink_id = "callback"

    def __init__(self, callback: Callable[[np.ndarray, float], None]):
        self._cb = callback

    def write(self, chunk, timestamp):
        self._cb(chunk, timestamp)


class WavFileBackend(AudioBackend):
    """Streams rendered audio into a WAV file."""

    def __init__(self, path: str, channels: int, sample_rate: float):
        self.sink_id = f"file:{path}"
        self._path = path
        self._channels = channels
        self._sample_rate = sample_rate
        self._chunks: list[np.ndarray] = []

    def write(self, chunk, timestamp):
        self._chunks.append(np.asarray(chunk, np.float32))

    def close(self):
        from .media.wav import write_wav

        if self._chunks:
            data = np.concatenate(self._chunks, axis=1)
        else:
            data = np.zeros((self._channels, 0), np.float32)
        write_wav(self._path, data, self._sample_rate)


class SoundDeviceBackend(AudioBackend):
    """Real audio output on dev machines through the `sounddevice`
    package (PortAudio) — the optional cpal/cubeb analog from SURVEY §7
    item 7.  GPU servers have no sound card and no sounddevice install, so
    construction raises NotSupportedError with guidance when the package
    (or a device) is unavailable; the engine itself never depends on it.

    sink_id: "sounddevice" (default output device) or
    "sounddevice:<device>" (a PortAudio device index or name substring).
    """

    def __init__(self, channels: int, sample_rate: float,
                 device=None, _module=None):
        from .constants import NotSupportedError

        if _module is None:
            try:
                import sounddevice as _module  # type: ignore
            except Exception as exc:
                raise NotSupportedError(
                    "sounddevice (PortAudio) is not available on this "
                    "host — use the 'none', callback, or 'file:<path>' "
                    "sinks instead") from exc
        self._sd = _module
        self.sink_id = ("sounddevice" if device is None
                        else f"sounddevice:{device}")
        try:
            self._stream = _module.OutputStream(
                samplerate=sample_rate, channels=channels,
                dtype="float32", device=device)
            self._stream.start()
        except Exception as exc:
            raise NotSupportedError(
                f"sounddevice output device unavailable: {exc}") from exc
        self._latency = float(getattr(self._stream, "latency", 0.0) or 0.0)

    def write(self, chunk, timestamp):
        # (channels, frames) -> PortAudio's interleaved (frames, channels)
        self._stream.write(np.ascontiguousarray(
            np.asarray(chunk, np.float32).T))

    def close(self):
        try:
            self._stream.stop()
            self._stream.close()
        except Exception:
            pass

    @property
    def output_latency(self) -> float:
        return self._latency


def build_backend(sink_id, channels: int, sample_rate: float) -> AudioBackend:
    """reference: io/mod.rs:151-204 (build_output)."""
    if sink_id is None or sink_id in ("", "none"):
        return NoneBackend()
    if callable(sink_id):
        return CallbackBackend(sink_id)
    if isinstance(sink_id, AudioBackend):
        return sink_id
    if isinstance(sink_id, str) and sink_id.startswith("file:"):
        return WavFileBackend(sink_id[5:], channels, sample_rate)
    if isinstance(sink_id, str) and sink_id.startswith("sounddevice"):
        device = sink_id.partition(":")[2] or None
        if device is not None and device.isdigit():
            device = int(device)
        return SoundDeviceBackend(channels, sample_rate, device=device)
    from .constants import NotFoundError

    raise NotFoundError(f"Invalid sinkId: {sink_id!r}")
