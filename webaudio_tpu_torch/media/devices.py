"""MediaDevices API: device enumeration and capture.

reference: src/media_devices/mod.rs.  A GPU server has no sound hardware; the
device list exposes the virtual sinks (none / callback / file) and a
virtual microphone that can be pointed at a WAV file via
`WEBAUDIO_VIRTUAL_MIC` (useful for tests and batch capture pipelines).
Device ids are stable hashes like the reference (media_devices/mod.rs:40-60).

A copy of `webaudio_tpu/media/devices.py`, which is framework-free.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from enum import Enum
from typing import Optional

import numpy as np

from .streams import MediaStream, MediaStreamTrack


class MediaDeviceInfoKind(str, Enum):
    AUDIO_INPUT = "audioinput"
    AUDIO_OUTPUT = "audiooutput"


@dataclass
class MediaDeviceInfo:
    device_id: str
    group_id: str
    kind: MediaDeviceInfoKind
    label: str


def _stable_id(*parts) -> str:
    h = hashlib.sha1("|".join(str(p) for p in parts).encode()).hexdigest()
    return h[:16]


def enumerate_devices_sync() -> list[MediaDeviceInfo]:
    """reference: media_devices/mod.rs:27-37."""
    devices = [
        MediaDeviceInfo(_stable_id("output", "none"), "",
                        MediaDeviceInfoKind.AUDIO_OUTPUT, "Null output (none)"),
        MediaDeviceInfo(_stable_id("output", "file"), "",
                        MediaDeviceInfoKind.AUDIO_OUTPUT, "WAV file output"),
        MediaDeviceInfo(_stable_id("output", "callback"), "",
                        MediaDeviceInfoKind.AUDIO_OUTPUT, "Callback output"),
    ]
    if os.environ.get("WEBAUDIO_VIRTUAL_MIC"):
        devices.append(MediaDeviceInfo(
            _stable_id("input", "virtual"), "",
            MediaDeviceInfoKind.AUDIO_INPUT, "Virtual microphone (WAV)"))
    return devices


@dataclass
class MediaTrackConstraints:
    sample_rate: Optional[float] = None
    latency: Optional[float] = None
    channel_count: Optional[int] = None
    device_id: Optional[str] = None


def get_user_media_sync(constraints: Optional[MediaTrackConstraints] = None
                        ) -> MediaStream:
    """reference: media_devices/mod.rs (get_user_media_sync).

    Capture comes from the virtual microphone: a WAV file named by
    WEBAUDIO_VIRTUAL_MIC looped forever, or silence when unset."""
    constraints = constraints or MediaTrackConstraints()
    rate = constraints.sample_rate or 44100.0
    channels = constraints.channel_count or 1
    path = os.environ.get("WEBAUDIO_VIRTUAL_MIC")

    from ..buffer import AudioBuffer

    if path:
        from .decoding import decode_audio_data

        buf = decode_audio_data(path)
        buf.resample(rate)
        data = buf.to_array()

        def gen():
            i = 0
            n = data.shape[1]
            while True:
                j = i + 128
                if j <= n:
                    chunk = data[:, i:j]
                else:
                    chunk = np.concatenate([data[:, i:], data[:, : j - n]], axis=1)
                i = j % n
                yield AudioBuffer.from_array(chunk, rate)
    else:
        def gen():
            while True:
                yield AudioBuffer.from_array(
                    np.zeros((channels, 128), np.float32), rate)

    return MediaStream([MediaStreamTrack(gen(), label="virtual-mic")])
