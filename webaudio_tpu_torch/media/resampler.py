"""Stream re-chunker/resampler: arbitrary AudioBuffer chunks -> fixed
128-frame quanta at the context rate.

reference: src/resampling.rs:42-111 (Resampler<I> wrapping an AudioBuffer
iterator, linear resample + fixed-size re-chunk, padding the final chunk).

A copy of `webaudio_tpu/media/resampler.py`, which is framework-free.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from ..buffer import AudioBuffer
from ..constants import RENDER_QUANTUM_SIZE


class Resampler:
    """Iterator adapter (reference: resampling.rs:42-111)."""

    def __init__(self, chunks: Iterator, target_rate: float,
                 quantum: int = RENDER_QUANTUM_SIZE):
        self._chunks = iter(chunks)
        self._rate = float(target_rate)
        self._quantum = quantum
        self._pending = None  # (channels, n) at target rate

    def __iter__(self):
        return self

    def __next__(self) -> AudioBuffer:
        q = self._quantum
        while self._pending is None or self._pending.shape[1] < q:
            try:
                chunk = next(self._chunks)
            except StopIteration:
                if self._pending is not None and self._pending.shape[1] > 0:
                    out = np.zeros((self._pending.shape[0], q), np.float32)
                    out[:, : self._pending.shape[1]] = self._pending
                    self._pending = None
                    return AudioBuffer.from_array(out, self._rate)
                raise
            if chunk.sample_rate != self._rate:
                chunk = AudioBuffer.from_array(chunk.to_array(), chunk.sample_rate)
                chunk.resample(self._rate)
            data = chunk.to_array()
            if self._pending is None:
                self._pending = data.astype(np.float32)
            else:
                c = max(self._pending.shape[0], data.shape[0])
                a = _fit_channels(self._pending, c)
                b = _fit_channels(data, c)
                self._pending = np.concatenate([a, b], axis=1)
        out = self._pending[:, :q]
        self._pending = self._pending[:, q:]
        return AudioBuffer.from_array(out, self._rate)


def _fit_channels(x: np.ndarray, c: int) -> np.ndarray:
    if x.shape[0] == c:
        return x
    out = np.zeros((c, x.shape[1]), x.dtype)
    out[: x.shape[0]] = x
    return out
