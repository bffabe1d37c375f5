"""PeriodicWave: Fourier-series -> 8192-sample wavetable.

reference: src/periodic_wave.rs:70-200.  Synthesis is vectorized as a single
(size x harmonics) product instead of the reference's nested loop.  A copy
of `webaudio_tpu/periodic_wave.py` (numpy only): the table is built on the
host and staged like any other resource.
"""

from __future__ import annotations

import numpy as np

from .constants import IndexSizeError

PERIODIC_WAVE_TABLE_LENGTH = 8192


class PeriodicWave:
    def __init__(self, real=None, imag=None, disable_normalization: bool = False):
        if real is not None and imag is not None:
            real = np.asarray(real, dtype=np.float32)
            imag = np.asarray(imag, dtype=np.float32)
            if len(real) != len(imag):
                raise IndexSizeError("`real` and `imag` length should be equal")
            if len(real) < 2:
                raise IndexSizeError("`real` and `imag` length should be at least 2")
        elif real is not None:
            real = np.asarray(real, dtype=np.float32)
            if len(real) < 2:
                raise IndexSizeError("`real` length should be at least 2")
            imag = np.zeros_like(real)
        elif imag is not None:
            imag = np.asarray(imag, dtype=np.float32)
            if len(imag) < 2:
                raise IndexSizeError("`imag` length should be at least 2")
            real = np.zeros_like(imag)
        else:
            # defaults to sine
            real = np.array([0.0, 0.0], dtype=np.float32)
            imag = np.array([0.0, 1.0], dtype=np.float32)

        self._wavetable = self._generate_wavetable(
            real, imag, normalize=not disable_normalization,
            size=PERIODIC_WAVE_TABLE_LENGTH)

    @staticmethod
    def _generate_wavetable(reals, imags, normalize: bool, size: int) -> np.ndarray:
        """reference: periodic_wave.rs:168-200 (f32 math preserved)."""
        phase = (2.0 * np.float32(np.pi)) * np.arange(size, dtype=np.float32) / np.float32(size)
        j = np.arange(1, len(reals), dtype=np.float32)
        rad = phase[:, None] * j[None, :]
        table = (np.cos(rad) * reals[1:][None, :]
                 + np.sin(rad) * imags[1:][None, :]).sum(axis=1).astype(np.float32)
        if normalize:
            mx = np.abs(table).max()
            if mx > 0.0:
                table = (table / mx).astype(np.float32)
        return table

    def as_array(self) -> np.ndarray:
        return self._wavetable
