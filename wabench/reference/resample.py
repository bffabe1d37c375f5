"""An AudioBuffer's resampling to another rate (web-audio-api-rs
buffer.rs:311-363): the new length is ceil(length x ratio) and sample i
reads the old buffer at i / (new - 1) x (length - 1) by linear
interpolation, so both end samples are kept; rates within 0.1 Hz are
only relabelled."""

from __future__ import annotations

import math

import numpy as np


def resample(data: np.ndarray, rate: float, new_rate: float) -> np.ndarray:
    """(C, L) -> (C, ceil(L x new_rate / rate)), float64."""
    data = np.asarray(data, np.float64)
    length = data.shape[-1]
    if abs(new_rate - rate) <= 0.1 or length == 0:
        return data
    n = int(math.ceil(length * (new_rate / rate)))
    pos = (np.arange(n) / (n - 1) if n > 1 else np.zeros(1)) * (length - 1)
    k = np.floor(pos).astype(np.int64)
    f = pos - k
    k1 = np.minimum(k + 1, length - 1)
    return data[:, k] * (1.0 - f) + data[:, k1] * f
