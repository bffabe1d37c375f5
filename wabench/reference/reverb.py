"""BASELINE config 3 in plain NumPy/SciPy: a looping buffer source into a
normalized ConvolverNode and into a DelayNode whose output feeds back
through a GainNode; the convolver and the gain into the destination.

- Normalization (convolver.rs:16-50): scale = 0.00125 / max(sqrt(sum of
  squares / samples), 0.000125) x 44100 / the IR's rate.
- A stereo input through a stereo IR: channel c convolved with IR
  channel c.
- The delay of d = 0.31 s read at t - d x fs with linear interpolation
  between the two samples around it: y[t] = k x[t - n - 1] + (1 - k)
  x[t - n], n + k = d x fs with d as float32; its input x = dry + g y,
  and the destination takes wet + g y.
"""

from __future__ import annotations

import math

import numpy as np

from .precision import rounder

# the history before a window that the feedback path needs: g**periods
# of the delay is below float64's resolution at g = 0.4
HISTORY_PERIODS = 40


def normalized(ir, rate, q):
    ir = q(np.asarray(ir, np.float64))
    power = math.sqrt(float(np.sum(ir ** 2)) / ir.size)
    scale = 0.00125 / max(power, 0.000125) * 44100.0 / rate
    return q(ir * scale)


def looped(dry, start, stop):
    """The looping source's output over frames [start, stop): the buffer
    repeated from frame 0, silence before it."""
    dry = np.asarray(dry, np.float64)
    t = np.arange(start, stop)
    out = dry[:, np.mod(t, dry.shape[1])]
    out[:, t < 0] = 0.0
    return out


def render(dry, ir, fs, delay_s, feedback, start, frames,
           precision="float64"):
    """The destination's (C, frames) float64 over [start, start + frames)
    of a render from frame 0."""
    from scipy.signal import fftconvolve

    q = rounder(precision)
    d = float(np.float32(delay_s)) * fs
    n = math.floor(d)
    k0 = d - n
    lo = max(0, start - HISTORY_PERIODS * n)
    stop = start + frames
    h = normalized(ir, fs, q)
    src = q(looped(dry, lo - (h.shape[1] - 1), stop))
    wet = np.stack([fftconvolve(src[c], h[c])[h.shape[1] - 1:
                                              h.shape[1] - 1 + stop - lo]
                    for c in range(src.shape[0])])
    wet = q(wet)
    x_in = src[:, h.shape[1] - 1:]
    x = np.zeros_like(x_in)
    y = np.zeros_like(x_in)
    g = q(feedback)
    for c0 in range(0, stop - lo, n):
        t = np.arange(c0, min(c0 + n, stop - lo))
        a = np.where(t - n - 1 >= 0, x[:, np.maximum(t - n - 1, 0)], 0.0)
        b = np.where(t - n >= 0, x[:, np.maximum(t - n, 0)], 0.0)
        y[:, t] = q(q(k0 * a) + q((1.0 - k0) * b))
        x[:, t] = q(x_in[:, t] + q(g * y[:, t]))
    out = q(wet + q(g * y))
    return out[:, start - lo:]
