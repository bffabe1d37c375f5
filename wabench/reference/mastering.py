"""BASELINE config 5 in plain NumPy/SciPy: a looping buffer source ->
WaveShaperNode (4x oversampling, a curve of its own per instance) ->
DynamicsCompressorNode -> AnalyserNode -> destination, stereo, then the
int16 bounce.

- The oversampler (web-audio-api-rs waveshaper.rs: a linear-phase
  resampler; the port's design): a windowed-sinc FIR, scipy firwin with
  48 x 4 + 1 taps, Kaiser beta 9.0, cutoff 0.92 / 4, gain 4, its taps
  rounded to float32.  Up: the signal zero-stuffed to 4x and filtered;
  down: filtered by the taps / 4 and decimated; both start from silence.
- The curve (waveshaper.rs apply_curve): v = (x + 1) (n - 1) / 2,
  clamped to [0, n - 1], a linear interpolation between the two curve
  points around v.
- The compressor (dynamics_compressor.rs:364-470): the sidechain is the
  largest |x| over the channels in dB (0 -> -1000 dB), the gain computer
  has a soft knee, the detector is the branching attack/release one-pole
  y = tau y + (1 - tau) xL, the makeup gain is (1 / curve(1))^0.6 in dB,
  and the gain is applied to the input delayed by ceil(fs x 0.006 / 128)
  render quanta.
- The analyser passes its input on unchanged.
"""

from __future__ import annotations

import math

import numpy as np

from . import philox
from .precision import rounder

FACTOR = 4
TAPS_PER_PHASE = 48


def taps() -> np.ndarray:
    """The oversampler's interpolation filter, float32 values as float64."""
    from scipy.signal import firwin

    h = firwin(TAPS_PER_PHASE * FACTOR + 1, 0.92 / FACTOR,
               window=("kaiser", 9.0)) * FACTOR
    return h.astype(np.float32).astype(np.float64)


def _fir(x, h, q, q_in=None):
    """Causal FIR of each row of x (..., T) with h, from silence: (..., T);
    its operands rounded by `q_in` (else `q`), its sums by `q`."""
    from scipy.signal import oaconvolve

    q_in = q_in or q
    y = oaconvolve(q_in(q(x)), q_in(q(h))[(None,) * (x.ndim - 1)], axes=-1)
    return q(y[..., :x.shape[-1]])


def shape(x, curves, q):
    """x (N, C, T) through curve (N, n) of each instance."""
    n = curves.shape[-1]
    v = q(q(x + 1.0) * q((n - 1) / 2.0))
    v = np.clip(v, 0.0, n - 1)
    k = np.minimum(np.floor(v).astype(np.int64), n - 2)
    f = q(v - k)
    rows = np.arange(curves.shape[0])[:, None, None]
    c = q(curves)
    return q(q(c[rows, k] * q(1.0 - f)) + q(c[rows, k + 1] * f))


def oversampled_shape(x, curves, q, q_fir=None):
    """The WaveShaperNode at 4x: (N, C, T) -> (N, C, T)."""
    h = taps()
    up = np.zeros(x.shape[:-1] + (FACTOR * x.shape[-1],))
    up[..., ::FACTOR] = x
    up = _fir(up, h, q, q_fir)
    shaped = shape(up, curves, q)
    return _fir(shaped, h / FACTOR, q, q_fir)[..., ::FACTOR]


def detector(xl, attack_tau, release_tau, q):
    """The branching one-pole over (N, T) from 0."""
    n, t_len = xl.shape
    out = np.empty((n, t_len))
    y = np.zeros(n)
    a, r = q(attack_tau), q(release_tau)
    one_a, one_r = q(1.0 - a), q(1.0 - r)
    xq = q(xl)
    for t in range(t_len):
        xt = xq[:, t]
        att = xt > y
        y = q(q(np.where(att, a, r) * y) + q(np.where(att, one_a, one_r) * xt))
        out[:, t] = y
    return out


def compress(x, fs, threshold, ratio, q, knee=30.0, attack=0.003,
             release=0.25):
    """The DynamicsCompressorNode over (N, C, T); threshold and ratio
    (N,) per instance, the rest the node's defaults."""
    thr = np.asarray(threshold, np.float64)[:, None]
    rat = np.asarray(ratio, np.float64)[:, None]
    peak = q(np.abs(x).max(axis=1))
    with np.errstate(divide="ignore"):
        db = np.where(peak == 0.0, -1000.0, q(20.0 * q(np.log10(peak))))
    over = q(db - thr)
    half = knee / 2.0
    knee_branch = q(db + q(q(q(over + half) ** 2)
                           * q(q(1.0 / rat - 1.0) / (2.0 * knee))))
    att = np.where(db <= thr - half, db,
                   np.where(db <= thr + half, knee_branch,
                            q(thr + q(over / rat))))
    xl = q(db - att)
    det = detector(xl, math.exp(-1.0 / (attack * fs)),
                   math.exp(-1.0 / (release * fs)), q)
    full_range_gain = thr - thr / rat
    makeup = 20.0 * np.log10((1.0 / 10.0 ** (full_range_gain / 20.0)) ** 0.6)
    gain = q(10.0 ** (q(q(makeup) - det) / 20.0))
    lookahead = int(math.ceil(fs * 0.006 / 128)) * 128
    delayed = np.concatenate(
        [np.zeros(x.shape[:-1] + (lookahead,)), x[..., :-lookahead]], axis=-1)
    return q(delayed * gain[:, None, :])


def render(clips, curves, threshold, ratio, fs, precision="float64",
           knee=30.0, attack=0.003, release=0.25):
    """clips (N, C, T) at fs, the looping source's output of each instance
    over the render; curves (N, n); threshold, ratio (N,).  `precision`
    names the rounding of every operation, and may add ",fir=<name>" for
    the oversampler's operands alone (a lower-precision resampler).
    Returns the destination's (N, C, T) as float64."""
    ops, _, fir = precision.partition(",fir=")
    q = rounder(ops)
    x = q(np.asarray(clips, np.float64))
    shaped = oversampled_shape(x, curves, q, rounder(fir) if fir else None)
    return compress(shaped, fs, threshold, ratio, q, knee=knee,
                    attack=attack, release=release)


def codes(out, seed: int, first_offsets) -> np.ndarray:
    """The int16 bounce of each instance's (C, T) output; instance i's first
    element sits at flat index first_offsets[i] of the bounced batch."""
    return np.stack([philox.dither_i16(o, seed, int(off))
                     for o, off in zip(out, first_offsets)])
