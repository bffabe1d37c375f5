"""BASELINE config 5 on one whole song in plain PyTorch: a buffer source
-> WaveShaperNode (4x oversampling) -> DynamicsCompressorNode ->
AnalyserNode -> destination, stereo, in float64 on the CPU.

The equations are `reference/mastering.py`'s (waveshaper.rs,
dynamics_compressor.rs:364-470), computed so that a 4-minute song fits:

- The oversampler's FIRs run in blocks of `BLOCK` dense samples, with the
  history of the block before carried in, by the polyphase identity: the
  zero-stuffed up pass is 4 FIRs over the dense signal, phase r taking
  the taps h[r::4] (49 taps for r = 0, 48 for the others); the down pass
  computes only the outputs it keeps, every fourth.  Each pass is a
  product of the signal's overlapping frames with a banded matrix of the
  taps (`_fir_matrices`), a matrix multiplication where a convolution
  of these shapes runs ~50x slower on one CPU thread.  Both sum in
  float64 from silence, as `_fir`'s whole-signal convolution does; the
  operands are rounded first and the sums after.
- The detector's recurrence is a loop over Python floats, in chunks.
- Departures from `reference/mastering.py`: none in the equations; the
  sums of the FIRs run in another order (a direct sum here, an FFT
  there), which moves float64 results by ~1e-16 of the signal.

`precision` names the rounding of every operation (float64, float32 or
tfloat32), and may add ",fir=<name>" for the oversampler's operands
alone, as `reference/mastering.py` takes it.  torch is imported where a
render runs, so that importing this module loads nothing of torch.
"""

from __future__ import annotations

import math
from array import array

import numpy as np

from .mastering import FACTOR, TAPS_PER_PHASE, taps

BLOCK = 1 << 16                     # dense samples a FIR block
FRAME = 64                          # outputs a row of the FIRs' matrices
CHUNK = 1 << 18                     # samples a chunk of the detector's loop
HN = TAPS_PER_PHASE * FACTOR + 1    # 193 taps

# significant bits of the precisions a Python float is rounded to in the
# detector's loop, both in float32's range (normal from 2^-126)
_BITS = {"float32": 24, "tfloat32": 11}


def _keep_bits(x, drop):
    """float32 values with their lowest `drop` mantissa bits rounded off to
    nearest even, as float64: what `precision._keep_bits` does.  The sum
    runs on the raw bits, sign and all: a magnitude rounds up at most to
    the infinity's pattern, so no carry reaches the sign."""
    import torch

    u = x.to(torch.float32).view(torch.int32)
    u = (u + ((1 << (drop - 1)) - 1) + ((u >> drop) & 1)) & -(1 << drop)
    return u.view(torch.float32).to(torch.float64)


def rounder(name: str):
    """The rounding of float64 tensors to `name`, after each operation."""
    import torch

    if name == "float64":
        return lambda x: x
    if name == "float32":
        return lambda x: x.to(torch.float32).to(torch.float64)
    if name == "tfloat32":
        return lambda x: _keep_bits(x, 13)
    raise ValueError(f"unknown precision {name!r}")


def scalar_rounder(name: str):
    """The same rounding of one Python float in float32's normal range (0
    included), or None for float64: to float32 first, then to fewer bits,
    as `rounder` does (an integer halved by a power of two is exact, and
    `round` ties to even)."""
    if name == "float64":
        return None
    if name not in _BITS:
        raise ValueError(f"unknown precision {name!r}")
    bits = _BITS[name]
    f32, drop = float(1 << 24), float(1 << (24 - bits))
    frexp, ldexp = math.frexp, math.ldexp

    def q(v):
        m, e = frexp(v)
        return ldexp(round(round(m * f32) / drop), e - bits)
    return q


def _fir_matrices(q, q_in):
    """The two FIRs as banded matrices over frames of `FRAME` outputs, their
    operands rounded: up (FRAME + 48, 4 FRAME), whose column 4 t + r is
    phase r's taps h[4 j + r] at rows t + 48 - j (the dense input, 48
    samples of history first); down (4 FRAME + HN - 1, FRAME), whose
    column t is the taps / 4 at rows 4 t + HN - 1 - k (the upsampled
    input, HN - 1 samples of history first)."""
    import torch

    h = q_in(q(torch.from_numpy(taps())))
    g = q_in(q(torch.from_numpy(taps() / FACTOR)))
    up = torch.zeros((FRAME + TAPS_PER_PHASE, FACTOR * FRAME),
                     dtype=torch.float64)
    down = torch.zeros((FACTOR * FRAME + HN - 1, FRAME), dtype=torch.float64)
    for t in range(FRAME):
        for r in range(FACTOR):
            phase = h[r::FACTOR]                  # h[4 j + r], j = 0, 1, ...
            rows = t + TAPS_PER_PHASE - torch.arange(len(phase))
            up[rows, FACTOR * t + r] = phase
        down[FACTOR * t + HN - 1 - torch.arange(HN), t] = g
    return up, down


def _frames_fir(sig, mat, hop):
    """sig (C, history + hop x frames) through `mat` a frame: (C, frames x
    the matrix's columns), summed in float64."""
    frames = sig.unfold(-1, mat.shape[0], hop)    # (C, frames, rows)
    return (frames @ mat).reshape(sig.shape[0], -1)


def upsample_block(x, hist, mat, q, q_in):
    """The zero-stuffed up pass of a dense block x (C, n), n a multiple of
    FRAME, after the dense history hist (C, 48): (C, 4 n)."""
    import torch

    return q(_frames_fir(q_in(q(torch.cat([hist, x], dim=-1))), mat, FRAME))


def downsample_block(s, hist, mat, q, q_in):
    """Every fourth output of the down pass over an upsampled block s
    (C, 4 n), n a multiple of FRAME, after its history hist (C, HN - 1):
    (C, n)."""
    import torch

    return q(_frames_fir(q_in(q(torch.cat([hist, s], dim=-1))), mat,
                         FACTOR * FRAME))


def shape(x, curve, q):
    """x (C, m) through the curve (n,): waveshaper.rs apply_curve."""
    import torch

    n = curve.shape[-1]
    v = q(q(x + 1.0) * q(torch.tensor((n - 1) / 2.0, dtype=torch.float64)))
    v = v.clamp(0.0, n - 1)
    k = torch.floor(v).to(torch.int64).clamp(max=n - 2)
    f = q(v - k)
    c = q(curve)
    return q(q(c[k] * q(1.0 - f)) + q(c[k + 1] * f))


def oversampled_shape(x, curve, q, q_fir=None, block=BLOCK):
    """The WaveShaperNode at 4x over x (C, T), in blocks of `block` dense
    samples: (C, T)."""
    import torch

    q_in = q_fir or q
    up_mat, down_mat = _fir_matrices(q, q_in)
    C, T = x.shape
    up_hist = torch.zeros((C, TAPS_PER_PHASE), dtype=torch.float64)
    down_hist = torch.zeros((C, HN - 1), dtype=torch.float64)
    out = torch.empty((C, T), dtype=torch.float64)
    for s in range(0, T, block):
        xb = x[:, s:s + block]
        n = xb.shape[1]
        # the last block padded with silence to whole frames; what the pad
        # reaches is cut, and the histories hold only the signal
        pad = torch.nn.functional.pad(xb, (0, -n % FRAME))
        up = upsample_block(pad, up_hist, up_mat, q, q_in)
        up_hist = torch.cat([up_hist, xb], dim=-1)[:, -TAPS_PER_PHASE:]
        shaped = shape(up, curve, q)
        out[:, s:s + n] = downsample_block(shaped, down_hist, down_mat, q,
                                           q_in)[:, :n]
        down_hist = torch.cat([down_hist, shaped[:, :FACTOR * n]],
                              dim=-1)[:, -(HN - 1):]
    return out


def detector(xl, attack_tau, release_tau, precision="float64"):
    """The branching one-pole over xl (T,) from 0, a Python float a step,
    each product and the sum rounded to `precision`: (T,) float64.  The
    products (1 - tau) x do not depend on y and are taken as tensors."""
    import torch

    q = scalar_rounder(precision) or float
    qt = rounder(precision)
    a, r = q(attack_tau), q(release_tau)
    one_a, one_r = q(1.0 - a), q(1.0 - r)
    out = torch.empty(xl.shape[0], dtype=torch.float64)
    y = 0.0
    for s in range(0, xl.shape[0], CHUNK):
        x = xl[s:s + CHUNK]
        steps = zip(x.tolist(), qt(one_a * x).tolist(),
                    qt(one_r * x).tolist())
        ys = [0.0] * x.shape[0]
        if precision == "float64":
            for i, (xt, bx_a, bx_r) in enumerate(steps):
                y = a * y + bx_a if xt > y else r * y + bx_r
                ys[i] = y
        else:
            for i, (xt, bx_a, bx_r) in enumerate(steps):
                y = q(q(a * y) + bx_a) if xt > y else q(q(r * y) + bx_r)
                ys[i] = y
        out[s:s + x.shape[0]] = torch.frombuffer(array("d", ys),
                                                 dtype=torch.float64)
    if precision != "float64" and bool(
            ((out.abs() < 2.0 ** -126) & (out != 0.0)).any()):
        raise ValueError("the detector left float32's normal range, where "
                         "its scalar rounding does not hold")
    return out


def compress(x, fs, threshold, ratio, q, precision, knee=30.0,
             attack=0.003, release=0.25):
    """The DynamicsCompressorNode over x (C, T), threshold and ratio one
    instance's: (C, T)."""
    import torch

    def qs(v):
        return float(q(torch.tensor(v, dtype=torch.float64)))

    thr, rat = float(threshold), float(ratio)
    peak = q(x.abs().amax(dim=0))
    db = torch.where(peak == 0.0, torch.tensor(-1000.0, dtype=torch.float64),
                     q(20.0 * q(torch.log10(peak))))
    over = q(db - thr)
    half = knee / 2.0
    knee_branch = q(db + q(q(q(over + half) ** 2)
                           * qs(qs(1.0 / rat - 1.0) / (2.0 * knee))))
    att = torch.where(db <= thr - half, db,
                      torch.where(db <= thr + half, knee_branch,
                                  q(thr + q(over / rat))))
    xl = q(db - att)
    det = detector(xl, math.exp(-1.0 / (attack * fs)),
                   math.exp(-1.0 / (release * fs)), precision)
    full_range_gain = thr - thr / rat
    makeup = 20.0 * math.log10((1.0 / 10.0 ** (full_range_gain / 20.0))
                               ** 0.6)
    gain = q(10.0 ** (q(qs(makeup) - det) / 20.0))
    lookahead = int(math.ceil(fs * 0.006 / 128)) * 128
    delayed = torch.zeros_like(x)
    delayed[:, lookahead:] = x[:, :-lookahead]
    return q(delayed * gain[None, :])


def render(clip, curve, threshold, ratio, fs, precision="float64",
           knee=30.0, attack=0.003, release=0.25):
    """clip (C, T) at fs, the source's output over the render; curve (n,)
    and threshold, ratio one instance's.  Returns the destination's (C, T)
    as float64 numpy."""
    import torch

    ops, _, fir = precision.partition(",fir=")
    q = rounder(ops)
    x = q(torch.as_tensor(np.asarray(clip, np.float64)))
    shaped = oversampled_shape(
        x, torch.as_tensor(np.asarray(curve, np.float64)), q,
        rounder(fir) if fir else None)
    return compress(shaped, fs, threshold, ratio, q, ops, knee=knee,
                    attack=attack, release=release).numpy()
