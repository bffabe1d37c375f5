"""Streaming integer-factor resampling (oversampling for WaveShaperNode).

reference: the rubato `FftFixedInOut` 2x/4x resamplers
(waveshaper.rs:233-348).  Ported from `webaudio_tpu/ops/resample.py`: the
same linear-phase windowed-sinc FIR (scipy `firwin`, Kaiser 9.0,
48 x factor + 1 taps, f32), the same streaming states, the same outputs to
f32 rounding.  The JAX package framed the FIR as banded matmuls because a
convolution of this shape ran at ~5% of the TPU's matrix unit; here it is
the plain polyphase FIR, one `conv1d` each way:

- upsample: the zero-stuffed signal is never built.  Output phase r of
  `factor` is a 49-tap FIR over the dense input (taps h[factor*p + r]), so
  one conv of the (N*C, 1, 48 + B) dense history + block against a
  (factor, 1, 49) phase bank gives (N*C, factor, B), interleaved into
  (N*C, B*factor);
- downsample: a conv with stride `factor` computes only the decimated
  outputs.

Both convolve in f64 and round once to f32 (`_conv`).  An f32 convolution
would go through cuDNN in TF32 (about three decimal digits) under
PyTorch's default `torch.backends.cudnn.allow_tf32`; an f64 one has no
TF32 path, so the result needs no global flag and is the same, to f32
rounding, on the CPU and the card.  Signals are (..., C, T): any leading
axes (the block walk's instance axis N) ride along.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

TAPS_PER_PHASE = 48


@functools.lru_cache(maxsize=None)
def _interp_fir(factor: int, taps_per_phase: int = TAPS_PER_PHASE) -> np.ndarray:
    """Windowed-sinc lowpass at ~fs/(2*factor), gain `factor`, for
    zero-stuffed upsampling.  Odd length, linear phase; cutoff pulled in
    slightly so the stopband covers the fold-back region.  The JAX
    package's design, bit for bit."""
    from scipy.signal import firwin

    n = taps_per_phase * factor + 1
    h = firwin(n, 0.92 / factor, window=("kaiser", 9.0)) * factor
    return h.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _up_bank(factor: int) -> np.ndarray:
    """(factor, 1, 49) conv weights: y_up[factor*t + r] = sum_j
    w[r, 0, j] * xd[t + j] over the dense history + block xd, with
    w[r, 0, j] = h[factor*(48 - j) + r] (zero where that tap is past the
    filter's end)."""
    h = _interp_fir(factor)
    w = np.zeros((factor, 1, TAPS_PER_PHASE + 1), np.float32)
    for r in range(factor):
        for j in range(TAPS_PER_PHASE + 1):
            k = factor * (TAPS_PER_PHASE - j) + r
            if k < len(h):
                w[r, 0, j] = h[k]
    return w


@functools.lru_cache(maxsize=None)
def _down_taps(factor: int) -> np.ndarray:
    """(1, 1, HN) conv weights: the reversed h / factor."""
    h = _interp_fir(factor) / np.float32(factor)
    return np.ascontiguousarray(h[::-1]).reshape(1, 1, -1)


@functools.lru_cache(maxsize=None)
def _taps_on(kind: str, factor: int, device: torch.device) -> torch.Tensor:
    """The up (`_up_bank`) or down (`_down_taps`) taps as f64 on `device`,
    staged at their first use (an eager block) and reused, so a captured
    walk uploads nothing."""
    taps = _up_bank(factor) if kind == "up" else _down_taps(factor)
    return torch.from_numpy(taps).to(device=device, dtype=torch.float64)


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """conv1d of every row of x (..., T) with the (out, 1, K) f64 taps w,
    summed in f64 and rounded once to f32: (rows, out, (T - K) // stride
    + 1)."""
    y = torch.nn.functional.conv1d(
        x.reshape(-1, 1, x.shape[-1]).to(torch.float64), w, stride=stride)
    return y.to(torch.float32)


def up_fir_state(channels: int, factor: int, device="cpu") -> torch.Tensor:
    """Dense-domain input history: taps_per_phase samples."""
    return torch.zeros((channels, TAPS_PER_PHASE), dtype=torch.float32,
                       device=device)


def down_fir_state(channels: int, factor: int, device="cpu") -> torch.Tensor:
    """Upsampled-domain history: HN-1 samples."""
    n = len(_interp_fir(factor))
    return torch.zeros((channels, n - 1), dtype=torch.float32, device=device)


def upsample(x: torch.Tensor, factor: int, state: torch.Tensor):
    """(..., C, B) -> (..., C, B*factor), streaming.  state: (..., C,
    TAPS_PER_PHASE) dense-domain input history.  Returns (output, new
    state)."""
    *lead, B = x.shape
    xd = torch.cat([state, x], dim=-1)                  # (..., C, 48 + B)
    y = _conv(xd, _taps_on("up", factor, xd.device))    # (rows, factor, B)
    # (rows, factor, B) -> (rows, B, factor): phase r is output t*factor + r
    y = y.transpose(1, 2).reshape(*lead, B * factor)
    return y, xd[..., -TAPS_PER_PHASE:]


def downsample(x: torch.Tensor, factor: int, state: torch.Tensor):
    """(..., C, B*factor) -> (..., C, B), streaming anti-aliased decimation.
    state: (..., C, HN-1) upsampled-domain history."""
    *lead, B4 = x.shape
    HN = len(_interp_fir(factor))
    ext = torch.cat([state, x], dim=-1)                 # (..., C, B4 + HN-1)
    y = _conv(ext, _taps_on("down", factor, ext.device),
              stride=factor)                            # (rows, 1, B)
    return y.reshape(*lead, B4 // factor), ext[..., -(HN - 1):]


def fir_valid(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """'valid' FIR along the last axis: x (..., T), h (K,) ->
    (..., T - K + 1), y[t] = sum_k h[k] x[t + K - 1 - k].  The plain
    reference the streaming paths above are held to (the JAX package's
    `_fir_valid`)."""
    taps = np.ascontiguousarray(h.cpu().numpy()[::-1]).reshape(1, 1, -1)
    w = torch.from_numpy(taps).to(device=x.device, dtype=torch.float64)
    return _conv(x, w).reshape(*x.shape[:-1], -1)
