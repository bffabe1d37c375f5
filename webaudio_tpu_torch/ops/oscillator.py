"""Oscillator waveforms and the split-precision phase accumulator.

reference: src/node/oscillator.rs:500-680.  Ported from
`webaudio_tpu/ops/oscillator.py`.  The reference accumulates phase per
sample in f64; here phase is computed per block:

    phase[n] = carry + exclusive_cumsum(masked phase increments)[n]  (mod 1)

with a two-level split: an f32 cumsum within each 128-frame quantum
(bounded error ~1e-7 cycles), an f64 cumsum over the per-quantum sums, and
an f64 carry across blocks so there is no long-render drift.

Every function takes leading axes (instances, voices) in front of the
sample axis.  Sine is `torch.sin` of the phase, as in the JAX package;
sawtooth and square carry the reference's polyBLEP corrections; custom
waves lerp the PeriodicWave table.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import RENDER_QUANTUM_SIZE

# parity switch with the reference's cfg!(test) polyBLEP disable
# (oscillator.rs:592-603) for closed-form golden comparisons
DISABLE_POLYBLEP = False


def computed_frequency(freq, detune):
    """computed_freq = freq * 2^(detune/1200) in f32 (reference:
    oscillator.rs:30-34)."""
    return freq * torch.exp2(detune * (1.0 / 1200.0))


# the within-quantum prefix sum's blocks (see `cumsum_f32`)
_SCAN_BLOCK = 16


def cumsum_f32(x):
    """Inclusive f32 prefix sum over the last axis (a multiple of 16), in
    the order XLA's CPU backend sums `jnp.cumsum` (its reduce-window
    rewriter): a sequential f32 prefix within each block of 16, a
    sequential prefix over the block sums, and each block's exclusive
    prefix added to its elements.  Every step is an elementwise f32 add,
    so the result is bit-identical on every device and to the JAX
    package's phase (torch's own CPU cumsum accumulates in f64 and its CUDA
    scan in another order: each drifts ~1e-6 cycles from it, which the
    polyBLEP edges of a low sawtooth amplify ~1,000x)."""
    lead, n = x.shape[:-1], x.shape[-1]
    blocks = x.reshape(*lead, n // _SCAN_BLOCK, _SCAN_BLOCK)

    def scan(v):
        cols = [v[..., 0]]
        for k in range(1, v.shape[-1]):
            cols.append(cols[-1] + v[..., k])
        return torch.stack(cols, dim=-1)

    within = scan(blocks)
    pre = scan(within[..., -1])
    excl = torch.cat([torch.zeros_like(pre[..., :1]), pre[..., :-1]], dim=-1)
    return (within + excl[..., None]).reshape(*lead, n)


def ramp_f32(ph0, incr, j):
    """ph0 + incr * j in f32 with one rounding, as XLA's CPU backend
    contracts the JAX package's closed-form phase ramp into an FMA: the
    product of two f32 is exact in f64, so the f64 sum rounded to f32 is
    the FMA's result (a double rounding could differ only on an exact f32
    midpoint).  The same on every device."""
    return (ph0.to(torch.float64) + incr.to(torch.float64)
            * j.to(torch.float64)).to(torch.float32)


def accumulate_phase(carry, incr64, mask, start_correction):
    """Phase accumulation over one block.

    carry: (...) f64, the unwrapped phase in cycles at the block start
    incr64: (..., B) f64 per-sample increments (cycles a sample), f64 as
      the reference's `phase_incr = f64(computed_freq) / fs`
    mask: (..., B) or (B,) bool; inactive samples do not advance the phase
    start_correction: (...) f64 extra phase at the sub-sample start
      (reference: oscillator.rs:521-529)

    Returns (phase (..., B) f32 in [0, 1], new carry (...) f64): an
    exclusive f32 cumsum within each quantum plus an f64 prefix over the
    per-quantum sums."""
    lead = incr64.shape[:-1]
    B = incr64.shape[-1]
    q = RENDER_QUANTUM_SIZE
    nq = B // q
    m64 = torch.where(mask, incr64, 0.0).reshape(*lead, nq, q)
    m32 = m64.to(torch.float32)
    within = cumsum_f32(m32) - m32                            # exclusive, f32
    qsums = m64.sum(dim=-1)                                  # (..., nq) f64
    qoffs = torch.cumsum(qsums, dim=-1) - qsums              # exclusive, f64
    base = carry[..., None] + qoffs + start_correction[..., None]
    base_mod = torch.remainder(base, 1.0).to(torch.float32)  # f64 -> f32 once
    phase = torch.remainder(base_mod[..., None] + within, 1.0).reshape(*lead, B)
    new_carry = torch.remainder(
        carry + qoffs[..., -1] + qsums[..., -1] + start_correction, 1.0)
    return phase, new_carry


def poly_blep(t, dt):
    """Band-limited step correction (reference: oscillator.rs:629-645)."""
    if DISABLE_POLYBLEP:
        return torch.zeros_like(t)
    dt = torch.clamp(dt, min=1e-20)
    t1 = t / dt
    low = t1 + t1 - t1 * t1 - 1.0
    t2 = (t - 1.0) / dt
    high = t2 * t2 + t2 + t2 + 1.0
    return torch.where(t < dt, low, torch.where(t > 1.0 - dt, high, 0.0))


def sine(phase):
    return torch.sin((2.0 * np.pi) * phase)


def sawtooth(phase, incr):
    """offset phase so the wave starts at 0 (reference: oscillator.rs:588-596)."""
    p = torch.remainder(phase + 0.5, 1.0)
    return (2.0 * p - 1.0) - poly_blep(p, incr)


def square(phase, incr):
    s = torch.where(phase < 0.5, 1.0, -1.0).to(phase.dtype)
    s = s + poly_blep(phase, incr)
    return s - poly_blep(torch.remainder(phase + 0.5, 1.0), incr)


def triangle(phase):
    s = -4.0 * phase + 2.0
    s = torch.where(s > 1.0, 2.0 - s, s)
    return torch.where(s < -1.0, -2.0 - s, s)


def wavetable_lookup(phase, table):
    """Linear-interp gather with wrap-around at the table's end (reference:
    oscillator.rs:606-627 / :660-678).  phase (..., B); table (..., n),
    its leading axes broadcast against phase's.  Indices clamp to the table
    as a JAX gather clamps them (a phase that rounds to 1.0 reads the last
    point)."""
    n = table.shape[-1]
    position = phase.to(torch.float32) * n
    floored = torch.floor(position)
    prev_i = floored.to(torch.int64)
    next_i = torch.where(prev_i + 1 == n, 0, prev_i + 1)
    k = position - floored
    lead = torch.broadcast_shapes(phase.shape[:-1], table.shape[:-1])
    tab = table.expand(*lead, n)
    idx = lead + phase.shape[-1:]
    a = torch.gather(tab, -1, torch.clamp(prev_i, 0, n - 1).expand(idx))
    b = torch.gather(tab, -1, torch.clamp(next_i, 0, n - 1).expand(idx))
    return a * (1.0 - k) + b * k
