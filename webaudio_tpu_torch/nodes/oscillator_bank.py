"""OscillatorBankNode: V oscillator voices with ADSR envelopes in one node.

An extension without a reference counterpart as a node (SURVEY.md §2.2:
"500 oscillators = one vmapped voice tensor").  Ported from
`webaudio_tpu/nodes/oscillator_bank.py`.  All voices are one (V, B)
tensor program: phases in closed form, ADSR envelopes as analytic
functions of time (no dense param rows at all), mixed to mono or
equal-power stereo.

Semantics per voice match OscillatorNode (phase, waveforms, sub-sample
start) and GainNode with AudioParam ADSR automation (linear attack,
exponential decay to sustain by the setTargetAtTime formula, exponential
release).  Every per-voice value is a staged resource with a leading
instance axis of 1 or N, so a MixedGraphBatch stacks banks that differ
only in their voices.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import RENDER_QUANTUM_SIZE as Q
from ..graph.compiler import Kernel
from ..ops import oscillator as osc_ops
from .audio_node import AudioNode
from .stereo_panner import equal_power


def _as_voice_array(v, n, dtype=np.float32):
    arr = np.asarray(v, dtype=dtype)
    if arr.ndim == 0:
        arr = np.full(n, arr, dtype)
    if arr.shape != (n,):
        raise ValueError(f"expected scalar or ({n},) array, got {arr.shape}")
    return arr


def angle_sum_sine(ph0, incr32, nq):
    """sin(2π(ph0 + incr·j)) for j < 128 by the angle-sum identity: the
    per-sample transcendental drops to (..., V, nq) + (..., V, Q) factors
    and two multiplies (~2e-7 off the direct sine).  ph0 (..., V, nq) f32
    phases at each quantum's first sample; incr32 (..., V, 1) f32 ->
    (..., V, nq * Q)."""
    two_pi = float(np.float32(2 * np.pi))
    j = torch.arange(Q, dtype=torch.float32, device=ph0.device)
    a = two_pi * ph0
    sa, ca = torch.sin(a)[..., None], torch.cos(a)[..., None]
    bb = two_pi * incr32 * j                                  # (..., V, Q)
    sb, cb = torch.sin(bb)[..., None, :], torch.cos(bb)[..., None, :]
    wave = sa * cb + ca * sb                                  # (..., V, nq, Q)
    return wave.reshape(*wave.shape[:-2], nq * Q)


class _BankKernel(Kernel):
    def __init__(self, node: "OscillatorBankNode", rc):
        self.node = node
        self.fs = rc.sample_rate
        self.stereo = node.stereo
        # baked into the kernel, so a MixedGraphBatch buckets by it
        self.wave_type = node.type

    def resources(self):
        n = self.node
        res = {
            "freq": n.frequencies,
            "start": n.starts,
            "stop": n.stops,
            "vol": n.volumes,
            "attack": n.attacks,
            "decay": n.decays,
            "sustain": n.sustains,
            "release": n.releases,
        }
        if self.stereo:
            res["pan"] = n.pans
        return res

    def tail_frames(self):
        return 0  # fully time-indexed

    def process(self, scope, state, inputs, params):
        r = scope.node_resources                                  # (I, V)
        fs = self.fs
        B = scope.frames
        nq = B // Q
        # x / fs as XLA computes it in the JAX package: times 1/fs (f32 or
        # f64), which moves a tenth of the quotients by an ulp
        inv32 = float(np.float32(1.0 / fs))
        t = scope.t_idx.to(torch.float32) * inv32                 # (B,)
        # f64 global time only for the phase product (avoids drift)
        t64 = scope.t_idx.to(torch.float64) * (1.0 / fs)

        freq = r["freq"][..., None]                               # (I, V, 1)
        start = r["start"][..., None]
        stop = r["stop"][..., None]

        # phase: closed form mod 1, f64 only at quantum granularity and f32
        # within the quantum (|incr*127| is small, so the rebase error is
        # <= ~4e-7 of a cycle)
        t64q = t64[::Q]                                           # (nq,)
        ph0 = torch.remainder(freq.double() * (t64q - start.double()),
                              1.0).to(torch.float32)              # (I, V, nq)
        incr = (freq * inv32).to(torch.float32)                   # (I, V, 1)
        j = torch.arange(Q, dtype=torch.float32, device=scope.device)

        if self.wave_type == "sine":
            wave = angle_sum_sine(ph0, incr, nq)
        else:
            ph = osc_ops.ramp_f32(ph0[..., None], incr[..., None], j)
            phase = (ph - torch.floor(ph)).reshape(*ph0.shape[:-1], B)
            if self.wave_type == "sawtooth":
                wave = osc_ops.sawtooth(phase, incr)
            elif self.wave_type == "square":
                wave = osc_ops.square(phase, incr)
            else:
                wave = osc_ops.triangle(phase)

        # analytic ADSR per voice: linear attack, setTargetAtTime-style
        # exponential decay to sustain, exponential release after stop.
        # exp(-(t0+jof)/tau) = exp(-t0/tau)*exp(-jof/tau), the arguments
        # clamped to +-80 so the branch not taken cannot make inf*0
        a = r["attack"][..., None, None]                          # (I, V, 1, 1)
        d = torch.clamp(r["decay"][..., None, None], min=1e-6)
        s = r["sustain"][..., None, None]
        rel = torch.clamp(r["release"][..., None, None], min=1e-6)
        tq = t[::Q][:, None]                                      # (nq, 1)
        jof = j * inv32                                           # (Q,)
        startv = start[..., None]                                 # (I, V, 1, 1)
        stopv = stop[..., None]
        dt_on = (tq - startv) + jof                               # (I, V, nq, Q)
        env_attack = torch.clamp(dt_on / torch.clamp(a, min=1e-9), 0.0, 1.0)
        post = dt_on - a

        def _fexp(base0, tau):
            e1 = torch.exp(torch.clamp(-base0 / tau, -80.0, 80.0))
            e2 = torch.exp(torch.clamp(-jof / tau, -80.0, 80.0))
            return e1 * e2

        env_ads = torch.where(
            post > 0.0, s + (1.0 - s) * _fexp(tq - startv - a, d), env_attack)
        dt_off = (tq - stopv) + jof
        env = torch.where(dt_off > 0.0, env_ads * _fexp(tq - stopv, rel),
                          env_ads)
        active = dt_on >= 0.0
        wave = wave.reshape(*wave.shape[:-1], nq, Q)
        voices = torch.where(active, wave * env, 0.0).reshape(
            *env.shape[:-2], B) * r["vol"][..., None]             # (I, V, B)

        if self.stereo:
            gl, gr = equal_power((r["pan"][..., None] + 1.0) * 0.5)
            out = torch.stack([(voices * gl).sum(-2), (voices * gr).sum(-2)],
                              dim=-2)
        else:
            out = voices.sum(-2, keepdim=True)
        return state, [out.to(torch.float32)]


class OscillatorBankNode(AudioNode):
    """A bank of V oscillator voices mixed to mono or stereo.

    >>> bank = OscillatorBankNode(ctx, frequencies=freqs, type="sine",
    ...                           starts=starts, attacks=0.05, decays=0.1,
    ...                           sustains=0.6, releases=0.3, stereo=True,
    ...                           pans=pans, volumes=1.0 / len(freqs))
    """

    _number_of_inputs = 0
    _number_of_outputs = 1

    def __init__(self, context, frequencies, type: str = "sine",
                 starts=0.0, stops=np.inf, volumes=1.0,
                 attacks=0.0, decays=0.1, sustains=1.0, releases=0.1,
                 stereo: bool = False, pans=0.0):
        super().__init__(context)
        freqs = np.asarray(frequencies, np.float32)
        v = len(freqs)
        self.frequencies = freqs
        self.type = type
        self.starts = _as_voice_array(starts, v)
        self.stops = np.minimum(_as_voice_array(stops, v), np.float32(1e18))
        self.volumes = _as_voice_array(volumes, v)
        self.attacks = _as_voice_array(attacks, v)
        self.decays = _as_voice_array(decays, v)
        self.sustains = _as_voice_array(sustains, v)
        self.releases = _as_voice_array(releases, v)
        self.stereo = bool(stereo)
        self.pans = _as_voice_array(pans, v)

    @property
    def voices(self) -> int:
        return len(self.frequencies)

    def output_channel_count(self, input_counts):
        return [2 if self.stereo else 1]

    def make_kernel(self, render_ctx):
        return _BankKernel(self, render_ctx)
