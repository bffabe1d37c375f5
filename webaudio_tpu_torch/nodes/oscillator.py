"""OscillatorNode: periodic waveform source.

reference: src/node/oscillator.rs.  Ported from
`webaudio_tpu/nodes/oscillator.py`.  The per-sample f64 phase loop
(oscillator.rs:437-556) becomes a block computation (ops/oscillator.py):
a closed-form phase when frequency and detune are constant, the
split-precision cumsum otherwise.  A sub-sample start advances the phase
by `incr * (n0 - start*fs)` like the reference's ratio pre-advance
(oscillator.rs:521-529); frequencies at or beyond Nyquist emit silence
while the phase keeps advancing (oscillator.rs:542-556).
"""

from __future__ import annotations

from enum import Enum

import numpy as np
import torch

from ..constants import InvalidStateError
from ..graph.compiler import Kernel
from ..ops import oscillator as osc_ops
from ..param import AudioParamDescriptor, AutomationRate
from ..periodic_wave import PeriodicWave
from .scheduled_source import AudioScheduledSourceNode


class OscillatorType(str, Enum):
    SINE = "sine"
    SQUARE = "square"
    SAWTOOTH = "sawtooth"
    TRIANGLE = "triangle"
    CUSTOM = "custom"


def waveform(kind, phase, incr, table=None):
    """The oscillator's wave at `phase` (f32 in [0, 1]): `incr` the f32
    per-sample increment (polyBLEP width), `table` a custom wave's table."""
    if kind == OscillatorType.CUSTOM:
        return osc_ops.wavetable_lookup(phase, table)
    if kind == OscillatorType.SINE:
        return osc_ops.sine(phase)
    if kind == OscillatorType.SAWTOOTH:
        return osc_ops.sawtooth(phase, incr)
    if kind == OscillatorType.SQUARE:
        return osc_ops.square(phase, incr)
    return osc_ops.triangle(phase)


class _OscillatorKernel(Kernel):
    def __init__(self, type_: OscillatorType, wavetable, start_frame: int,
                 stop_frame: int, start_time: float, sample_rate: float,
                 device, const_freq: float | None = None):
        self.type_ = type_
        self.device = device
        self.wavetable = None if wavetable is None else np.asarray(wavetable)
        self.start_frame = start_frame
        self.stop_frame = stop_frame
        self.sample_rate = sample_rate
        # constant computed frequency -> closed-form phase (no cumsums)
        self.const_freq = const_freq
        if const_freq is not None:
            # the f32 per-sample increment, staged once
            self.incr_host = float(np.float64(np.float32(const_freq))
                                   / sample_rate)
            self.incr = torch.tensor(np.float32(self.incr_host),
                                     device=device)
        # sub-sample start phase pre-advance ratio in [0, 1)
        # (reference: oscillator.rs:521-529)
        if start_frame >= 2**31 - 1:
            self.start_ratio = 0.0
        else:
            self.start_ratio = float(start_frame - start_time * sample_rate)

    def resources(self):
        return None if self.wavetable is None else {"table": self.wavetable}

    def tail_frames(self):
        # closed-form phase is time-indexed; cumsum phase carries state
        return 0 if self.const_freq is not None else None

    def init_state(self):
        return {"phase": torch.zeros((), dtype=torch.float64,
                                     device=self.device)}

    def process(self, scope, state, inputs, params):
        fs = self.sample_rate
        B = scope.frames
        mask = scope.active_mask(self.start_frame, self.stop_frame)   # (B,)

        if self.const_freq is not None:
            # closed-form phase for a constant frequency: no cumsums, no
            # carry dependency; phase = incr * (n - start) + ratio * incr,
            # one row shared by every instance
            incr_host = self.incr_host
            ref = min(self.start_frame, 2**31 - 1)
            n_rel = (scope.t_idx - ref).to(torch.float64)
            phase = torch.remainder((n_rel + self.start_ratio) * incr_host,
                                    1.0).to(torch.float32)[None, None]
            incr = self.incr
            carry = state["phase"]  # structural placeholder
            if not abs(np.float32(self.const_freq)) < fs / 2.0:
                mask = torch.zeros_like(mask)
        else:
            # () or (N, 1, B) params -> (N, B)
            computed = osc_ops.computed_frequency(params["frequency"],
                                                  params["detune"])
            computed = torch.broadcast_to(computed, (scope.n, 1, B))[:, 0]
            # / fs as XLA computes it in the JAX package: times 1/fs
            incr64 = computed.to(torch.float64) * (1.0 / fs)
            incr = incr64.to(torch.float32)

            # the start correction applies from the block holding the first
            # active sample onward (carried in the f64 phase afterwards)
            at_start = scope.t_idx == self.start_frame
            corr = torch.where(at_start, incr64, 0.0).sum(-1) * self.start_ratio
            phase, carry = osc_ops.accumulate_phase(
                state["phase"], incr64, mask, corr)
            mask = mask & (torch.abs(computed) < fs / 2.0)
            phase, incr, mask = phase[:, None], incr[:, None], mask[:, None]

        table = None
        if self.type_ == OscillatorType.CUSTOM:
            table = scope.node_resources["table"][:, None]      # (1|N, 1, n)
        wave = waveform(self.type_, phase, incr, table)
        out = torch.where(mask, wave, 0.0).to(torch.float32)
        return {"phase": carry}, [out]


class OscillatorNode(AudioScheduledSourceNode):
    _number_of_inputs = 0
    _number_of_outputs = 1

    def __init__(self, context, type: str = "sine", frequency: float = 440.0,
                 detune: float = 0.0, periodic_wave: PeriodicWave | None = None):
        super().__init__(context)
        fs = context.sample_rate
        self.frequency = self._register_param(
            "frequency",
            AudioParamDescriptor(
                name="frequency", automation_rate=AutomationRate.A,
                default_value=440.0, min_value=-fs / 2, max_value=fs / 2))
        self.detune = self._register_param(
            "detune",
            AudioParamDescriptor(
                name="detune", automation_rate=AutomationRate.A,
                default_value=0.0, min_value=-153600.0, max_value=153600.0))
        if frequency != 440.0:
            self.frequency.set_value(frequency)
        if detune != 0.0:
            self.detune.set_value(detune)
        self._periodic_wave = periodic_wave
        if periodic_wave is not None:
            self._type = OscillatorType.CUSTOM
        else:
            self._type = OscillatorType(type)

    @property
    def type(self) -> OscillatorType:
        return self._type

    @type.setter
    def type(self, t):
        self.set_type(t)

    def set_type(self, t):
        t = OscillatorType(t)
        # [spec] setting type on a custom oscillator is not allowed
        if self._type == OscillatorType.CUSTOM:
            if t != OscillatorType.CUSTOM:
                raise InvalidStateError(
                    "cannot change oscillator type when a custom periodic wave is set")
            return
        if t == OscillatorType.CUSTOM:
            raise InvalidStateError(
                "set a PeriodicWave via set_periodic_wave to use a custom type")
        self._type = t
        self.context._invalidate_graph_cache()

    def set_periodic_wave(self, wave: PeriodicWave):
        self._periodic_wave = wave
        self._type = OscillatorType.CUSTOM
        self.context._invalidate_graph_cache()

    def output_channel_count(self, input_counts):
        return [1]

    def make_kernel(self, render_ctx):
        start, stop = self._schedule_frames(render_ctx.sample_rate)
        table = None
        if self._type == OscillatorType.CUSTOM:
            table = self._periodic_wave.as_array()
        const_freq = None
        plans = render_ctx.param_plans
        if plans and plans["frequency"].is_constant and plans["detune"].is_constant:
            f = np.float32(min(max(plans["frequency"].scalar,
                                   self.frequency.min_value),
                               self.frequency.max_value))
            d = np.float32(min(max(plans["detune"].scalar,
                                   self.detune.min_value),
                               self.detune.max_value))
            const_freq = float(np.float32(f * np.exp2(d / np.float32(1200.0))))
        return _OscillatorKernel(self._type, table, start, stop,
                                 self._start_time, render_ctx.sample_rate,
                                 render_ctx.device, const_freq=const_freq)
