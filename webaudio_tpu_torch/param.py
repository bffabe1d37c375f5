"""AudioParam: control-side automation API.

reference: src/param.rs:268-661.  The control half records automation events
into a `Timeline` (webaudio_tpu_torch.automation); there is no render-time
interpreter — at compile time the context asks each param for a compiled
dense array / scalar via `compile_for_render`.  Ported from
`webaudio_tpu/param.py`; only `clamp` touches tensors.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from enum import Enum

import numpy as np
import torch

from . import automation
from .automation import (
    ParamEvent, Timeline, SET_VALUE, SET_VALUE_AT_TIME, LINEAR_RAMP,
    EXPONENTIAL_RAMP, SET_TARGET, SET_VALUE_CURVE, CANCEL_SCHEDULED_VALUES,
    CANCEL_AND_HOLD,
)
from .constants import assert_valid_time_value, InvalidStateError


class AutomationRate(str, Enum):
    """reference: param.rs:123-139"""

    A = "a-rate"
    K = "k-rate"

    @property
    def is_a_rate(self) -> bool:
        return self is AutomationRate.A


@dataclass
class AudioParamDescriptor:
    """reference: param.rs:141-149"""

    name: str
    automation_rate: AutomationRate
    default_value: float
    min_value: float
    max_value: float


class AudioParam:
    """Control handle for one automatable parameter.

    Construction validates bounds like `audio_param_pair`
    (reference: param.rs:1603-1654)."""

    def __init__(self, descriptor: AudioParamDescriptor, node=None):
        d = descriptor
        for v in (d.default_value, d.min_value, d.max_value):
            if not math.isfinite(v):
                raise TypeError("TypeError - The provided value is non-finite.")
        if not (d.min_value <= d.default_value <= d.max_value):
            raise InvalidStateError(
                "AudioParam minValue <= defaultValue <= maxValue required")
        self._descriptor = d
        self._automation_rate = d.automation_rate
        self._automation_rate_constrained = False
        self._timeline = Timeline(d.default_value)
        self._current_value = float(d.default_value)
        # the node owning this param (for graph connections *into* the param)
        self._node = node
        self._context = node.context if node is not None else None
        self._mark_dirty()

    def _mark_dirty(self):
        if self._context is not None:
            self._context._invalidate_param_cache()

    # --- attributes (reference: param.rs:403-457) -----------------------
    @property
    def name(self) -> str:
        return self._descriptor.name

    @property
    def automation_rate(self) -> AutomationRate:
        return self._automation_rate

    @automation_rate.setter
    def automation_rate(self, value: AutomationRate):
        if self._automation_rate_constrained and value != self._automation_rate:
            raise InvalidStateError("automation rate cannot be changed")
        self._automation_rate = AutomationRate(value)
        self._mark_dirty()

    def set_automation_rate_constrained(self, constrained: bool):
        self._automation_rate_constrained = bool(constrained)

    @property
    def default_value(self) -> float:
        return self._descriptor.default_value

    @property
    def min_value(self) -> float:
        return self._descriptor.min_value

    @property
    def max_value(self) -> float:
        return self._descriptor.max_value

    @property
    def value(self) -> float:
        return min(max(self._current_value, self.min_value), self.max_value)

    @value.setter
    def value(self, v: float):
        self.set_value(v)

    def is_constant_schedule(self) -> bool:
        """True iff the automation timeline pins this param to one constant
        for the whole render (only immediate set_value events at t=0)."""
        return all(ev.event_type == SET_VALUE and ev.time == 0.0
                   for ev in self._timeline.events)

    # --- automation methods (reference: param.rs:458-637) ----------------
    def set_value(self, value: float) -> "AudioParam":
        if not math.isfinite(value):
            raise TypeError("TypeError - The provided value is non-finite.")
        self._current_value = float(value)
        self._timeline.handle_event(ParamEvent(SET_VALUE, value=float(value), time=0.0))
        self._mark_dirty()
        return self

    def set_value_at_time(self, value: float, start_time: float) -> "AudioParam":
        if not math.isfinite(value):
            raise TypeError("TypeError - The provided value is non-finite.")
        assert_valid_time_value(start_time)
        self._timeline.handle_event(
            ParamEvent(SET_VALUE_AT_TIME, value=float(value), time=float(start_time)))
        self._mark_dirty()
        return self

    def linear_ramp_to_value_at_time(self, value: float, end_time: float) -> "AudioParam":
        if not math.isfinite(value):
            raise TypeError("TypeError - The provided value is non-finite.")
        assert_valid_time_value(end_time)
        self._timeline.handle_event(
            ParamEvent(LINEAR_RAMP, value=float(value), time=float(end_time)))
        self._mark_dirty()
        return self

    def exponential_ramp_to_value_at_time(self, value: float, end_time: float) -> "AudioParam":
        automation._assert_not_zero(value)
        assert_valid_time_value(end_time)
        self._timeline.handle_event(
            ParamEvent(EXPONENTIAL_RAMP, value=float(value), time=float(end_time)))
        self._mark_dirty()
        return self

    def set_target_at_time(self, value: float, start_time: float,
                           time_constant: float) -> "AudioParam":
        if not math.isfinite(value):
            raise TypeError("TypeError - The provided value is non-finite.")
        assert_valid_time_value(start_time)
        assert_valid_time_value(time_constant)
        if time_constant == 0.0:
            # equivalent to SetValueAtTime (reference: param.rs:540-549)
            return self.set_value_at_time(value, start_time)
        self._timeline.handle_event(
            ParamEvent(SET_TARGET, value=float(value), time=float(start_time),
                       time_constant=float(time_constant)))
        self._mark_dirty()
        return self

    def set_value_curve_at_time(self, values, start_time: float,
                                duration: float) -> "AudioParam":
        values = np.asarray(values, dtype=np.float32)
        automation._assert_sequence_length(values)
        assert_valid_time_value(start_time)
        automation._assert_strictly_positive(duration)
        self._timeline.handle_event(
            ParamEvent(SET_VALUE_CURVE, value=float(values[0]), time=float(start_time),
                       duration=float(duration), values=values.copy()))
        self._mark_dirty()
        return self

    def cancel_scheduled_values(self, cancel_time: float) -> "AudioParam":
        assert_valid_time_value(cancel_time)
        self._timeline.handle_event(
            ParamEvent(CANCEL_SCHEDULED_VALUES, time=float(cancel_time)))
        self._mark_dirty()
        return self

    def cancel_and_hold_at_time(self, cancel_time: float) -> "AudioParam":
        assert_valid_time_value(cancel_time)
        self._timeline.handle_event(
            ParamEvent(CANCEL_AND_HOLD, time=float(cancel_time)))
        self._mark_dirty()
        return self

    # --- engine hooks ----------------------------------------------------
    def compile_for_render(self, sample_rate: float, length: int,
                           start_frame: int = 0,
                           force_dense: bool = False) -> automation.CompiledParam:
        """Compile the timeline over ``[start_frame, start_frame+length)``.

        Operates on a snapshot so repeated compiles from frame 0 are
        idempotent; suspend/re-trace advances `_timeline` itself."""
        tl = self._timeline.snapshot()
        return automation.compile_timeline(
            tl, sample_rate, length, self._automation_rate.is_a_rate,
            start_frame=start_frame, force_dense=force_dense)

    def advance_dense(self, sample_rate: float, length: int,
                      start_frame: int = 0) -> np.ndarray:
        """Consume the live timeline over the range, returning dense values
        (the streaming renders' per-chunk path: the reference's per-quantum
        compute_buffer on the render thread)."""
        compiled = automation.compile_timeline(
            self._timeline, sample_rate, length,
            self._automation_rate.is_a_rate,
            start_frame=start_frame, force_dense=True)
        self._current_value = self._timeline.intrinsic_value
        return compiled.dense

    def f32_bounds(self) -> tuple[float, float]:
        """(min, max) rounded to f32, as the f32 tensors they clip see them
        (torch refuses a bound such as 3.4028235e38 that overflows f32
        before rounding)."""
        return float(np.float32(self.min_value)), float(np.float32(self.max_value))

    def clamp(self, x: torch.Tensor) -> torch.Tensor:
        """Clamp per spec; NaN maps to default (reference: param.rs:755-796)."""
        y = torch.clamp(x, *self.f32_bounds())
        return torch.where(torch.isnan(x), self.default_value, y)
