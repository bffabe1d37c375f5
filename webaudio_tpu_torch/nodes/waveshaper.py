"""WaveShaperNode: nonlinear curve shaping with optional oversampling.

reference: src/node/waveshaper.rs.  Curve application (apply_curve,
waveshaper.rs:556-573) is a gather + lerp with edge clamping, run by the
hand-written curve kernel (ops/curve_kernel.py).  2x/4x oversampling runs
the curve at the higher rate between the streaming polyphase up- and
down-samplers (ops/resample.py: a linear-phase FIR design standing in for
the reference's rubato FFT resampler), so the kernel shapes
(N, C, factor * B) samples a block.  Ported from
`webaudio_tpu/nodes/waveshaper.py`.
"""

from __future__ import annotations

from enum import Enum

import numpy as np

from ..constants import InvalidStateError
from ..graph.compiler import Kernel
from ..ops import resample
from ..ops.curve_kernel import curve_lookup
from .audio_node import AudioNode, AudioNodeOptions


class OverSampleType(str, Enum):
    NONE = "none"
    X2 = "2x"
    X4 = "4x"


class _WaveShaperKernel(Kernel):
    def __init__(self, curve, oversample: OverSampleType, channels: int,
                 device):
        self.curve = None if curve is None else np.asarray(curve, np.float32)
        self.oversample = oversample if curve is not None else OverSampleType.NONE
        self.channels = channels
        self.device = device
        self.factor = {"none": 1, "2x": 2, "4x": 4}[self.oversample.value]

    def resources(self):
        return None if self.curve is None else {"curve": self.curve}

    def tail_frames(self):
        if self.factor == 1:
            return 0
        return 2 * len(resample._interp_fir(self.factor))

    def init_state(self):
        if self.factor == 1:
            return None
        return {
            "up": resample.up_fir_state(self.channels, self.factor,
                                        self.device),
            "down": resample.down_fir_state(self.channels, self.factor,
                                            self.device),
        }

    def process(self, scope, state, inputs, params):
        x = inputs[0]                                  # (N, C, B)
        if self.curve is None:
            return state, [x]  # passthrough (reference: waveshaper.rs:420-427)
        # (1 or N, n): one curve for all, or one per instance (a
        # MixedGraphBatch bucket whose members' curves differ); one launch
        # shapes every instance's samples either way, at any factor
        curves = scope.node_resources["curve"]
        if self.factor == 1:
            return state, [curve_lookup(curves, x.contiguous())]
        up, up_st = resample.upsample(x, self.factor, state["up"])
        shaped = curve_lookup(curves, up.contiguous())
        down, down_st = resample.downsample(shaped, self.factor,
                                            state["down"])
        return {"up": up_st, "down": down_st}, [down]


class WaveShaperNode(AudioNode):
    _number_of_inputs = 1
    _number_of_outputs = 1

    def __init__(self, context, curve=None, oversample: str = "none", **options):
        super().__init__(context,
                         options=AudioNodeOptions(**options) if options else None)
        self._curve = None
        self._oversample = OverSampleType(oversample)
        if curve is not None:
            self.set_curve(curve)

    @property
    def curve(self):
        return self._curve

    @curve.setter
    def curve(self, c):
        self.set_curve(c)

    def set_curve(self, curve):
        """reference: waveshaper.rs:180-210; setting the curve twice raises
        InvalidStateError per spec."""
        if self._curve is not None:
            raise InvalidStateError("curve has already been set")
        curve = np.asarray(curve, dtype=np.float32)
        if curve.ndim != 1 or len(curve) < 2:
            raise InvalidStateError("curve must be a 1-d sequence of length >= 2")
        self._curve = curve
        self.context._invalidate_graph_cache()

    @property
    def oversample(self) -> OverSampleType:
        return self._oversample

    @oversample.setter
    def oversample(self, v):
        self.set_oversample(v)

    def set_oversample(self, v):
        self._oversample = OverSampleType(v)
        self.context._invalidate_graph_cache()

    def make_kernel(self, render_ctx):
        c = max(1, render_ctx.input_channel_counts[0])
        return _WaveShaperKernel(self._curve, self._oversample, c,
                                 render_ctx.device)
