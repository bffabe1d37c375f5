"""StereoPannerNode: equal-power stereo positioning.

reference: src/node/stereo_panner.rs:60-305.  Gains: left =
sin((1-x)·π/2), right = sin(x·π/2); a mono input maps x = (pan+1)/2, a
stereo input splits by the sign of pan, all as `where` selects.  Ported
from `webaudio_tpu/nodes/stereo_panner.py`; `pan` is a-rate.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import NotSupportedError
from ..graph.compiler import Kernel
from ..ops.mixing import ChannelCountMode
from ..param import AudioParamDescriptor, AutomationRate
from .audio_node import AudioNode, AudioNodeOptions, ChannelConfig

HALF_PI = float(np.float32(np.pi / 2.0))


def equal_power(x):
    """(left, right) gains at pan position x in [0, 1], in f32."""
    return torch.sin((1.0 - x) * HALF_PI), torch.sin(x * HALF_PI)


class _StereoPannerKernel(Kernel):
    def __init__(self, mono_input: bool):
        self.mono_input = mono_input

    def tail_frames(self):
        return 0

    def process(self, scope, state, inputs, params):
        x_in = inputs[0]                                # (N, C, B)
        pan = params["pan"]                             # () or (N, 1, B)
        if self.mono_input:
            gl, gr = equal_power((pan + 1.0) * 0.5)
            mono = x_in[:, 0:1]
            out = torch.cat(torch.broadcast_tensors(mono * gl, mono * gr), 1)
        else:
            l, r = x_in[:, 0:1], x_in[:, 1:2]
            left_side = pan <= 0.0
            gl, gr = equal_power(torch.where(left_side, pan + 1.0, pan))
            left = torch.where(left_side, r * gl + l, l * gl)
            right = torch.where(left_side, r * gr, l * gr + r)
            out = torch.cat(torch.broadcast_tensors(left, right), 1)
        return state, [out.to(torch.float32)]


class StereoPannerNode(AudioNode):
    _number_of_inputs = 1
    _number_of_outputs = 1

    def __init__(self, context, pan: float = 0.0, **options):
        cfg = ChannelConfig(count=2, mode=ChannelCountMode.CLAMPED_MAX)
        super().__init__(context,
                         options=AudioNodeOptions(**options) if options else None,
                         channel_config=cfg)
        self.pan = self._register_param(
            "pan", AudioParamDescriptor(
                name="pan", automation_rate=AutomationRate.A,
                default_value=0.0, min_value=-1.0, max_value=1.0))
        if pan != 0.0:
            self.pan.set_value(pan)

    def _validate_channel_count(self, count: int):
        if count > 2:
            raise NotSupportedError(
                "StereoPannerNode channel count cannot be greater than two")

    def _validate_channel_count_mode(self, mode: ChannelCountMode):
        if mode == ChannelCountMode.MAX:
            raise NotSupportedError(
                "StereoPannerNode channel count mode cannot be set to max")

    def output_channel_count(self, input_counts):
        return [2]

    def make_kernel(self, render_ctx):
        return _StereoPannerKernel(
            mono_input=render_ctx.input_channel_counts[0] == 1)
