"""ConstantSourceNode: outputs the `offset` param while scheduled.

reference: src/node/constant_source.rs:200-265: per-sample active mask
`start_time <= n*dt < stop_time`; offset values are already sub-sample
accurate from the param engine.  Ported from
`webaudio_tpu/nodes/constant_source.py`.
"""

from __future__ import annotations

import torch

from ..graph.compiler import Kernel
from ..param import AudioParamDescriptor, AutomationRate
from .scheduled_source import AudioScheduledSourceNode


class _ConstantSourceKernel(Kernel):
    def __init__(self, start_frame: int, stop_frame: int):
        self.start_frame = start_frame
        self.stop_frame = stop_frame

    def tail_frames(self):
        return 0

    def process(self, scope, state, inputs, params):
        offset = params["offset"]                       # () or (N, 1, B)
        mask = scope.active_mask(self.start_frame, self.stop_frame)
        out = torch.where(mask, offset, 0.0).to(torch.float32)
        return state, [torch.broadcast_to(
            out, (out.shape[0] if out.dim() == 3 else 1, 1, scope.frames))]


class ConstantSourceNode(AudioScheduledSourceNode):
    _number_of_inputs = 0
    _number_of_outputs = 1

    def __init__(self, context, offset: float = 1.0):
        super().__init__(context)
        self.offset = self._register_param(
            "offset",
            AudioParamDescriptor(
                name="offset", automation_rate=AutomationRate.A,
                default_value=1.0, min_value=-3.4028235e38, max_value=3.4028235e38))
        if offset != 1.0:
            self.offset.set_value(offset)

    def output_channel_count(self, input_counts):
        return [1]

    def make_kernel(self, render_ctx):
        start, stop = self._schedule_frames(render_ctx.sample_rate)
        return _ConstantSourceKernel(start, stop)
