"""ChannelSplitterNode: fan a multichannel signal out to mono outputs.

reference: src/node/channel_splitter.rs.  Channel config is locked to
(count = number_of_outputs, mode explicit, interpretation discrete).
Ported from `webaudio_tpu/nodes/channel_splitter.py`, with the merger's
kernel.
"""

from __future__ import annotations

import torch

from ..constants import InvalidStateError, assert_valid_number_of_channels
from ..graph.compiler import Kernel
from ..ops.mixing import ChannelCountMode, ChannelInterpretation
from .audio_node import AudioNode, ChannelConfig


class _SplitterKernel(Kernel):
    def __init__(self, n_outputs: int):
        self.n = n_outputs

    def tail_frames(self):
        return 0

    def process(self, scope, state, inputs, params):
        x = inputs[0]                                   # (N, C, B)
        c_in = x.shape[1]
        outs = []
        for i in range(self.n):
            if i < c_in:
                outs.append(x[:, i:i + 1])
            else:
                outs.append(torch.zeros((1, 1, x.shape[2]), dtype=torch.float32,
                                        device=x.device))
        return state, outs


class ChannelSplitterNode(AudioNode):
    def __init__(self, context, number_of_outputs: int = 6):
        assert_valid_number_of_channels(number_of_outputs)
        self._number_of_inputs = 1
        self._number_of_outputs = int(number_of_outputs)
        cfg = ChannelConfig(count=number_of_outputs,
                            mode=ChannelCountMode.EXPLICIT,
                            interpretation=ChannelInterpretation.DISCRETE)
        super().__init__(context, channel_config=cfg)

    def _validate_channel_count(self, count: int):
        if count != self._number_of_outputs:
            raise InvalidStateError(
                "channel count of ChannelSplitterNode is fixed")

    def _validate_channel_count_mode(self, mode):
        if ChannelCountMode(mode) != ChannelCountMode.EXPLICIT:
            raise InvalidStateError(
                "channel count mode of ChannelSplitterNode is fixed")

    def set_channel_interpretation(self, interp):
        if ChannelInterpretation(interp) != ChannelInterpretation.DISCRETE:
            raise InvalidStateError(
                "channel interpretation of ChannelSplitterNode is fixed")

    def output_channel_count(self, input_counts):
        return [1] * self._number_of_outputs

    def make_kernel(self, render_ctx):
        return _SplitterKernel(self._number_of_outputs)


class _MergerKernel(Kernel):
    def __init__(self, n_inputs: int):
        self.n = n_inputs

    def tail_frames(self):
        return 0

    def process(self, scope, state, inputs, params):
        # each input was mixed to 1 channel by fan-in
        return state, [torch.cat([inp[:, :1] for inp in inputs], 1)
                       .to(torch.float32)]
