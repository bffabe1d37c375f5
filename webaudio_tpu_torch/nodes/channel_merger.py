"""ChannelMergerNode: merge N mono inputs into one N-channel output.

reference: src/node/channel_merger.rs (channel config locked to count 1,
mode explicit).  Ported from `webaudio_tpu/nodes/channel_merger.py`.
"""

from __future__ import annotations

from ..constants import InvalidStateError, assert_valid_number_of_channels
from ..ops.mixing import ChannelCountMode, ChannelInterpretation
from .audio_node import AudioNode, ChannelConfig
from .channel_splitter import _MergerKernel


class ChannelMergerNode(AudioNode):
    _number_of_outputs = 1

    def __init__(self, context, number_of_inputs: int = 6):
        assert_valid_number_of_channels(number_of_inputs)
        self._number_of_inputs = int(number_of_inputs)
        cfg = ChannelConfig(count=1,
                            mode=ChannelCountMode.EXPLICIT,
                            interpretation=ChannelInterpretation.SPEAKERS)
        super().__init__(context, channel_config=cfg)

    def _validate_channel_count(self, count: int):
        if count != 1:
            raise InvalidStateError("channel count of ChannelMergerNode is fixed")

    def _validate_channel_count_mode(self, mode):
        if ChannelCountMode(mode) != ChannelCountMode.EXPLICIT:
            raise InvalidStateError(
                "channel count mode of ChannelMergerNode is fixed")

    def output_channel_count(self, input_counts):
        return [self._number_of_inputs]

    def make_kernel(self, render_ctx):
        return _MergerKernel(self._number_of_inputs)
