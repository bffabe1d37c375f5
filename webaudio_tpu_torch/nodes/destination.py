"""AudioDestinationNode: graph terminal.

reference: src/node/destination.rs.  A pass-through whose mixed input is the
render output; channel constraints differ online/offline
(destination.rs:55-97).  Ported from `webaudio_tpu/nodes/destination.py`.
"""

from __future__ import annotations

from ..constants import IndexSizeError, InvalidStateError, MAX_CHANNELS
from ..graph.compiler import Kernel
from ..ops.mixing import ChannelCountMode, ChannelInterpretation
from .audio_node import AudioNode, ChannelConfig


class _PassthroughKernel(Kernel):
    def tail_frames(self):
        return 0

    def process(self, scope, state, inputs, params):
        return state, [inputs[0]]


class AudioDestinationNode(AudioNode):
    _number_of_inputs = 1
    _number_of_outputs = 1

    def __init__(self, context, channel_count: int, offline: bool = True):
        self._offline = offline
        self._max_channel_count = channel_count if offline else MAX_CHANNELS
        # offline: count mode explicit at the buffer's channel count
        # (reference: destination.rs:55-97)
        cfg = ChannelConfig(
            count=channel_count,
            mode=ChannelCountMode.EXPLICIT if offline else ChannelCountMode.MAX,
            interpretation=ChannelInterpretation.SPEAKERS)
        super().__init__(context, channel_config=cfg)

    @property
    def max_channel_count(self) -> int:
        return self._max_channel_count

    def _validate_channel_count(self, count: int):
        if self._offline and count != self._max_channel_count:
            raise InvalidStateError(
                "cannot change channel count of an offline destination")
        if count > self._max_channel_count:
            raise IndexSizeError(
                f"channel count {count} exceeds max {self._max_channel_count}")

    def _validate_channel_count_mode(self, mode: ChannelCountMode):
        if self._offline and mode != ChannelCountMode.EXPLICIT:
            raise InvalidStateError(
                "offline destination requires explicit channel count mode")

    def output_channel_count(self, input_counts):
        return [input_counts[0] if input_counts else self._channel_config.count]

    def make_kernel(self, render_ctx):
        return _PassthroughKernel()
