"""AudioNode base class: connect/disconnect API and channel configuration.

reference: src/node/audio_node.rs.  The control side records edges in the
context's connection set; the graph compiler reads that set directly when
it plans a render.  Ported from `webaudio_tpu/nodes/audio_node.py`.
"""

from __future__ import annotations

from typing import Optional

from ..constants import (
    IndexSizeError, InvalidAccessError, assert_valid_number_of_channels,
)
from ..ops.mixing import ChannelCountMode, ChannelInterpretation
from ..param import AudioParam


class ChannelConfig:
    """reference: src/node/audio_node.rs:91-199"""

    def __init__(self, count: int = 2,
                 mode: ChannelCountMode = ChannelCountMode.MAX,
                 interpretation: ChannelInterpretation = ChannelInterpretation.SPEAKERS):
        self.count = int(count)
        self.mode = ChannelCountMode(mode)
        self.interpretation = ChannelInterpretation(interpretation)


class AudioNodeOptions:
    """reference: src/node/audio_node.rs:44-78"""

    def __init__(self, channel_count: Optional[int] = None,
                 channel_count_mode: Optional[ChannelCountMode] = None,
                 channel_interpretation: Optional[ChannelInterpretation] = None):
        self.channel_count = channel_count
        self.channel_count_mode = channel_count_mode
        self.channel_interpretation = channel_interpretation


class AudioNode:
    """Base class for all audio nodes (reference: audio_node.rs:224-466).

    Subclasses set `_number_of_inputs` / `_number_of_outputs`, register
    AudioParams in `_params`, and implement `make_kernel` (see
    graph/compiler.py for the kernel protocol).
    """

    _number_of_inputs = 1
    _number_of_outputs = 1
    # a DelayNode splits into writer and reader vertices so that a feedback
    # cycle through it can be cut (graph/ir.py)
    is_cycle_breaker = False

    def __init__(self, context, options: Optional[AudioNodeOptions] = None,
                 channel_config: Optional[ChannelConfig] = None):
        self.context = context
        self._channel_config = channel_config or ChannelConfig()
        if options is not None:
            if options.channel_count is not None:
                self.set_channel_count(options.channel_count)
            if options.channel_count_mode is not None:
                self.set_channel_count_mode(options.channel_count_mode)
            if options.channel_interpretation is not None:
                self.set_channel_interpretation(options.channel_interpretation)
        self._params: dict[str, AudioParam] = {}
        self.node_id = context._register(self)

    # --- channel config ----------------------------------------------------
    @property
    def number_of_inputs(self) -> int:
        return self._number_of_inputs

    @property
    def number_of_outputs(self) -> int:
        return self._number_of_outputs

    @property
    def channel_count(self) -> int:
        return self._channel_config.count

    @channel_count.setter
    def channel_count(self, count: int):
        self.set_channel_count(count)

    def set_channel_count(self, count: int):
        self._validate_channel_count(count)
        assert_valid_number_of_channels(count)
        self._channel_config.count = int(count)
        self.context._invalidate_graph_cache()

    @property
    def channel_count_mode(self) -> ChannelCountMode:
        return self._channel_config.mode

    @channel_count_mode.setter
    def channel_count_mode(self, mode):
        self.set_channel_count_mode(mode)

    def set_channel_count_mode(self, mode):
        mode = ChannelCountMode(mode)
        self._validate_channel_count_mode(mode)
        self._channel_config.mode = mode
        self.context._invalidate_graph_cache()

    @property
    def channel_interpretation(self) -> ChannelInterpretation:
        return self._channel_config.interpretation

    @channel_interpretation.setter
    def channel_interpretation(self, interp):
        self.set_channel_interpretation(interp)

    def set_channel_interpretation(self, interp):
        self._channel_config.interpretation = ChannelInterpretation(interp)
        self.context._invalidate_graph_cache()

    # per-node constraint hooks (overridden e.g. by the destination)
    def _validate_channel_count(self, count: int):
        pass

    def _validate_channel_count_mode(self, mode: ChannelCountMode):
        pass

    # --- connect / disconnect (reference: audio_node.rs:247-402) -----------
    def connect(self, destination, output: int = 0, input: int = 0):
        if isinstance(destination, AudioParam):
            return self._connect_param(destination, output)
        if destination.context is not self.context:
            raise InvalidAccessError("cannot connect nodes from different contexts")
        if output >= self.number_of_outputs:
            raise IndexSizeError(
                f"output port {output} is out of bounds (total {self.number_of_outputs})")
        if input >= destination.number_of_inputs:
            raise IndexSizeError(
                f"input port {input} is out of bounds "
                f"(total {destination.number_of_inputs})")
        self.context._connect(self.node_id, output, destination.node_id, input)
        return destination

    def _connect_param(self, param: AudioParam, output: int):
        if param._node is None or param._node.context is not self.context:
            raise InvalidAccessError("cannot connect to param from different context")
        if output >= self.number_of_outputs:
            raise IndexSizeError(
                f"output port {output} is out of bounds (total {self.number_of_outputs})")
        self.context._connect_param(self.node_id, output, param._node.node_id, param.name)
        return param

    def disconnect(self, destination=None, output: Optional[int] = None,
                   input: Optional[int] = None):
        if destination is not None and isinstance(destination, AudioParam):
            removed = self.context._disconnect_param(
                self.node_id, output, destination._node.node_id, destination.name)
            if not removed:
                # targeted disconnect of a connection that does not exist
                # throws (concrete_base.rs test_disconnect_not_existing)
                raise InvalidAccessError(
                    "the given destination param is not connected")
            return
        dst_id = destination.node_id if destination is not None else None
        if destination is not None and destination.context is not self.context:
            raise InvalidAccessError("cannot disconnect nodes from different contexts")
        if output is not None and output >= self.number_of_outputs:
            raise IndexSizeError(f"output port {output} is out of bounds")
        if (input is not None and destination is not None
                and input >= destination.number_of_inputs):
            raise IndexSizeError(f"input port {input} is out of bounds")
        removed = self.context._disconnect(self.node_id, output, dst_id, input)
        if destination is not None and not removed:
            raise InvalidAccessError("the given destination is not connected")

    # --- engine hooks --------------------------------------------------------
    @property
    def params(self) -> dict[str, AudioParam]:
        return self._params

    def _register_param(self, name: str, descriptor) -> AudioParam:
        p = AudioParam(descriptor, node=self)
        self._params[name] = p
        return p

    def set_onprocessorerror(self, callback):
        """reference: audio_node.rs:449-465."""
        self._onprocessorerror = callback

    def foreign_params(self) -> dict:
        """Params of *other* nodes this node's kernel reads, as
        alias -> (node, param_name): a PannerNode reads the listener's
        (graph/compiler.py passes them to the kernel under their aliases)."""
        return {}

    def output_channel_count(self, input_counts: list[int]) -> list[int]:
        """Static channel propagation: channel count of each output given the
        *computed* channel counts of this node's inputs.  Default: most
        processing nodes output the (mixed) channel count of input 0."""
        c = input_counts[0] if input_counts else 1
        return [c] * self.number_of_outputs

    def make_kernel(self, render_ctx):
        raise NotImplementedError(
            f"{type(self).__name__} does not implement make_kernel")
