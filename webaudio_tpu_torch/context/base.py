"""BaseAudioContext: factory methods + graph bookkeeping.

reference: src/context/base.rs (factories) and
src/context/concrete_base.rs (registration, connect/disconnect sets).
The control side *is* the graph IR here; the compiler snapshots `_nodes` /
`_edges` when it plans a render.  Ported from
`webaudio_tpu/context/base.py`.  The context carries the torch device that
every render of its graph runs on (the card unless the caller names
another).  Decoding (`decode_audio_data`, `decode_audio_data_sync`) waits
for the port of media I/O and raises `NotSupportedError`.
"""

from __future__ import annotations

import enum
from typing import Callable, Optional

import torch

from ..buffer import AudioBuffer
from ..constants import NotSupportedError, assert_valid_sample_rate
from ..graph.ir import Edge


class AudioContextState(str, enum.Enum):
    """reference: src/context/mod.rs (AudioContextState)"""

    SUSPENDED = "suspended"
    RUNNING = "running"
    CLOSED = "closed"


class BaseAudioContext:
    """Shared context behavior (reference: src/context/base.rs:23-452)."""

    def __init__(self, sample_rate: float, device):
        assert_valid_sample_rate(sample_rate)
        self._sample_rate = float(sample_rate)
        self._device = torch.device(device)
        self._nodes: dict[int, "AudioNode"] = {}
        self._edges: list[Edge] = []
        self._next_id = 0
        self._state = AudioContextState.SUSPENDED
        self._current_time = 0.0
        self._graph_version = 0      # structural changes (re-plan needed)
        self._param_version = 0      # automation-only changes
        self._destination = None
        self._listener = None
        self._event_handlers: dict[str, list[Callable]] = {}

    # --- registration / connections -------------------------------------
    def _register(self, node) -> int:
        nid = self._next_id
        self._next_id += 1
        self._nodes[nid] = node
        self._invalidate_graph_cache()
        return nid

    def _connect(self, src: int, src_output: int, dst: int, dst_input: int):
        e = Edge(src, src_output, dst, dst_input)
        if e not in self._edges:
            self._edges.append(e)
        self._invalidate_graph_cache()

    def _connect_param(self, src: int, src_output: int, dst: int, param: str):
        e = Edge(src, src_output, dst, -1, param)
        if e not in self._edges:
            self._edges.append(e)
        self._invalidate_graph_cache()

    def _disconnect(self, src: int, output: Optional[int],
                    dst: Optional[int], input: Optional[int]):
        def keep(e: Edge) -> bool:
            if e.src != src:
                return True
            if output is not None and e.src_output != output:
                return True
            if dst is not None and e.dst != dst:
                return True
            if input is not None and e.dst_input != input:
                return True
            return False

        kept = [e for e in self._edges if keep(e)]
        removed = len(kept) != len(self._edges)
        self._edges = kept
        self._invalidate_graph_cache()
        return removed

    def _disconnect_param(self, src: int, output: Optional[int],
                          dst: int, param: str):
        kept = [
            e for e in self._edges
            if not (e.src == src and e.dst == dst and e.param == param
                    and (output is None or e.src_output == output))]
        removed = len(kept) != len(self._edges)
        self._edges = kept
        self._invalidate_graph_cache()
        return removed

    def _invalidate_graph_cache(self):
        self._graph_version += 1

    def _invalidate_param_cache(self):
        # automation changes leave the plan's structure as it is: offline
        # renders plan per render anyway, and the streaming renders
        # (RenderSession) deliver params as dense rows every step
        self._param_version += 1

    # --- spec attributes --------------------------------------------------
    @property
    def sample_rate(self) -> float:
        return self._sample_rate

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def current_time(self) -> float:
        return self._current_time

    @property
    def state(self) -> AudioContextState:
        return self._state

    @property
    def destination(self):
        return self._destination

    @property
    def listener(self):
        """The AudioListener, created on first use (a hidden node whose
        params every PannerNode reads)."""
        from ..nodes.panner import AudioListener

        if self._listener is None:
            self._listener = AudioListener(self)
        return self._listener

    # --- events ------------------------------------------------------------
    def _add_event_handler(self, name: str, cb: Callable):
        self._event_handlers.setdefault(name, []).append(cb)

    def _dispatch_event(self, name: str, payload=None):
        for cb in self._event_handlers.get(name, []):
            if payload is None:
                cb()
            else:
                cb(payload)

    def set_onstatechange(self, cb: Callable):
        self._add_event_handler("statechange", cb)

    def _set_state(self, state: AudioContextState):
        if state != self._state:
            self._state = state
            # handlers receive an Event payload like the reference's
            # onstatechange(Event {type: "statechange"}) (concrete_base.rs)
            from ..events import EventDispatch, EventType

            self._dispatch_event(
                "statechange", EventDispatch(type=EventType.STATE_CHANGE))

    # --- assets -------------------------------------------------------------
    def create_buffer(self, number_of_channels: int, length: int,
                      sample_rate: float) -> AudioBuffer:
        return AudioBuffer(number_of_channels, length, sample_rate)

    def create_periodic_wave(self, real=None, imag=None,
                             disable_normalization: bool = False):
        from ..periodic_wave import PeriodicWave

        return PeriodicWave(real=real, imag=imag,
                            disable_normalization=disable_normalization)

    def create_audio_param(self, descriptor, node=None):
        from ..param import AudioParam

        return AudioParam(descriptor, node=node)

    # --- node factories (reference: base.rs:126-271) -------------------------
    def create_analyser(self, **kw):
        from ..nodes.analyser import AnalyserNode

        return AnalyserNode(self, **kw)

    def create_biquad_filter(self, **kw):
        from ..nodes.biquad_filter import BiquadFilterNode

        return BiquadFilterNode(self, **kw)

    def create_buffer_source(self, **kw):
        from ..nodes.buffer_source import AudioBufferSourceNode

        return AudioBufferSourceNode(self, **kw)

    def create_constant_source(self, **kw):
        from ..nodes.constant_source import ConstantSourceNode

        return ConstantSourceNode(self, **kw)

    def create_channel_merger(self, number_of_inputs: int = 6, **kw):
        from ..nodes.channel_merger import ChannelMergerNode

        return ChannelMergerNode(self, number_of_inputs=number_of_inputs, **kw)

    def create_channel_splitter(self, number_of_outputs: int = 6, **kw):
        from ..nodes.channel_splitter import ChannelSplitterNode

        return ChannelSplitterNode(self, number_of_outputs=number_of_outputs,
                                   **kw)

    def create_convolver(self, **kw):
        from ..nodes.convolver import ConvolverNode

        return ConvolverNode(self, **kw)

    def create_delay(self, max_delay_time: float = 1.0, **kw):
        from ..nodes.delay import DelayNode

        return DelayNode(self, max_delay_time=max_delay_time, **kw)

    def create_dynamics_compressor(self, **kw):
        from ..nodes.dynamics_compressor import DynamicsCompressorNode

        return DynamicsCompressorNode(self, **kw)

    def create_gain(self, **kw):
        from ..nodes.gain import GainNode

        return GainNode(self, **kw)

    def create_iir_filter(self, feedforward, feedback, **kw):
        from ..nodes.iir_filter import IIRFilterNode

        return IIRFilterNode(self, feedforward=feedforward, feedback=feedback,
                             **kw)

    def create_oscillator_bank(self, frequencies, **kw):
        """V oscillator voices with ADSR envelopes in one node (see
        nodes/oscillator_bank.py)."""
        from ..nodes.oscillator_bank import OscillatorBankNode

        return OscillatorBankNode(self, frequencies, **kw)

    def create_oscillator(self, **kw):
        from ..nodes.oscillator import OscillatorNode

        return OscillatorNode(self, **kw)

    def create_panner(self, **kw):
        from ..nodes.panner import PannerNode

        return PannerNode(self, **kw)

    def create_stereo_panner(self, **kw):
        from ..nodes.stereo_panner import StereoPannerNode

        return StereoPannerNode(self, **kw)

    def create_wave_shaper(self, **kw):
        from ..nodes.waveshaper import WaveShaperNode

        return WaveShaperNode(self, **kw)

    def create_script_processor(self, buffer_size: int = 0,
                                number_of_input_channels: int = 2,
                                number_of_output_channels: int = 2):
        from ..nodes.script_processor import ScriptProcessorNode

        return ScriptProcessorNode(
            self, buffer_size=buffer_size,
            number_of_input_channels=number_of_input_channels,
            number_of_output_channels=number_of_output_channels)

    def create_audio_worklet(self, processor_cls, **kw):
        from ..worklet import AudioWorkletNode

        return AudioWorkletNode(self, processor_cls, **kw)


def _not_ported(name: str):
    def factory(self, *args, **kwargs):
        raise NotSupportedError(
            f"{name} is not ported to webaudio_tpu_torch yet")

    factory.__name__ = name
    return factory


# the JAX package's methods that are not ported yet: decoding waits for
# media I/O
for _name in ("decode_audio_data", "decode_audio_data_sync"):
    setattr(BaseAudioContext, _name, _not_ported(_name))
del _name
