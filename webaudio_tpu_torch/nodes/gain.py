"""GainNode: y = x * gain.

reference: src/node/gain.rs.  Ported from `webaudio_tpu/nodes/gain.py`.
"""

from __future__ import annotations

from ..graph.compiler import Kernel
from ..param import AudioParamDescriptor, AutomationRate
from .audio_node import AudioNode, AudioNodeOptions


class _GainKernel(Kernel):
    def tail_frames(self):
        return 0

    def process(self, scope, state, inputs, params):
        return state, [inputs[0] * params["gain"]]


class GainNode(AudioNode):
    _number_of_inputs = 1
    _number_of_outputs = 1

    def __init__(self, context, gain: float = 1.0, **options):
        super().__init__(context, options=AudioNodeOptions(**options) if options else None)
        self.gain = self._register_param(
            "gain",
            AudioParamDescriptor(
                name="gain", automation_rate=AutomationRate.A,
                default_value=1.0, min_value=-3.4028235e38, max_value=3.4028235e38))
        if gain != 1.0:
            self.gain.set_value(gain)

    def make_kernel(self, render_ctx):
        return _GainKernel()
