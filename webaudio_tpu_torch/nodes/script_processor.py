"""ScriptProcessorNode (deprecated API): host-callback block processing.

reference: src/node/script_processor.rs.  Buffers `buffer_size` frames,
emits an AudioProcessingEvent whose handler fills the output buffer, played
back with a fixed two-buffer latency (script_processor.rs:190-275).

The handler is host Python, so each completed buffer is copied from the
render device to the host, handed to the handler, and its output uploaded
again: one synchronizing round trip per buffer and instance (this API is
deprecated for good reason; prefer AudioWorkletNode, whose processor runs
on the device inside the block walk).  Graphs containing this node keep
the block size a power of two, so buffers align with blocks.  Ported from
`webaudio_tpu/nodes/script_processor.py`, whose `jax.pure_callback` is a
plain call here and whose `lax.cond` on the buffer boundary a host `if`
on the block's `frame0_host`: a plan with this node is never captured as
a CUDA graph (`CompiledGraph.capture` names it).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import IndexSizeError
from ..graph.compiler import Kernel
from ..ops.mixing import ChannelCountMode, ChannelInterpretation
from .audio_node import AudioNode, ChannelConfig


class AudioProcessingEvent:
    """reference: src/events.rs:62-72."""

    def __init__(self, input_buffer: np.ndarray, output_buffer: np.ndarray,
                 playback_time: float):
        self.input_buffer = input_buffer      # (C_in, buffer_size)
        self.output_buffer = output_buffer    # (C_out, buffer_size), mutable
        self.playback_time = playback_time


class _ScriptProcessorKernel(Kernel):
    capture_refusal = "calls its host handler on each completed buffer"

    def __init__(self, node, rc):
        self.node = node
        # the handler as planned: a callable attribute, so MixedGraphBatch
        # buckets nodes with different handlers apart (the JAX package
        # fingerprints the node by type only and shares the first lane's)
        self.handler = node._onaudioprocess
        self.bufsize = node.buffer_size
        self.cin = max(1, node._n_in)
        self.cout = max(1, node._n_out)
        self.sample_rate = rc.sample_rate
        self.block = rc.block_frames
        self.device = rc.device

    def init_state(self):
        n = self.bufsize
        f32 = dict(dtype=torch.float32, device=self.device)
        return {
            "inbuf": torch.zeros((self.cin, n), **f32),
            # two-buffer latency: the previous *processed* output plus the
            # one currently being played (reference: script_processor.rs:190)
            "outbuf": torch.zeros((self.cout, 2 * n), **f32),
        }

    def _host_process(self, chunk: torch.Tensor, frame: int) -> torch.Tensor:
        """Each instance's completed (C_in, n) buffer through the handler:
        (N, C_out, n) on the device."""
        handler = self.handler
        host = chunk.cpu().numpy()
        outs = np.zeros((host.shape[0], self.cout, self.bufsize), np.float32)
        if handler is not None:
            for i in range(host.shape[0]):
                ev = AudioProcessingEvent(host[i], outs[i],
                                          frame / self.sample_rate)
                handler(ev)
                outs[i] = np.asarray(ev.output_buffer, np.float32)
        return torch.from_numpy(outs).to(self.device)

    def process(self, scope, state, inputs, params):
        x = inputs[0]                                   # (N, C_in, B)
        B = x.shape[-1]
        n = self.bufsize
        outq = state["outbuf"]                          # (N, C_out, 2n)

        if B >= n:
            # blocks are buffer-aligned: every buffer completes within this
            # block, so process the block's own chunks; the two-buffer
            # latency comes from the carried output queue
            assert B % n == 0, "block must align with buffer_size"
            produced = [self._host_process(x[..., c * n:(c + 1) * n],
                                           scope.frame0_host + c * n)
                        for c in range(B // n)]
            stream = torch.cat([outq] + produced, dim=-1)
            return {"inbuf": state["inbuf"], "outbuf": stream[..., B:]}, \
                [stream[..., :B]]

        # B < n: accumulate; process when a buffer boundary is crossed.
        # Block sizes and buffer sizes are both powers of two here, so a
        # boundary falls exactly at a block edge.
        assert n % B == 0
        ext_in = torch.cat([state["inbuf"], x], dim=-1)
        phase = (scope.frame0_host // B) % (n // B)
        # play from the current (pre-shift) queue head
        out = outq[..., phase * B:(phase + 1) * B]
        if phase == n // B - 1:
            # at the cycle boundary, process the completed input buffer and
            # rotate the queue: [playing | next] -> [next | processed]
            processed = self._host_process(ext_in[..., -n:],
                                           scope.frame0_host + B - n)
            outq = torch.cat([outq[..., n:], processed], dim=-1)
        return {"inbuf": ext_in[..., B:], "outbuf": outq}, [out]


class ScriptProcessorNode(AudioNode):
    _number_of_inputs = 1
    _number_of_outputs = 1

    def __init__(self, context, buffer_size: int = 0,
                 number_of_input_channels: int = 2,
                 number_of_output_channels: int = 2):
        if buffer_size == 0:
            buffer_size = 1024
        if buffer_size not in (256, 512, 1024, 2048, 4096, 8192, 16384):
            raise IndexSizeError(
                "buffer_size must be one of 256..16384 (power of two)")
        self.buffer_size = buffer_size
        self._n_in = number_of_input_channels
        self._n_out = number_of_output_channels
        cfg = ChannelConfig(count=max(1, number_of_input_channels),
                            mode=ChannelCountMode.EXPLICIT,
                            interpretation=ChannelInterpretation.SPEAKERS)
        super().__init__(context, channel_config=cfg)
        self._onaudioprocess = None

    def set_onaudioprocess(self, handler):
        """handler(event: AudioProcessingEvent) fills event.output_buffer."""
        self._onaudioprocess = handler
        self.context._invalidate_graph_cache()

    def block_constraint(self):
        return "pow2"

    def output_channel_count(self, input_counts):
        return [max(1, self._n_out)]

    def make_kernel(self, render_ctx):
        return _ScriptProcessorKernel(self, render_ctx)
