"""ConvolverNode: partitioned FFT convolution reverb.

reference: src/node/convolver.rs.  The `fft-convolver` crate becomes the
engine's frequency-domain delay line (ops/fft_conv.py, cuFFT on the card);
IR spectra are precomputed host-side with the equal-power normalization
scale (convolver.rs:16-50) and staged once.  Channel configurations
1/2/4-channel IR x mono/stereo input, including the true-stereo 4-channel
mixdown, follow convolver.rs:378-487.  Ported from
`webaudio_tpu/nodes/convolver.py`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..buffer import AudioBuffer
from ..constants import NotSupportedError
from ..graph.compiler import Kernel
from ..ops import fft_conv
from ..ops.mixing import ChannelCountMode
from .audio_node import AudioNode, ChannelConfig


def normalize_buffer_scale(buffer: AudioBuffer) -> float:
    """Equal-power normalization scale (reference: convolver.rs:16-50)."""
    gain_calibration = 0.00125
    gain_calibration_sample_rate = 44100.0
    min_power = 0.000125
    data = buffer.to_array()
    power = np.float32(np.sum(data.astype(np.float32) ** 2))
    if data.size:
        power = np.sqrt(power / np.float32(data.size))
    else:
        power = np.float32(0.0)  # zero-length IR -> min_power clamp
    if not np.isfinite(power) or power < min_power:
        power = np.float32(min_power)
    scale = 1.0 / power
    scale *= gain_calibration
    scale *= gain_calibration_sample_rate / buffer.sample_rate
    return float(scale)


class _ConvolverKernel(Kernel):
    def __init__(self, node: "ConvolverNode", rc):
        buf = node._buffer
        self.has_ir = buf is not None
        self.device = rc.device
        if not self.has_ir:
            return
        scale = normalize_buffer_scale(buf) if node._normalize else 1.0
        ir = buf.to_array() * np.float32(scale)   # (C_ir, L)
        self.ir_channels = ir.shape[0]
        self.partition = fft_conv.choose_partition(rc.block_frames)
        # one convolver per channel combination; mono IR duplicated for
        # stereo input (reference: convolver.rs:288-300)
        n_conv = max(2, self.ir_channels)
        rows = [ir[min(i, self.ir_channels - 1)] for i in range(n_conv)]
        self.h_spectra = fft_conv.partition_ir(np.stack(rows), self.partition)
        self.k = self.h_spectra.shape[1]
        self.n_conv = n_conv

    def resources(self):
        return {"h": self.h_spectra} if self.has_ir else None

    def tail_frames(self):
        return (self.k + 1) * self.partition if self.has_ir else 0

    def init_state(self):
        if not self.has_ir:
            return None
        return fft_conv.init_state(self.n_conv, self.k, self.partition,
                                   self.device)

    def process(self, scope, state, inputs, params):
        x = inputs[0]                                   # (N, C_in, B)
        if not self.has_ir:
            # passthrough (reference: convolver.rs:368-372)
            return state, [x]
        cin = x.shape[1]
        # route input channels to the convolver lanes
        # (reference: convolver.rs:378-487), each lane a copy of one input
        # channel: input channel c feeds `rep` lanes in a row
        n, _, B = x.shape
        if self.ir_channels == 4:
            src, rep = (1, 4) if cin == 1 else (2, 2)
        elif cin == 1 and self.ir_channels == 1:
            src, rep = 1, 1
        else:
            src, rep = (1, 2) if cin == 1 else (2, 1)
        lanes = x[:, :src]
        if rep > 1:
            lanes = lanes[:, :, None].expand(n, src, rep, B).reshape(
                n, src * rep, B)
        n_lanes = lanes.shape[1]
        h = scope.node_resources["h"][:, :n_lanes]      # (1 or N, L, K, P+1)
        st = state
        if n_lanes != self.n_conv:
            st = {k: v[:, :n_lanes] for k, v in state.items()}
        st, y = fft_conv.partitioned_conv_block(st, lanes, h, self.partition)
        if n_lanes != self.n_conv:
            st = {k: torch.cat([v, state[k][:, n_lanes:]], dim=1)
                  for k, v in st.items()}
        if self.ir_channels == 4:
            y = torch.stack([y[:, 0] + y[:, 2], y[:, 1] + y[:, 3]], dim=1)
        return st, [y]


class ConvolverNode(AudioNode):
    # block-size hint: partitioned-FFT kernels want blocks with a large
    # power-of-two factor (see graph/compiler.py)
    wants_pow2_partitions = True
    _number_of_inputs = 1
    _number_of_outputs = 1

    def __init__(self, context, buffer: AudioBuffer | None = None,
                 disable_normalization: bool = False, **options):
        cfg = ChannelConfig(count=2, mode=ChannelCountMode.CLAMPED_MAX)
        super().__init__(context, channel_config=cfg)
        self._normalize = not disable_normalization
        self._buffer = None
        if buffer is not None:
            self.set_buffer(buffer)

    @property
    def buffer(self) -> AudioBuffer | None:
        return self._buffer

    @buffer.setter
    def buffer(self, buf: AudioBuffer):
        self.set_buffer(buf)

    def set_buffer(self, buffer: AudioBuffer):
        """reference: convolver.rs:255-317."""
        if buffer.sample_rate != self.context.sample_rate:
            raise NotSupportedError(
                "sample rate of the convolution buffer must match the context")
        if buffer.number_of_channels not in (1, 2, 4):
            raise NotSupportedError(
                "the convolution buffer must have 1, 2 or 4 channels")
        self._buffer = buffer
        self.context._invalidate_graph_cache()

    @property
    def normalize(self) -> bool:
        return self._normalize

    @normalize.setter
    def normalize(self, v: bool):
        self._normalize = bool(v)

    def _validate_channel_count(self, count: int):
        if count > 2:
            raise NotSupportedError(
                "ConvolverNode channel count cannot be greater than two")

    def _validate_channel_count_mode(self, mode: ChannelCountMode):
        if mode == ChannelCountMode.MAX:
            raise NotSupportedError(
                "ConvolverNode channel count mode cannot be set to max")

    def output_channel_count(self, input_counts):
        if self._buffer is None:
            return [input_counts[0] if input_counts else 1]
        if self._buffer.number_of_channels >= 2:
            return [2]
        return [2 if input_counts and input_counts[0] >= 2 else 1]

    def make_kernel(self, render_ctx):
        return _ConvolverKernel(self, render_ctx)
