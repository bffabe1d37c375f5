"""IIRFilterNode: arbitrary-order (<= 20) IIR filter.

reference: src/node/iir_filter.rs (Direct Form II-transposed per channel in
f64, iir_filter.rs:386-410).  The coefficients are construction-time
constants, so the filter is always LTI: it runs as a truncated impulse
response (ops/recurrence.py::iir_impulse_response, scipy on the host)
through the partitioned FFT convolution (ops/fft_conv.py), as the LTI
biquad does.  Ported from `webaudio_tpu/nodes/iir_filter.py`.
"""

from __future__ import annotations

import numpy as np

from ..constants import (InvalidAccessError, InvalidStateError,
                         NotSupportedError)
from ..graph.compiler import Kernel
from ..ops import fft_conv, recurrence
from .audio_node import AudioNode, AudioNodeOptions

MAX_IIR_COEFFS_LEN = 20  # reference: iir_filter.rs:16


class _IIRKernel(Kernel):
    def __init__(self, b, a, channels: int, block: int, device):
        h = recurrence.iir_impulse_response(b, a)
        self.partition = fft_conv.choose_partition(block)
        self.h_spectra = fft_conv.partition_ir(h, self.partition)
        self.k = self.h_spectra.shape[1]
        self.channels = channels
        self.device = device

    def resources(self):
        return {"h": self.h_spectra}

    def tail_frames(self):
        return (self.k + 1) * self.partition

    def init_state(self):
        return fft_conv.init_state(self.channels, self.k, self.partition,
                                   self.device)

    def process(self, scope, state, inputs, params):
        state, y = fft_conv.partitioned_conv_block(
            state, inputs[0], scope.node_resources["h"], self.partition)
        return state, [y]


class IIRFilterNode(AudioNode):
    # block-size hint: partitioned-FFT kernels want blocks with a large
    # power-of-two factor (see graph/compiler.py)
    wants_pow2_partitions = True
    _number_of_inputs = 1
    _number_of_outputs = 1

    def __init__(self, context, feedforward, feedback, **options):
        b = np.asarray(feedforward, dtype=np.float64)
        a = np.asarray(feedback, dtype=np.float64)
        # validation (reference: iir_filter.rs:120-170)
        for name, c in (("feedforward", b), ("feedback", a)):
            if len(c) == 0 or len(c) > MAX_IIR_COEFFS_LEN:
                raise NotSupportedError(
                    f"{name} must have 1..={MAX_IIR_COEFFS_LEN} coefficients")
            if not np.all(np.isfinite(c)):
                raise InvalidStateError(f"{name} contains non-finite values")
        if np.all(b == 0.0):
            raise InvalidStateError("feedforward values cannot all be zero")
        if a[0] == 0.0:
            raise InvalidStateError("first feedback coefficient cannot be zero")
        self._b = b
        self._a = a
        super().__init__(context,
                         options=AudioNodeOptions(**options) if options else None)

    def get_frequency_response(self, frequency_hz, mag_response, phase_response):
        """reference: iir_filter.rs:221-265."""
        if not (len(frequency_hz) == len(mag_response)
                == len(phase_response)):
            raise InvalidAccessError(
                "frequency_hz, mag_response and phase_response must have "
                "the same length")
        fs = self.context.sample_rate
        freqs = np.asarray(frequency_hz, dtype=np.float64)
        valid = (freqs >= 0) & (freqs <= fs / 2)
        z = np.exp(-1j * 2 * np.pi * freqs / fs)
        num = np.zeros_like(z)
        den = np.zeros_like(z)
        zp = np.ones_like(z)
        for i in range(max(len(self._b), len(self._a))):
            if i < len(self._b):
                num = num + self._b[i] * zp
            if i < len(self._a):
                den = den + self._a[i] * zp
            zp = zp * z
        h = num / den
        mag_response[:] = np.where(valid, np.abs(h), np.nan).astype(np.float32)
        phase_response[:] = np.where(valid, np.angle(h), np.nan).astype(np.float32)

    def make_kernel(self, render_ctx):
        c = max(1, render_ctx.input_channel_counts[0])
        return _IIRKernel(self._b, self._a, c, render_ctx.block_frames,
                          render_ctx.device)
