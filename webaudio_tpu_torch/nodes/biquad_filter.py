"""BiquadFilterNode: 8 second-order filter types.

reference: src/node/biquad_filter.rs.  Coefficient formulas are the spec's
(biquad_filter.rs:40-375, f64).  Execution strategy (see ops/recurrence.py):

- constant params (the common case): the biquad is LTI, so it runs as a
  truncated-impulse-response FFT convolution, error bounded by the IR tail
  (~1e-7 relative);
- automated (a-rate) params: per-sample coefficients computed vectorized
  (the reference recomputes them per sample too, biquad_filter.rs:834-855),
  then a log-depth f64 scan for the AR(2) recurrence.

Ported from `webaudio_tpu/nodes/biquad_filter.py`.  Both paths take a
leading instance axis: the LTI path keeps one FDL state per instance
against IR spectra shared by all (or one per instance, stacked by
MixedGraphBatch); the a-rate path computes coefficients from (N, 1, B)
param rows and scans (N, C, B) in f64.
"""

from __future__ import annotations

import math
from enum import Enum

import numpy as np
import torch

from ..constants import InvalidAccessError
from ..graph.compiler import Kernel
from ..ops import fft_conv, recurrence
from ..param import AudioParamDescriptor, AutomationRate
from .audio_node import AudioNode, AudioNodeOptions


class BiquadFilterType(str, Enum):
    LOWPASS = "lowpass"
    HIGHPASS = "highpass"
    BANDPASS = "bandpass"
    NOTCH = "notch"
    ALLPASS = "allpass"
    PEAKING = "peaking"
    LOWSHELF = "lowshelf"
    HIGHSHELF = "highshelf"


SQRT_2 = math.sqrt(2.0)


class _TorchOps:
    """The numpy names `_coefs_generic` calls, over torch tensors."""
    clip = staticmethod(torch.clip)
    sin = staticmethod(torch.sin)
    cos = staticmethod(torch.cos)
    sqrt = staticmethod(torch.sqrt)
    power = staticmethod(torch.pow)
    where = staticmethod(torch.where)
    ones_like = staticmethod(torch.ones_like)
    zeros_like = staticmethod(torch.zeros_like)
    exp2 = staticmethod(torch.exp2)


def _np_coefs(filter_type, sample_rate, f0, gain, q):
    """Host-side f64 coefficient computation, one (b0,b1,b2,a1,a2) tuple.
    reference: biquad_filter.rs:40-375 (formulas preserved)."""
    coefs = _coefs_generic(np, filter_type, sample_rate, np.float64(f0),
                           np.float64(gain), np.float64(q))
    return tuple(float(c) for c in coefs)


def _coefs_generic(xp, filter_type, sample_rate, f0, gain, q):
    """Coefficient math over numpy arrays or torch tensors (xp = np or
    _TorchOps; vectorized for a-rate).

    Branchless: every special case from the reference's match arms is a
    `where` select.  Returns (b0, b1, b2, a1, a2), already normalized by a0.
    """
    nyquist = sample_rate / 2.0
    w = xp.clip(f0 / nyquist, 0.0, 1.0)  # normalized frequency in [0, 1]
    w0 = np.pi * w
    sin_w0 = xp.sin(w0)
    cos_w0 = xp.cos(w0)
    t = filter_type

    def norm(b0, b1, b2, a0, a1, a2):
        inv = 1.0 / a0
        return (b0 * inv, b1 * inv, b2 * inv, a1 * inv, a2 * inv)

    def select(cond, tup_true, tup_false):
        return tuple(xp.where(cond, a, b) for a, b in zip(tup_true, tup_false))

    ident = (xp.ones_like(w), xp.zeros_like(w), xp.zeros_like(w),
             xp.zeros_like(w), xp.zeros_like(w))
    silent = (xp.zeros_like(w),) + ident[1:]

    if t in (BiquadFilterType.LOWPASS, BiquadFilterType.HIGHPASS):
        alpha = sin_w0 / (2.0 * xp.power(10.0, q / 20.0))  # Q is in dB here
        if t == BiquadFilterType.LOWPASS:
            beta = (1.0 - cos_w0) / 2.0
            main = norm(beta, 2.0 * beta, beta, 1.0 + alpha, -2.0 * cos_w0,
                        1.0 - alpha)
            return select(w == 1.0, ident, main)
        beta = (1.0 + cos_w0) / 2.0
        main = norm(beta, -2.0 * beta, beta, 1.0 + alpha, -2.0 * cos_w0,
                    1.0 - alpha)
        out = select(w == 1.0, silent, main)
        return select(w == 0.0, ident, out)

    if t in (BiquadFilterType.BANDPASS, BiquadFilterType.NOTCH,
             BiquadFilterType.ALLPASS):
        safe_q = xp.where(q > 0.0, q, xp.ones_like(q))
        alpha = sin_w0 / (2.0 * safe_q)
        a0 = 1.0 + alpha
        a1 = -2.0 * cos_w0
        a2 = 1.0 - alpha
        if t == BiquadFilterType.BANDPASS:
            main = norm(alpha, xp.zeros_like(w), -alpha, a0, a1, a2)
            out = select(q > 0.0, main, ident)
            return select((w > 0.0) & (w < 1.0), out, silent)
        if t == BiquadFilterType.NOTCH:
            main = norm(xp.ones_like(w), -2.0 * cos_w0, xp.ones_like(w),
                        a0, a1, a2)
            out = select(q > 0.0, main, silent)
            return select((w > 0.0) & (w < 1.0), out, ident)
        # allpass
        main = norm(1.0 - alpha, -2.0 * cos_w0, 1.0 + alpha, a0, a1, a2)
        neg = (-xp.ones_like(w),) + ident[1:]
        out = select(q > 0.0, main, neg)
        return select((w > 0.0) & (w < 1.0), out, ident)

    A = xp.power(10.0, gain / 40.0)

    if t == BiquadFilterType.PEAKING:
        safe_q = xp.where(q > 0.0, q, xp.ones_like(q))
        alpha = sin_w0 / (2.0 * safe_q)
        main = norm(1.0 + alpha * A, -2.0 * cos_w0, 1.0 - alpha * A,
                    1.0 + alpha / A, -2.0 * cos_w0, 1.0 - alpha / A)
        aa = (A * A,) + ident[1:]
        out = select(q > 0.0, main, aa)
        return select((w > 0.0) & (w < 1.0), out, ident)

    # shelves (S fixed at 1 -> alpha_s = sin(w0)/2 * sqrt(2))
    alpha_s = sin_w0 / 2.0 * SQRT_2
    two_asq = 2.0 * alpha_s * xp.sqrt(A)
    ap1 = A + 1.0
    am1 = A - 1.0
    aa = (A * A,) + ident[1:]
    if t == BiquadFilterType.LOWSHELF:
        main = norm(
            A * (ap1 - am1 * cos_w0 + two_asq),
            2.0 * A * (am1 - ap1 * cos_w0),
            A * (ap1 - am1 * cos_w0 - two_asq),
            ap1 + am1 * cos_w0 + two_asq,
            -2.0 * (am1 + ap1 * cos_w0),
            ap1 + am1 * cos_w0 - two_asq)
        out = select(w == 1.0, aa, main)
        return select(w == 0.0, ident, out)
    if t == BiquadFilterType.HIGHSHELF:
        main = norm(
            A * (ap1 + am1 * cos_w0 + two_asq),
            -2.0 * A * (am1 + ap1 * cos_w0),
            A * (ap1 + am1 * cos_w0 - two_asq),
            ap1 - am1 * cos_w0 + two_asq,
            2.0 * (am1 - ap1 * cos_w0),
            ap1 - am1 * cos_w0 - two_asq)
        out = select(w == 1.0, ident, main)
        return select(w > 0.0, out, aa)
    raise AssertionError(t)


def _computed_freq(freq, detune, xp=np):
    return freq * xp.exp2(detune / 1200.0)


class _BiquadLTIKernel(Kernel):
    """Constant-coefficient path: truncated IR + partitioned convolution."""

    def __init__(self, coefs, channels: int, block: int, device):
        b0, b1, b2, a1, a2 = coefs
        h = recurrence.iir_impulse_response([b0, b1, b2], [1.0, a1, a2])
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


class _BiquadARateKernel(Kernel):
    """Automated-coefficient path: vectorized coefs + f64 log-depth scan."""

    def __init__(self, filter_type, channels: int, sample_rate: float, device):
        self.filter_type = filter_type
        self.channels = channels
        self.sample_rate = sample_rate
        self.device = device

    def init_state(self):
        # per-channel [x1, x2, y1, y2] (reference: biquad_filter.rs:857)
        return {"xy": torch.zeros((self.channels, 4), dtype=torch.float32,
                                  device=self.device)}

    def process(self, scope, state, inputs, params):
        x = inputs[0]                                   # (N, C, B)
        f = _computed_freq(params["frequency"], params["detune"], _TorchOps)
        B = x.shape[-1]
        coefs = _coefs_generic(_TorchOps, self.filter_type, self.sample_rate,
                               f, params["gain"], params["q"])
        # each coefficient is () or (N, 1, B); give them one shape
        shape = torch.broadcast_shapes(*(c.shape for c in coefs))
        b0, b1, b2, a1, a2 = [torch.broadcast_to(c, shape) for c in coefs]
        xy = state["xy"]                                # (N, C, 4)
        frc = recurrence.biquad_forcing(
            x, b0, b1, b2, xy[..., 0:1], xy[..., 1:2])  # (N, C, B)
        # the AR(2) scan runs in f64: resonant poles amplify the f32
        # rounding of the log-depth composition above the 1e-4 deviation
        # budget (the reference uses f64 state too, biquad_filter.rs:857-896)
        y = recurrence.recurrence_2nd_order(
            a1.double(), a2.double(), frc.double(),
            xy[..., 2:3].double(), xy[..., 3:4].double())
        new_xy = torch.stack(
            [x[..., -1], x[..., -2] if B >= 2 else xy[..., 0],
             y[..., -1].float(), y[..., -2].float() if B >= 2 else xy[..., 2]],
            dim=-1)
        return {"xy": new_xy}, [y.float()]


class BiquadFilterNode(AudioNode):
    # block-size hint: partitioned-FFT kernels want blocks with a large
    # power-of-two factor (see graph/compiler.py)
    wants_pow2_partitions = True
    _number_of_inputs = 1
    _number_of_outputs = 1

    def __init__(self, context, type: str = "lowpass", frequency: float = 350.0,
                 detune: float = 0.0, q: float = 1.0, gain: float = 0.0,
                 **options):
        super().__init__(context,
                         options=AudioNodeOptions(**options) if options else None)
        fs = context.sample_rate
        fmax = 3.4028235e38
        self.frequency = self._register_param(
            "frequency", AudioParamDescriptor(
                name="frequency", automation_rate=AutomationRate.A,
                default_value=350.0, min_value=0.0, max_value=fs / 2))
        self.detune = self._register_param(
            "detune", AudioParamDescriptor(
                name="detune", automation_rate=AutomationRate.A,
                default_value=0.0, min_value=-fmax, max_value=fmax))
        self.q = self._register_param(
            "q", AudioParamDescriptor(
                name="q", automation_rate=AutomationRate.A,
                default_value=1.0, min_value=-fmax, max_value=fmax))
        self.gain = self._register_param(
            "gain", AudioParamDescriptor(
                name="gain", automation_rate=AutomationRate.A,
                default_value=0.0, min_value=-fmax, max_value=fmax))
        if frequency != 350.0:
            self.frequency.set_value(frequency)
        if detune != 0.0:
            self.detune.set_value(detune)
        if q != 1.0:
            self.q.set_value(q)
        if gain != 0.0:
            self.gain.set_value(gain)
        self._type = BiquadFilterType(type)

    @property
    def type(self) -> BiquadFilterType:
        return self._type

    @type.setter
    def type(self, t):
        self._type = BiquadFilterType(t)
        self.context._invalidate_graph_cache()

    def get_frequency_response(self, frequency_hz, mag_response, phase_response):
        """Transfer-function evaluation on the control side
        (reference: biquad_filter.rs:670-743).

        The normalized frequency rounds through f32 before the f64
        z-transform (freq / nyquist is f32 upstream), and the polynomials
        evaluate in Horner form b0 + (b1 + b2*z)*z, as the reference does."""
        fs = self.context.sample_rate
        if not (len(frequency_hz) == len(mag_response)
                == len(phase_response)):
            raise InvalidAccessError(
                "Parameter lengths must match")
        b0, b1, b2, a1, a2 = _np_coefs(
            self._type, fs,
            _computed_freq(self.frequency.value, self.detune.value),
            self.gain.value, self.q.value)
        freqs = np.asarray(frequency_hz, dtype=np.float32)
        nyquist = np.float32(fs) / np.float32(2.0)
        valid = (freqs >= 0) & (freqs <= nyquist)
        f = (freqs / nyquist).astype(np.float32).astype(np.float64)
        omega = -np.pi * f
        z = np.cos(omega) + 1j * np.sin(omega)
        num = b0 + (b1 + b2 * z) * z
        den = 1.0 + (a1 + a2 * z) * z
        h = num / den
        mag_response[:] = np.where(valid, np.abs(h), np.nan).astype(np.float32)
        phase_response[:] = np.where(valid, np.angle(h), np.nan).astype(np.float32)

    def make_kernel(self, render_ctx):
        c = max(1, render_ctx.input_channel_counts[0])
        plans = render_ctx.param_plans
        if all(plans[p].is_constant for p in ("frequency", "detune", "q", "gain")):
            f = _computed_freq(
                np.float64(np.float32(plans["frequency"].scalar)),
                np.float64(np.float32(plans["detune"].scalar)))
            coefs = _np_coefs(self._type, render_ctx.sample_rate, f,
                              plans["gain"].scalar, plans["q"].scalar)
            return _BiquadLTIKernel(coefs, c, render_ctx.block_frames,
                                    render_ctx.device)
        return _BiquadARateKernel(self._type, c, render_ctx.sample_rate,
                                  render_ctx.device)
