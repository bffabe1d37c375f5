"""AnalyserNode: time/frequency domain analysis taps.

reference: src/node/analyser.rs + src/analysis.rs.  Ported from
`webaudio_tpu/nodes/analyser.py`.  The render half is a passthrough that
records the mono downmix of its input into a ring of the last
MAX_FFT_SIZE samples, a (N, 32768) tensor carried in the block walk's
state on the render's device.  The control half stays on the host, in
numpy, as in the JAX package: Blackman-windowed rFFTs with 0.8
smoothing over time and dB conversion (analysis.rs:255-400), computed from
the ring the offline render publishes after each suspend segment, so a
`suspend_sync` callback reads the live ring; in a running AudioContext
each read copies the live ring from the render states
(`probe_node_state`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import IndexSizeError
from ..graph.compiler import Kernel
from ..ops.mixing import ChannelInterpretation, mix
from .audio_node import AudioNode, AudioNodeOptions

DEFAULT_SMOOTHING_TIME_CONSTANT = 0.8
DEFAULT_MIN_DECIBELS = -100.0
DEFAULT_MAX_DECIBELS = -30.0
DEFAULT_FFT_SIZE = 2048
MIN_FFT_SIZE = 32
MAX_FFT_SIZE = 32768


def generate_blackman(size: int) -> np.ndarray:
    """reference: analysis.rs:14-24 (f32 math)."""
    alpha = np.float32(0.16)
    a0 = (1.0 - alpha) / 2.0
    a1 = np.float32(0.5)
    a2 = alpha / 2.0
    i = np.arange(size, dtype=np.float32)
    return (a0 - a1 * np.cos(2 * np.pi * i / size)
            + a2 * np.cos(4 * np.pi * i / size)).astype(np.float32)


class _AnalyserKernel(Kernel):
    def __init__(self, channels: int, device):
        self.channels = channels
        self.device = device

    def tail_frames(self):
        return MAX_FFT_SIZE

    def init_state(self):
        return {"ring": torch.zeros((MAX_FFT_SIZE,), dtype=torch.float32,
                                    device=self.device)}

    def process(self, scope, state, inputs, params):
        x = inputs[0]                                      # (N, C, B)
        mono = mix(x, 1, ChannelInterpretation.SPEAKERS)[:, 0]
        B = mono.shape[-1]
        if B >= MAX_FFT_SIZE:
            ring = mono[:, -MAX_FFT_SIZE:]
        else:
            ring = torch.cat([state["ring"][:, B:], mono], dim=-1)
        # passthrough output (reference: analyser.rs:261-291)
        return {"ring": ring}, [x]


class AnalyserNode(AudioNode):
    _number_of_inputs = 1
    _number_of_outputs = 1

    def __init__(self, context, fft_size: int = DEFAULT_FFT_SIZE,
                 max_decibels: float = DEFAULT_MAX_DECIBELS,
                 min_decibels: float = DEFAULT_MIN_DECIBELS,
                 smoothing_time_constant: float = DEFAULT_SMOOTHING_TIME_CONSTANT,
                 **options):
        super().__init__(context,
                         options=AudioNodeOptions(**options) if options else None)
        self._fft_size = 0
        self.set_fft_size(fft_size)
        self._min_decibels = DEFAULT_MIN_DECIBELS
        self._max_decibels = DEFAULT_MAX_DECIBELS
        self.set_decibels(min_decibels, max_decibels)
        self._smoothing = 0.0
        self.set_smoothing_time_constant(smoothing_time_constant)
        self._ring = np.zeros(MAX_FFT_SIZE, np.float32)
        self._last_fft_output = np.zeros(MAX_FFT_SIZE // 2, np.float32)
        self._last_fft_time = -1.0
        self._blackman = generate_blackman(self._fft_size)

    # --- attributes (reference: analysis.rs:202-253) ----------------------
    @property
    def fft_size(self) -> int:
        return self._fft_size

    @fft_size.setter
    def fft_size(self, v: int):
        self.set_fft_size(v)

    def set_fft_size(self, v: int):
        v = int(v)
        if v & (v - 1) != 0 or not (MIN_FFT_SIZE <= v <= MAX_FFT_SIZE):
            raise IndexSizeError(
                f"fft size must be a power of two in [{MIN_FFT_SIZE}, "
                f"{MAX_FFT_SIZE}], got {v}")
        if v != self._fft_size:
            self._fft_size = v
            self._blackman = generate_blackman(v)

    @property
    def frequency_bin_count(self) -> int:
        return self._fft_size // 2

    def set_decibels(self, min_db: float, max_db: float):
        """Set both bounds together so a valid pair is never rejected by an
        invalid intermediate combination (reference: analysis.rs:244-250)."""
        if not min_db < max_db:
            raise IndexSizeError("min decibels must be < max decibels")
        self._min_decibels = float(min_db)
        self._max_decibels = float(max_db)

    @property
    def min_decibels(self) -> float:
        return self._min_decibels

    def set_min_decibels(self, v: float):
        if v >= self._max_decibels:
            raise IndexSizeError("min decibels must be < max decibels")
        self._min_decibels = float(v)

    @property
    def max_decibels(self) -> float:
        return self._max_decibels

    def set_max_decibels(self, v: float):
        if v <= self._min_decibels:
            raise IndexSizeError("max decibels must be > min decibels")
        self._max_decibels = float(v)

    @property
    def smoothing_time_constant(self) -> float:
        return self._smoothing

    def set_smoothing_time_constant(self, v: float):
        if not (0.0 <= v <= 1.0):
            raise IndexSizeError(
                f"smoothing time constant {v} outside [0, 1]")
        self._smoothing = float(v)

    # --- data access (reference: analysis.rs:255-400) ----------------------
    def get_float_time_domain_data(self, dst: np.ndarray):
        self._refresh_ring()
        n = min(len(dst), self._fft_size)
        dst[:n] = self._ring[MAX_FFT_SIZE - self._fft_size:
                             MAX_FFT_SIZE - self._fft_size + n]

    def get_byte_time_domain_data(self, dst: np.ndarray):
        tmp = np.zeros(len(dst), np.float32)
        self.get_float_time_domain_data(tmp)
        dst[:] = np.clip(128.0 * (1.0 + tmp), 0.0, 255.0).astype(np.uint8)

    def _compute_fft(self):
        n = self._fft_size
        data = self._ring[MAX_FFT_SIZE - n:] * self._blackman
        spectrum = np.fft.rfft(data.astype(np.float32))
        norm = (np.abs(spectrum[: n // 2]) / n).astype(np.float32)
        s = np.float32(self._smoothing)
        out = s * self._last_fft_output[: n // 2] + (1.0 - s) * norm
        self._last_fft_output[: n // 2] = np.where(np.isfinite(out), out, 0.0)

    def _refresh_ring(self):
        probe = getattr(self.context, "probe_node_state", None)
        if probe is not None:
            st = probe(self)
            if st is not None:
                self._ring = st["ring"]

    def _maybe_fft(self):
        self._refresh_ring()
        t = self.context.current_time
        if t != self._last_fft_time:
            self._compute_fft()
            self._last_fft_time = t

    def get_float_frequency_data(self, dst: np.ndarray):
        self._maybe_fft()
        n = min(len(dst), self.frequency_bin_count)
        with np.errstate(divide="ignore"):
            dst[:n] = 20.0 * np.log10(self._last_fft_output[:n])

    def get_byte_frequency_data(self, dst: np.ndarray):
        self._maybe_fft()
        n = min(len(dst), self.frequency_bin_count)
        with np.errstate(divide="ignore"):
            db = 20.0 * np.log10(self._last_fft_output[:n])
        scaled = 255.0 / (self._max_decibels - self._min_decibels) * \
            (db - self._min_decibels)
        dst[:n] = np.clip(scaled, 0.0, 255.0).astype(np.uint8)

    # --- engine hooks ------------------------------------------------------
    def output_channel_count(self, input_counts):
        return [max(1, input_counts[0])]

    def make_kernel(self, render_ctx):
        return _AnalyserKernel(max(1, render_ctx.input_channel_counts[0]),
                               render_ctx.device)

    def _on_render_state(self, state):
        self._ring = state["ring"].cpu().numpy()
