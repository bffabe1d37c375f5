"""DelayNode: fractional delay line, the graph's cycle breaker.

reference: src/node/delay.rs.  The reference splits the node into a
DelayWriter and DelayReader sharing a ring buffer of render quanta
(delay.rs:376-684); when the node sits in a cycle the writer->reader edge is
dropped and the delay clamps to >= one render quantum (delay.rs:535-542,
699-703).  Ported from `webaudio_tpu/nodes/delay.py`.

The ring is an (N, C, R) tensor in the block state, R a multiple of the
block >= max_delay + block + 1.  The writer copies the block in at
frame0 mod R (out of place: the state of the block before stays as it
was).  A constant delay's read offset and lerp weights are host numbers,
computed once when the kernel is built, so its reader is two contiguous
reads across the wrap and a lerp, with no device sync; an automated or
audio-driven delay reads per-sample f64 positions with a gather.  Where
the block's position is device data (a captured walk), the writer is one
scatter at (frame0 + arange(B)) mod R and the constant reader one gather
of B + 1 consecutive ring positions: neither reads the position on the
host.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import RENDER_QUANTUM_SIZE, NotSupportedError
from ..graph.compiler import Kernel
from ..param import AudioParamDescriptor, AutomationRate
from .audio_node import AudioNode, AudioNodeOptions


def _read(ring: torch.Tensor, start: int, frames: int) -> torch.Tensor:
    """ring[..., start:start+frames] with the ring's wrap (start in [0, R))."""
    R = ring.shape[-1]
    if start + frames <= R:
        return ring[..., start:start + frames]
    return torch.cat([ring[..., start:], ring[..., :start + frames - R]], -1)


class _DelayKernel(Kernel):
    def __init__(self, channels: int, ring_frames: int, sample_rate: float,
                 in_cycle: bool, const_delay, device):
        self.channels = channels
        self.R = ring_frames
        self.sample_rate = sample_rate
        self.in_cycle = in_cycle
        self.device = device
        # a constant delay_time (the param plan's scalar, rounded to f32 as
        # the walk's constant is): read offset and lerp weights on the host,
        # in the JAX package's arithmetic (f64 positions, f32 weights)
        self.const_read = None
        if const_delay is not None:
            delay = float(const_delay)
            if in_cycle:
                delay = max(delay, RENDER_QUANTUM_SIZE / sample_rate)
            num = delay * sample_rate
            n_int = math.floor(num)
            k0 = np.float32(num - n_int)                # fractional part
            # an integer delay*fs reads exactly at t - n
            shift = n_int if k0 == 0.0 else n_int + 1
            ks = np.float32(0.0) if k0 == 0.0 else np.float32(1.0) - k0
            self.const_read = (shift, float(np.float32(1.0) - ks), float(ks))

        self._offs = {}          # block frames -> arange(B + 1) - shift

    def _offsets(self, frames: int, shift: int, device) -> torch.Tensor:
        """arange(frames + 1) - shift on the device, made at the block
        walked eagerly before a capture and reused by the graph."""
        offs = self._offs.get(frames)
        if offs is None:
            offs = self._offs[frames] = torch.arange(
                -shift, frames + 1 - shift, dtype=torch.int64, device=device)
        return offs

    def tail_frames(self):
        return None if self.in_cycle else self.R

    def init_state(self):
        return {"ring": torch.zeros((self.channels, self.R),
                                    dtype=torch.float32, device=self.device)}

    # --- writer (reference: delay.rs:430-466) --------------------------
    def process_writer(self, scope, state, inputs, params):
        x = inputs[0]                                       # (N, C, B)
        ring = state["ring"]
        if not scope.eager:
            pos = torch.remainder(scope.t_idx, self.R)  # wraps at the end
            return {"ring": ring.index_copy(-1, pos, x)}
        pos = scope.frame0_host % self.R
        B = x.shape[-1]
        head = min(B, self.R - pos)
        ring = ring.slice_scatter(x[..., :head], dim=-1, start=pos,
                                  end=pos + head)
        if head < B:                # a block that crosses the ring's end
            ring = ring.slice_scatter(x[..., head:], dim=-1, start=0,
                                      end=B - head)
        return {"ring": ring}

    # --- reader (reference: delay.rs:516-688) ---------------------------
    def process_reader(self, scope, state, params):
        ring = state["ring"]                                # (N, C, R)
        delay = params["delay_time"]
        B = scope.frames
        if delay.dim() == 0:
            # the constant delay: consecutive read positions, two
            # contiguous reads of the ring and a lerp with host weights
            shift, wa, wb = self.const_read
            if scope.eager:
                start = scope.frame0_host - shift
                a = _read(ring, start % self.R, B)
                b = _read(ring, (start + 1) % self.R, B)
                out = a * wa + b * wb
                if start < 0:
                    # reads from before the first written sample are silent
                    prev_i = start + torch.arange(B, device=ring.device)
                    out = torch.where(prev_i >= 0, out, torch.where(
                        prev_i + 1 >= 0, b * wb, 0.0))
                return state, [out]
            # the B + 1 positions frame0 - shift + e: both taps in one
            # gather (a = w[e], b = w[e + 1])
            prev = scope.frame0 + self._offsets(B, shift, ring.device)
            w = ring.index_select(-1, torch.remainder(prev, self.R))
            a, b = w[..., :B], w[..., 1:]
            bw = b * wb
            out = a * wa + bw
            # reads from before the first written sample are silent
            prev_i = prev[:B]
            return state, [torch.where(prev_i >= 0, out,
                                       bw.masked_fill(prev_i < -1, 0.0))]
        # automated or audio-driven: per-sample f64 read positions, as in
        # the reference (delay.rs:688-706); an f32 position would put an
        # exact integer delay ~1e-6 samples off and leak lerp error
        delay = delay.double()                              # (N, 1, B)
        if self.in_cycle:
            delay = delay.clamp_min(RENDER_QUANTUM_SIZE / self.sample_rate)
        pos = scope.t_idx.double() - delay * self.sample_rate
        prev = torch.floor(pos)
        k = (pos - prev).float()
        prev_i = prev.long()
        shape = ring.shape[:-1] + (B,)
        a = torch.gather(ring, -1, (prev_i % self.R).expand(shape))
        b = torch.gather(ring, -1, ((prev_i + 1) % self.R).expand(shape))
        out = (1.0 - k) * a + k * b
        # reads from before the first written sample are silent
        out = torch.where(prev_i >= 0, out,
                          torch.where(prev_i + 1 >= 0, k * b, 0.0))
        return state, [out]

    def process(self, scope, state, inputs, params):  # pragma: no cover
        raise AssertionError("DelayNode always runs as writer/reader pair")


class DelayNode(AudioNode):
    _number_of_inputs = 1
    _number_of_outputs = 1
    is_cycle_breaker = True

    def __init__(self, context, max_delay_time: float = 1.0,
                 delay_time: float = 0.0, **options):
        if not (0.0 < max_delay_time < 180.0):
            raise NotSupportedError(
                "maxDelayTime MUST be greater than zero and less than three minutes")
        self._max_delay_time = float(max_delay_time)
        super().__init__(context,
                         options=AudioNodeOptions(**options) if options else None)
        self.delay_time = self._register_param(
            "delay_time",
            AudioParamDescriptor(
                name="delay_time", automation_rate=AutomationRate.A,
                default_value=0.0, min_value=0.0, max_value=self._max_delay_time))
        if delay_time != 0.0:
            self.delay_time.set_value(delay_time)

    @property
    def max_delay_time(self) -> float:
        return self._max_delay_time

    def make_kernel(self, render_ctx):
        B = render_ctx.block_frames
        max_frames = int(math.ceil(self._max_delay_time * render_ctx.sample_rate))
        # unique mod-R addressing requires R >= max_delay + B (+1 sample for
        # the lerp neighbor), rounded up to a block multiple
        R = (-(-(max_frames + B + 1) // B)) * B
        c = max(1, render_ctx.input_channel_counts[0])
        plan = render_ctx.param_plans["delay_time"]
        const = None
        if plan.is_constant:
            p = self.delay_time
            const = float(np.float32(
                min(max(plan.scalar, p.min_value), p.max_value)))
        return _DelayKernel(c, R, render_ctx.sample_rate,
                            render_ctx.in_cycle, const, render_ctx.device)
