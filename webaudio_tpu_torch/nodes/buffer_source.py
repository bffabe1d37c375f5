"""AudioBufferSourceNode: buffer playback with resampling and looping.

reference: src/node/audio_buffer_source.rs.  The reference's per-sample
playhead state machine (audio_buffer_source.rs:625-800) becomes tensor
math over the block, on the compound rate
`playback_rate * 2^(detune/1200)`:

- a constant compound rate makes the playhead a pure function of the
  global sample index, in f64 buffer-sample units (closed form);
- an automated (k-rate) compound rate makes it an exclusive masked cumsum
  of the per-sample increments, an f32 cumsum within each quantum and f64
  sums across quanta (`_masked_cumsum_f64`), carried across blocks; the
  within-quantum cumsum runs in XLA's summation order
  (`ops/oscillator.py::cumsum_f32`), so the card, the CPU and the JAX
  package round it alike; on the card the whole block is one launch of
  `ops/playhead.py::buffer_playhead` (`csrc/buffer_playhead.cu`), whose
  contract this tensor code is;
- loop wrapping (`while bt >= loop_end: bt -= len`) is `mod` arithmetic on
  the playhead, and the cumsum's carried playhead is kept wrapped once it
  entered the loop;
- the sample fetch is one contiguous slice from a pre-tiled copy of the
  buffer when the playhead advances by exactly one buffer sample per frame
  from an integral position (the reference's fast track), and a pair-row
  gather + linear interpolation otherwise;
- WEBAUDIO_GRAIN_READ=grouped*|window reads through the grouped two-tap
  lerp kernel instead (`ops/grain_read.py::grouped_lerp`), and =gather
  forces the pair gathers, as in the JAX package.

Ported from `webaudio_tpu/nodes/buffer_source.py`.  The closed-form
playhead is shared by every instance of a batched render; the cumsum
playhead is one per instance (each instance may carry its own rate rows).
The buffer layouts are staged with a leading axis of 1 (one buffer for all
instances) or N (one per instance, `GraphBatch.override_buffer`), and the
fetch returns (1 or N, C, B).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..buffer import AudioBuffer
from ..constants import RENDER_QUANTUM_SIZE, InvalidStateError
from ..graph.compiler import Kernel
from ..ops.bufread import edge_vals, gather_lanes, gather_pairs, pair_rows
from ..ops.grain_read import EDGE_FRAC, grouped_lerp, pick_group, pick_window
from ..ops.oscillator import cumsum_f32
from ..ops.playhead import Constants, buffer_playhead
from ..param import AudioParamDescriptor, AutomationRate
from .scheduled_source import AudioScheduledSourceNode


def _floor_mod(x, y: float):
    """x mod y with the divisor's sign (`jnp.mod`): fmod is exact, then a
    nonzero remainder whose sign differs from y's is shifted by y."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def _loop_wrap(pos, ls, le, loop_len):
    """Wrap a playhead into [loop_start, loop_end) with the reference's
    `almost::equal` stickiness (audio_buffer_source.rs:694-699): a read
    whose WRAPPED position lies within sqrt(eps) of loop_end, relative to
    the two compared values (so to loop_end), snaps back to loop_start
    instead of reading the (possibly nonexistent) end sample.  The
    tolerance never scales with the unwrapped playhead: past 2^26 samples
    it would span a whole sample and misread each loop's last."""
    wrapped = ls + _floor_mod(pos - ls, loop_len)
    tol = 1.5e-8 * max(abs(le), 1.0)
    return torch.where(le - wrapped <= tol, torch.full_like(wrapped, ls), wrapped)


def _masked_cumsum_f64(values64, mask):
    """Exclusive masked cumsum over the last axis of (M, B) f64 values,
    with the f32 within-quantum / f64 across-quantum split of
    `ops/oscillator.py::accumulate_phase`.  Returns ((M, B) f64, the
    (M,) f64 totals)."""
    M, B = values64.shape
    q = RENDER_QUANTUM_SIZE
    m64 = torch.where(mask, values64, 0.0).reshape(M, B // q, q)
    m32 = m64.to(torch.float32)
    within = (cumsum_f32(m32) - m32).to(torch.float64)
    qsums = m64.sum(dim=-1)
    qoffs = torch.cumsum(qsums, dim=-1) - qsums
    total = qoffs[:, -1] + qsums[:, -1]
    return (qoffs[..., None] + within).reshape(M, B), total


class _BufferSourceKernel(Kernel):
    # data_host is only ever read through the staged-resource path
    # (data_rows/edge_vals/_read_resources), so MixedGraphBatch may bucket
    # same-shape different-content buffers together and stack them
    _fp_staged_attrs = ("data_host",)

    def __init__(self, node: "AudioBufferSourceNode", rc):
        self.sample_rate = rc.sample_rate
        self.device = rc.device
        plans = rc.param_plans
        buf = node.buffer
        self.has_buffer = buf is not None
        # a constant compound rate takes the closed-form playhead, an
        # automated one the masked cumsum (const_rate None)
        self.const_rate = None
        if plans["playback_rate"].is_constant and plans["detune"].is_constant:
            pr = np.float64(np.float32(plans["playback_rate"].scalar))
            dt_ = np.float64(np.float32(plans["detune"].scalar))
            self.const_rate = float(pr * np.exp2(dt_ / 1200.0))
        if self.has_buffer:
            self.buf_len = buf.length
            self.buf_rate = buf.sample_rate
            self.buf_duration = buf.length / buf.sample_rate
            self.data_host = buf.to_array()  # (C, L); staged via resources
        else:
            self.buf_len = 1
            self.buf_rate = rc.sample_rate
            self.buf_duration = 0.0
            self.data_host = None
        fs = rc.sample_rate
        self.start_frame, self.stop_frame = node._schedule_frames(fs)
        self.start_time = node._start_time
        self.offset = node._offset
        self.duration = node._duration
        self.loop = node.loop
        # actual loop points (reference: audio_buffer_source.rs:629-637)
        ls, le = node.loop_start, node.loop_end
        if ls >= 0.0 and le > 0.0 and ls < le:
            self.loop_start, self.loop_end = ls, le
        else:
            self.loop_start, self.loop_end = 0.0, self.buf_duration
        self.consts = self._playhead_constants()
        self._pick_read_mode(rc)

    def _playhead_constants(self) -> Constants:
        """The automated-rate playhead's constants, fixed when the plan is
        compiled: `_process_cumsum` reads them, and the card's kernel
        takes them as they are (ops/playhead.py)."""
        fs = self.sample_rate
        start_ok = self.start_frame < 2**31 - 1
        ls = self.loop_start * self.buf_rate
        le = self.loop_end * self.buf_rate
        return Constants(
            ratio=self.buf_rate / fs, fs=fs, buf_rate=self.buf_rate,
            buf_duration=self.buf_duration, offset=self.offset,
            delta=self.start_frame * (1.0 / fs) - self.start_time
            if start_ok else 0.0,
            dur_fs=self.duration * fs, loop_start=self.loop_start,
            loop_end=self.loop_end, ls=ls, le=le, loop_len=le - ls,
            tol=1.5e-8 * max(abs(le), 1.0), start_frame=self.start_frame,
            start_i=min(self.start_frame, 2**31 - 1),
            stop_i=min(self.stop_frame, 2**31 - 1), length=self.buf_len,
            loop=int(self.loop), cond_ge=int(self.offset * self.buf_rate < le))

    def _pick_read_mode(self, rc):
        """ALIGNED unit-step fast path, the reference's own fast track
        (audio_buffer_source.rs:554-624): when the playhead advances by
        exactly 1.0 buffer sample per context frame from an integral start
        position, every lerp weight is 0 and the read is contiguous modulo
        the loop wrap, so the block is one slice of a pre-tiled copy of the
        buffer.  It is taken for no loop or a whole-buffer loop; partial
        loops and every other rate keep the pair gathers.

        Under `auto` a single source keeps the gathers (its playhead is
        near-sequential); WEBAUDIO_GRAIN_READ=grouped*|window take the
        grouped two-tap lerp at the JAX package's geometry, for no loop or
        a whole-buffer loop (whose integral loop length makes the wrap a
        mod of the group start)."""
        self.read_mode = "gather"
        self.win_Qs = self.win_W = 0
        whole_loop = (self.loop and self.loop_start <= 0.0
                      and self.loop_end >= self.buf_duration - 1e-9)
        mode = os.environ.get("WEBAUDIO_GRAIN_READ", "auto")
        if mode == "gather" or self.const_rate is None or \
                not self.has_buffer or (self.loop and not whole_loop):
            return
        if mode not in ("auto", "aligned"):
            self._pick_window(mode, rc)
            return
        fs = rc.sample_rate
        step = self.const_rate * self.buf_rate / fs
        if self.start_frame < 2**31 - 1:
            delta = self.start_frame / fs - self.start_time
        else:
            delta = 0.0
        offset_eff = min(max(self.offset + delta * self.const_rate, 0.0),
                         self.buf_duration)
        if self.loop:
            offset_eff = min(offset_eff, self.loop_end)
        offset_pos = offset_eff * self.buf_rate
        if step == 1.0 and delta == 0.0 and float(offset_pos).is_integer():
            self.read_mode = "aligned"
            self.aligned_off = int(offset_pos)
            self.aligned_pad = rc.block_frames

    def _pick_window(self, mode, rc):
        rmax = abs(self.const_rate) * self.buf_rate / rc.sample_rate
        C = self.data_host.shape[0]
        if mode in ("grouped", "grouped_t", "grouped_pl", "grouped_v"):
            g, w = pick_group(rmax, C, self.buf_len, rc.block_frames)
            if g and not (mode == "grouped_pl" and C > 2):
                self.win_Qs, self.win_W = g, w
                self.read_mode = mode
        elif mode == "window":
            self.win_Qs, self.win_W = pick_window(rmax, rc.block_frames)
            if self.win_W:
                self.read_mode = "window"

    def resources(self):
        if self.data_host is None:
            return None
        # the loop-wrap edge constant is staged from loop_start at compile
        # time; loop-point changes apply at the next compile (suspend)
        wrap = int(math.ceil(self.loop_start * self.buf_rate))
        res = {"data_rows": pair_rows(self.data_host),
               "edge_vals": edge_vals(self.data_host, self.loop, wrap)}
        res.update(self._read_resources())
        return res

    def _read_resources(self) -> dict:
        """Data-derived layouts of the aligned read (also rebuilt by
        GraphBatch.override_buffer for per-instance audio)."""
        if self.read_mode == "aligned":
            return {"data_tiled": self._tiled_data()}
        if self.win_W:
            return {"data_ext": self._window_data()}
        return {}

    def _tiled_data(self):
        """(C, T) layout for the aligned unit-step slice fetch.
        Whole-buffer loops tile the buffer so any slice start in [0, L)
        covers a full block across the wrap (T = L + P); non-looping
        sources pad P zeros on BOTH sides so pre-start and post-end
        block portions read zeros (T = P + L + P), P = the block size."""
        C, L = self.data_host.shape
        P = self.aligned_pad
        if self.loop:
            reps = -(-(L + P) // L)
            return np.tile(self.data_host, (1, reps))[:, :L + P].astype(
                np.float32, copy=False)
        out = np.zeros((C, P + L + P), np.float32)
        out[:, P:P + L] = self.data_host
        return out

    def _window_data(self):
        """(C, L + W + 2) layout of the grouped read: whole-buffer loops
        copy the loop continuation past column L (reads cross the seam
        linearly); non-looping sources put the linear-extrapolation 'next
        tap' constant at column L (reached only when the playhead sits on
        sample L - 1)."""
        C, L = self.data_host.shape
        W = self.win_W
        ext = np.zeros((C, L + W + 2), np.float32)
        ext[:, :L] = self.data_host
        if self.loop:
            n = min(W + 2, L)
            ext[:, L:L + n] = self.data_host[:, :n]
            for q in range(L + n, L + W + 2):   # a buffer shorter than W + 2
                ext[:, q] = self.data_host[:, (q - L) % L]
        else:
            ext[:, L] = edge_vals(self.data_host, False, 0)
        return ext

    def tail_frames(self):
        # the closed-form playhead is time-indexed; the automated-rate
        # cumsum carries its position
        return 0 if (self.const_rate is not None or not self.has_buffer) \
            else None

    def init_state(self):
        f64 = dict(dtype=torch.float64, device=self.device)
        return {
            "buffer_time": torch.zeros((), **f64),
            "elapsed": torch.zeros((), **f64),
            "entered": torch.zeros((), dtype=torch.bool, device=self.device),
        }

    def process(self, scope, state, inputs, params):
        if not self.has_buffer:
            return state, [torch.zeros((1, 1, scope.frames),
                                       dtype=torch.float32, device=scope.device)]
        if self.const_rate is not None:
            return self._process_closed_form(scope, state)
        if scope.device.type == "cuda":
            return self._process_kernel(scope, state, params)
        return self._process_cumsum(scope, state, params)

    def _entered(self, pos, offset_pos, ls, le, rate):
        """The reference's sticky entered_loop flag, closed form: the
        playhead is monotone, so entry is a per-sample predicate."""
        if rate >= 0.0:
            if offset_pos < le:
                return pos >= ls
            return torch.zeros_like(pos, dtype=torch.bool)
        if offset_pos < le:
            return torch.full_like(pos, bool(offset_pos >= ls), dtype=torch.bool)
        return pos < le

    def _process_closed_form(self, scope, state):
        """Constant-rate playback: the playhead is a pure function of the
        global sample index (the reference's fast track and constant-rate
        slow track)."""
        B = scope.frames
        fs = self.sample_rate
        dt = 1.0 / fs
        rate = self.const_rate
        ratio = self.buf_rate / fs
        L = float(self.buf_len)

        if self.start_frame < 2**31 - 1:
            delta = self.start_frame * dt - self.start_time
        else:
            delta = 0.0
        offset_eff = min(max(self.offset + delta * rate, 0.0), self.buf_duration)
        if self.loop:
            if rate >= 0.0:
                offset_eff = min(offset_eff, self.loop_end)
            else:
                offset_eff = max(offset_eff, self.loop_start)
        offset_pos = offset_eff * self.buf_rate

        start_i = min(self.start_frame, 2**31 - 1)
        sched = scope.active_mask(self.start_frame, self.stop_frame)
        n_rel = (scope.t_idx - start_i).to(torch.float64)
        # buffer_time_elapsed starts at |delta * rate| for a sub-sample
        # start (reference: audio_buffer_source.rs:689)
        delta_elapsed = abs(delta * rate) * fs
        dur_ok = n_rel * abs(rate) + delta_elapsed < self.duration * fs
        active = sched & dur_ok
        pos = offset_pos + (rate * ratio) * n_rel

        if self.loop:
            ls = self.loop_start * self.buf_rate
            le = self.loop_end * self.buf_rate
            loop_len = le - ls
            entered = self._entered(pos, offset_pos, ls, le, rate)
            pos_eff = torch.where(entered, _loop_wrap(pos, ls, le, loop_len), pos)
        else:
            pos_eff = pos

        valid = active & (pos_eff >= 0.0) & (pos_eff < L)
        if self.read_mode == "aligned":
            out = self._fetch_aligned(scope, valid)
        elif self.win_W:
            out = self._fetch_windowed(scope, pos_eff, valid, pos)
        else:
            out = self._fetch(scope, pos_eff, valid)
        # keep the playhead state current for position() readback
        max_rel = float(min(self.stop_frame, 2**31 - 1) - start_i)
        if scope.eager:
            end_rel = torch.clamp(
                torch.tensor(float(scope.frame0_host + B - start_i),
                             dtype=torch.float64, device=scope.device),
                0.0, max(max_rel, 0.0))
        else:
            end_rel = torch.clamp(
                (scope.frame0 + (B - start_i)).to(torch.float64),
                0.0, max(max_rel, 0.0))
        pos_end = offset_pos + (rate * ratio) * end_rel
        if self.loop:
            entered_end = self._entered(pos_end, offset_pos, ls, le, rate)
            pos_end = torch.where(entered_end,
                                  _loop_wrap(pos_end, ls, le, loop_len), pos_end)
        new_state = {
            "buffer_time": pos_end.repeat(scope.n),
            "elapsed": (end_rel * abs(rate) + delta_elapsed).repeat(scope.n),
            "entered": state["entered"],
        }
        return new_state, [out]

    def _process_cumsum(self, scope, state, params):
        """Automated (k-rate) compound rate: the playhead is the exclusive
        masked cumsum of the per-sample increments, one per instance,
        carried across blocks in f64 (buffer_time, elapsed, entered).
        Whether the start falls in this block is known on the host in an
        eager walk; in a captured one it is device data (frame0 is), and
        the start's branch is a `where`.  Nothing here waits for the
        device.  The CPU path, and the contract of the card's kernel
        (`_process_kernel`)."""
        B = scope.frames
        fs = self.sample_rate
        c = self.consts
        # k-rate compound rate (reference: audio_buffer_source.rs:489-493)
        rate = params["playback_rate"].to(torch.float64) * torch.exp2(
            params["detune"].to(torch.float64) / 1200.0)
        rate = rate.reshape(-1, B) if rate.dim() else rate.expand(1, B)
        sched = scope.active_mask(self.start_frame, self.stop_frame)

        # all playhead math runs in buffer-sample units
        ratio = c.ratio
        L = float(self.buf_len)

        # sub-sample start: the first active sample advances the offset by
        # delta * rate (reference: audio_buffer_source.rs:672-690)
        delta = c.delta
        if scope.eager:
            in_block = (scope.frame0_host <= self.start_frame
                        < scope.frame0_host + B)
            rate_n0 = (rate[:, self.start_frame - scope.frame0_host]
                       if in_block else torch.zeros_like(rate[:, 0]))
        else:
            # the start's index in this block, and whether it lies in it
            rel = self.start_frame - scope.frame0
            in_block = (rel >= 0) & (rel < B)
            at = torch.clamp(rel, 0, B - 1).reshape(1)
            rate_n0 = torch.where(in_block, rate.index_select(1, at)[:, 0],
                                  0.0)
        offset_eff = torch.clamp(self.offset + delta * rate_n0, 0.0,
                                 self.buf_duration)
        if self.loop:
            offset_eff = torch.where(
                rate_n0 >= 0.0, torch.clamp(offset_eff, max=self.loop_end),
                torch.clamp(offset_eff, min=self.loop_start))
        pos0_val = offset_eff * self.buf_rate

        # the elapsed-duration limit: a masked |rate| cumsum in context
        # samples, monotone, so the mask is elapsed < duration * fs
        # (reference: :652-667); a sub-sample start adds |delta * rate|
        # up front (reference: :689)
        excl_abs, total_abs = _masked_cumsum_f64(torch.abs(rate), sched)
        if scope.eager:
            delta_elapsed = (torch.abs(delta * rate_n0) * fs if in_block
                             else torch.zeros_like(rate_n0))
        else:
            delta_elapsed = torch.where(
                in_block, torch.abs(delta * rate_n0) * fs, 0.0)
        elapsed0 = state["elapsed"] + delta_elapsed
        active = sched & (elapsed0[:, None] + excl_abs < c.dur_fs)

        excl, total = _masked_cumsum_f64(rate * ratio, active)
        if scope.eager:
            pos0 = pos0_val if in_block else state["buffer_time"]
        else:
            pos0 = torch.where(in_block, pos0_val, state["buffer_time"])
        pos = pos0[:, None] + excl

        if self.loop:
            ls, le = c.ls, c.le
            # the reference's entered_loop flag is sticky
            # (audio_buffer_source.rs:700-717): once playback crosses into
            # the loop region the wrap applies, carried across blocks
            cond = (pos >= ls) if c.cond_ge else (pos < le)
            entered = state["entered"][:, None] | (
                torch.cumsum((cond & active).to(torch.int32), dim=-1) > 0)
            pos_eff = torch.where(entered,
                                  _loop_wrap(pos, ls, le, c.loop_len), pos)
            entered_end = entered[:, -1]
        else:
            pos_eff = pos
            entered_end = state["entered"]

        valid = active & (pos_eff >= 0.0) & (pos_eff < L)
        out = self._fetch(scope, pos_eff[:, None], valid[:, None])
        n = scope.n
        pos_end = pos0 + total
        if self.loop:
            # carried wrapped into the loop once entered, as the
            # reference's buffer_time is: the f64 playhead's rounding then
            # stays that of the loop's length however long the render
            pos_end = torch.where(
                entered_end, ls + _floor_mod(pos_end - ls, c.loop_len),
                pos_end)
        new_state = {
            "buffer_time": pos_end.expand(n).clone(),
            "elapsed": (elapsed0 + total_abs).expand(n).clone(),
            "entered": entered_end.expand(n).clone(),
        }
        return new_state, [out]

    def _process_kernel(self, scope, state, params):
        """`_process_cumsum` on the card: one launch of
        `ops/playhead.py::buffer_playhead` a block, frame0 read on the
        host in an eager walk and from the device scalar in a captured
        one."""
        res = scope.node_resources
        out, new_state = buffer_playhead(
            params["playback_rate"], params["detune"], state,
            res["data_rows"], res["edge_vals"], scope.frames,
            scope.frame0_host if scope.eager else scope.frame0, self.consts)
        return new_state, [out]

    def _fetch(self, scope, playhead, valid):
        """Pair-row gather + lerp (ops/bufread.py): both taps of every
        channel in one row gather; the end-of-buffer neighbor is a
        per-buffer constant patched in with a `where`.  A (B,) playhead
        is shared by the instances; an (M, 1, B) one is each instance's
        own (the cumsum playhead)."""
        floored = torch.floor(playhead)
        # clamp in f64 before the cast: out-of-range float->int casts are
        # undefined in torch (XLA saturates, then the JAX code clips)
        prev_i = torch.clamp(floored, 0.0, float(self.buf_len - 1)).to(torch.int64)
        k = (playhead - floored).to(torch.float32)
        beyond = prev_i + 1 >= self.buf_len
        rows = scope.node_resources["data_rows"]
        a, b = (gather_pairs(rows, prev_i) if playhead.dim() == 1
                else gather_lanes(rows, prev_i))
        edge_c = scope.node_resources["edge_vals"][..., None]  # (R, C, 1)
        if self.loop:
            # end-of-buffer neighbor wraps into the loop
            # (reference: audio_buffer_source.rs:772-795)
            b = torch.where(beyond, edge_c, b)
        else:
            # non-looping end-of-buffer (reference: rs:795-815): read 0 when
            # k ~= 1 or the buffer has a single sample, otherwise linearly
            # extrapolate from the last two samples (WebAudio issue #2032)
            edge = torch.where((k >= 1.0 - 1e-6) | (prev_i == 0), 0.0, edge_c)
            b = torch.where(beyond, edge, b)
        out = a * (1.0 - k) + b * k                           # (R, C, B)
        return torch.where(valid, out, 0.0).to(torch.float32)

    def _fetch_windowed(self, scope, playhead, valid, unwrapped):
        """Grouped two-tap lerp (`ops/grain_read.py::grouped_lerp`; K3's
        contract, K4's in 'window' mode).  A whole-buffer loop reads by the
        UNWRAPPED (monotone) playhead: the group start wraps mod L and the
        layout carries the loop continuation past the seam.  Loop-wrap
        positions can differ from the gather path's wrapped f64 values by
        ~m*eps sample units, so the output may move by ~1 ulp."""
        L = self.buf_len
        if self.loop:  # a whole-buffer loop (guaranteed by _pick_read_mode)
            base = unwrapped
            fl = torch.floor(base)
            u = torch.clamp(fl, -2.0**30, 2.0**30).to(torch.int32)
            wrap_len = L
        else:
            base = playhead
            fl = torch.floor(base)
            u = torch.clamp(fl, 0.0, float(L - 1)).to(torch.int32)
            wrap_len = 0
        k = (base - fl).to(torch.float32)
        res = scope.node_resources
        out = grouped_lerp(res["data_ext"], u[None, None], k[None, None],
                           self.win_Qs, self.win_W, wrap_len)[:, :, 0]
        if not self.loop:
            # the gather path's end-of-buffer cases: column L holds the
            # linear extrapolation constant; take it back out when k ~= 1
            # or the buffer has a single sample
            cond = (u + 1 >= L) & ((k >= EDGE_FRAC) | (u == 0))
            out = out - res["edge_vals"][..., None] * torch.where(cond, k, 0.0)
        return torch.where(valid, out, 0.0).to(torch.float32)

    def _fetch_aligned(self, scope, valid):
        """Aligned unit-step fetch: the block's samples are
        data[(aligned_off + t - start) mod L] (loop) or
        data[aligned_off + t - start] (one-shot), i.e. one contiguous run
        of the pre-tiled layout (_tiled_data): a slice at the host's
        frame0 in an eager walk, a read at s + arange(B) from the device
        scalar s in a captured one (JAX: a `dynamic_slice`).  Pre-start
        and out-of-range positions read tiled data or pad zeros and are
        masked by `valid` exactly like the gather path."""
        tiled = scope.node_resources["data_tiled"]           # (R, C, T)
        start_i = min(self.start_frame, 2**31 - 1)
        pad = self.aligned_pad
        if scope.eager:
            raw = scope.frame0_host - start_i + self.aligned_off
            s = (raw % self.buf_len if self.loop
                 else min(max(raw, -pad), self.buf_len) + pad)
            out = tiled[..., s:s + scope.frames]
        else:
            raw = scope.frame0 + (self.aligned_off - start_i)
            s = (torch.remainder(raw, self.buf_len) if self.loop
                 else torch.clamp(raw, -pad, self.buf_len) + pad)
            out = tiled.index_select(-1, s + scope.arange)
        return torch.where(valid, out, 0.0).to(torch.float32)


class AudioBufferSourceNode(AudioScheduledSourceNode):
    _number_of_inputs = 0
    _number_of_outputs = 1

    def __init__(self, context, buffer: AudioBuffer | None = None,
                 detune: float = 0.0, loop: bool = False,
                 loop_start: float = 0.0, loop_end: float = 0.0,
                 playback_rate: float = 1.0):
        super().__init__(context)
        self._buffer = None
        self.loop = bool(loop)
        self._loop_start = float(loop_start)
        self._loop_end = float(loop_end)
        self._offset = 0.0
        self._duration = float("inf")
        self.playback_rate = self._register_param(
            "playback_rate",
            AudioParamDescriptor(
                name="playback_rate", automation_rate=AutomationRate.K,
                default_value=1.0, min_value=-3.4028235e38, max_value=3.4028235e38))
        # k-rate constrained (reference: audio_buffer_source.rs:228-245)
        self.playback_rate.set_automation_rate_constrained(True)
        self.detune = self._register_param(
            "detune",
            AudioParamDescriptor(
                name="detune", automation_rate=AutomationRate.K,
                default_value=0.0, min_value=-3.4028235e38, max_value=3.4028235e38))
        self.detune.set_automation_rate_constrained(True)
        if playback_rate != 1.0:
            self.playback_rate.set_value(playback_rate)
        if detune != 0.0:
            self.detune.set_value(detune)
        if buffer is not None:
            self.buffer = buffer

    # --- buffer management (reference: audio_buffer_source.rs:300-370) ----
    @property
    def buffer(self) -> AudioBuffer | None:
        return self._buffer

    @buffer.setter
    def buffer(self, buf: AudioBuffer):
        if self._buffer is not None:
            raise InvalidStateError("buffer has already been set")
        self._buffer = buf
        self.context._invalidate_graph_cache()

    @property
    def loop_start(self) -> float:
        return self._loop_start

    @loop_start.setter
    def loop_start(self, v: float):
        self._loop_start = self._clamp_loop_boundary(float(v))
        self.context._invalidate_graph_cache()

    @property
    def loop_end(self) -> float:
        return self._loop_end

    @loop_end.setter
    def loop_end(self, v: float):
        self._loop_end = self._clamp_loop_boundary(float(v))
        self.context._invalidate_graph_cache()

    def _clamp_loop_boundary(self, v: float) -> float:
        if self._buffer is not None:
            return min(max(v, 0.0), self._buffer.duration)
        return v

    @property
    def position(self) -> float:
        """Playhead position in buffer time (reference: :306)."""
        return getattr(self, "_last_position", 0.0)

    def start(self, when: float = 0.0, offset: float | None = None,
              duration: float | None = None):
        if offset is not None:
            self._offset = max(0.0, float(offset))
        if duration is not None:
            self._duration = float(duration)
        super().start(when)

    def start_at_with_offset(self, when, offset):
        self.start(when, offset)

    def start_at_with_offset_and_duration(self, when, offset, duration):
        self.start(when, offset, duration)

    def output_channel_count(self, input_counts):
        c = self._buffer.number_of_channels if self._buffer is not None else 1
        return [c]

    def make_kernel(self, render_ctx):
        # loop_end defaults to buffer duration once a buffer is present
        if self._buffer is not None and self._loop_end == 0.0:
            self._loop_end = self._buffer.duration
        return _BufferSourceKernel(self, render_ctx)

    def _on_render_state(self, state):
        rate = self._buffer.sample_rate if self._buffer is not None else 1.0
        self._last_position = float(state["buffer_time"]) / rate
