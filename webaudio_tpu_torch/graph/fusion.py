"""Automatic fusion of homogeneous source chains into voice banks.

Ported from `webaudio_tpu/graph/fusion.py`.  The reference renders each
node as a separate processor; a 500-oscillator additive-synth graph or a
granular graph of hundreds of short grains of one sample is hundreds of
(1, B) nodes.  This pass rewrites groups of identical-topology chains

    src_i [-> shaper_i] [-> biquad_i] [-> gain_i] [-> panner_i] -> targets

into ONE fused node computing all V voices as (V, B) tensors, and sums into
the shared mix targets (sum_inputs is additive, so summing V signals
before the edge is exactly the per-edge sum the unfused graph computes).

Sources: oscillators of one type (custom waves included, with stacked
per-voice tables) whose frequency and detune have no audio-rate input;
constant sources whose offset has none; buffer sources playing one buffer
at a constant compound rate without a loop.  Stages, each optional, for
oscillator and constant-source chains: a WaveShaper without oversampling
(the per-voice curves go through the curve kernel K1 as one table), a
constant-coefficient biquad (per-voice truncated IRs in one partitioned
convolution), a Max-mode gain (its envelopes stay dense per-voice rows,
or constants) and a constant-pan StereoPanner (mono equal-power spread).
Buffer-source chains take the gain stage only.

Oscillator and constant-source banks compute every voice per sample: a
closed-form phase per quantum (f64) and within it (f32) when every
frequency is constant, the split-precision cumsum per voice otherwise.  A
buffer-source bank renders one of two ways:
- grain lanes (`_plan_grain_lanes`): when the grains are short and
  sequential, greedy interval packing puts the V grains into K << V
  lanes, the gain envelopes are spliced per lane on the host
  (`_LaneEnvParam`), and the kernel renders (K, B) work per block.  The
  read mode (`_FusedVoicesKernel._pick_window`) picks the whole-bank CUDA
  kernel (K2, `ops/grain_read.py::grain_bank`), the grouped two-tap lerp
  kernel (K3/K4/K7, `grouped_lerp`) or per-sample pair gathers;
- the dense (V, B) closed-form playhead, when the grains overlap too much
  for lanes to pay (K * 4 > V).

Fusion is topology-deterministic (fused ids derive from member ids), so
suspend/resume re-plans keep matching state keys.  Disable or tune with
WEBAUDIO_FUSE_THRESHOLD (<= 0 disables; default 32).
"""

from __future__ import annotations

import os
from collections import defaultdict

import numpy as np
import torch

from ..automation import SET_VALUE, CompiledParam
from ..constants import RENDER_QUANTUM_SIZE
from ..ops import fft_conv
from ..ops import oscillator as osc_ops
from ..ops.bufread import edge_vals, pair_rows
from ..ops.curve_kernel import curve_lookup
from ..ops.grain_read import (EDGE_FRAC, grain_bank, grouped_lerp,
                              pick_group, pick_window)
from .compiler import Kernel
from .ir import Edge

INF = 2**31 - 1

# WEBAUDIO_GRAIN_READ values that read through the grouped two-tap lerp
# (the JAX package's production K3 mode and its study formulations of the
# same contract)
GROUPED_MODES = ("grouped", "grouped_t", "grouped_t2", "grouped_dot",
                 "grouped_v", "grouped_pl")


def fuse_threshold() -> int:
    try:
        return int(os.environ.get("WEBAUDIO_FUSE_THRESHOLD", "32"))
    except ValueError:
        return 32


def fuse_sources(nodes: dict, edges: list, dest_id: int,
                 sample_rate: float | None = None):
    """-> (nodes', edges', param_alias) where param_alias maps each fused
    member's (node_id, param_name) to its (fused_id, alias) row key.

    sample_rate enables fuse-time grain-lane planning for buffer-source
    banks (lane-packed kernels and per-lane spliced envelope params)."""
    threshold = fuse_threshold()
    if threshold <= 0 or len(nodes) < threshold:
        return nodes, edges, {}

    from ..nodes.biquad_filter import BiquadFilterNode
    from ..nodes.buffer_source import AudioBufferSourceNode
    from ..nodes.constant_source import ConstantSourceNode
    from ..nodes.gain import GainNode
    from ..nodes.oscillator import OscillatorNode
    from ..nodes.stereo_panner import StereoPannerNode
    from ..nodes.waveshaper import OverSampleType, WaveShaperNode
    from ..ops.mixing import ChannelCountMode

    out_edges: dict = defaultdict(list)
    audio_in: dict = defaultdict(int)
    param_in: set = set()
    for e in edges:
        out_edges[e.src].append(e)
        if e.param is not None:
            param_in.add((e.dst, e.param))
        else:
            audio_in[e.dst] += 1

    def _const(p):
        # constructor-time .value setters queue SetValue(t=0) events;
        # those still compile to a constant
        return all(e.event_type == SET_VALUE and e.time == 0.0
                   for e in p._timeline.events)

    def _single(outs, cls):
        """The node the chain's one audio edge (into input 0) feeds, if it
        is a `cls` other than the destination with no other audio input
        and with outputs of its own."""
        if (len(outs) == 1 and outs[0].param is None
                and outs[0].dst_input == 0
                and isinstance(nodes.get(outs[0].dst), cls)):
            nid = outs[0].dst
            if nid != dest_id and audio_in[nid] == 1 and out_edges.get(nid):
                return nid
        return None

    # candidate chains: (source, shaper, filter, gain, pan, targets, kind),
    # the stages' ids or None
    chains = []
    for nid, node in nodes.items():
        if isinstance(node, OscillatorNode):
            kind = node._type  # custom waves fuse too (stacked tables)
            if (nid, "frequency") in param_in or (nid, "detune") in param_in:
                continue
        elif isinstance(node, ConstantSourceNode):
            kind = "const_src"
            if (nid, "offset") in param_in:
                continue
        elif isinstance(node, AudioBufferSourceNode):
            # same buffer, constant compound rate, no loop (the granular
            # shape: many short grains of one sample)
            if (node.buffer is None or node.loop
                    or (nid, "playback_rate") in param_in
                    or (nid, "detune") in param_in
                    or not _const(node.params["playback_rate"])
                    or not _const(node.params["detune"])):
                continue
            kind = ("bufsrc", id(node.buffer))
        else:
            continue
        mono = not isinstance(kind, tuple)
        outs = out_edges.get(nid, [])
        if not outs or any(e.src_output != 0 for e in outs):
            continue
        # optional waveshaper stage (no oversampling, curve set): voice
        # distortion banks; mono sources only
        shaper = _single(outs, WaveShaperNode) if mono else None
        if shaper is not None:
            wnode = nodes[shaper]
            if (wnode.curve is None
                    or wnode.oversample != OverSampleType.NONE
                    or wnode._channel_config.mode != ChannelCountMode.MAX):
                shaper = None
            else:
                outs = out_edges[shaper]
        # optional constant-coefficient biquad stage (subtractive-synth
        # chains; mono sources only)
        filt = _single(outs, BiquadFilterNode) if mono else None
        if filt is not None:
            fnode = nodes[filt]
            names = ("frequency", "detune", "q", "gain")
            if (any((filt, pn) in param_in for pn in names)
                    or not all(_const(fnode.params[pn]) for pn in names)
                    or fnode._channel_config.mode != ChannelCountMode.MAX):
                filt = None
            else:
                outs = out_edges[filt]
        gain = _single(outs, GainNode)
        # an explicit/clamped channel count up-mixes *inside* the chain and
        # changes downstream channel propagation; only Max-mode
        # (pass-through width) gains fuse
        if gain is not None and ((gain, "gain") in param_in
                                 or nodes[gain]._channel_config.mode
                                 != ChannelCountMode.MAX):
            gain = None
        if gain is not None:
            outs = out_edges[gain]
        # optional constant-pan stereo spread tail (poly-synth voicing);
        # mono chains only, so the panner takes its mono equal-power path
        pan = _single(outs, StereoPannerNode) if mono else None
        if pan is not None:
            pcfg = nodes[pan]._channel_config
            # an explicit channel count up-mixes the mono chain and takes
            # the stereo pan path when unfused; the fused kernel always
            # applies mono equal-power gains
            if ((pan, "pan") in param_in or not _const(nodes[pan].params["pan"])
                    or (pcfg.mode == ChannelCountMode.EXPLICIT
                        and pcfg.count != 1)):
                pan = None
            else:
                outs = out_edges[pan]
        targets = tuple(sorted(
            (e.dst, e.dst_input, e.param or "") for e in outs))
        if not targets:
            continue
        chains.append((nid, shaper, filt, gain, pan, targets, kind))

    # group by (source kind / waveform type, curve length, chain shape,
    # target signature)
    groups: dict = defaultdict(list)
    for nid, shaper, filt, gain, pan, targets, kind in chains:
        clen = len(nodes[shaper].curve) if shaper is not None else 0
        groups[(kind, clen, filt is not None, gain is not None,
                pan is not None, targets)].append(
            (nid, shaper, filt, gain, pan))

    # drop groups whose targets point at nodes another group removes (an
    # env gain feeding another candidate's gain); iterate to a fixed point
    live = {k: v for k, v in groups.items() if len(v) >= threshold}
    while True:
        removed = {m for members in live.values() for chain in members
                   for m in chain if m is not None}
        bad = [k for k in live if any(t[0] in removed for t in k[5])]
        if not bad:
            break
        for k in bad:
            del live[k]
    if not live:
        return nodes, edges, {}

    nodes2 = dict(nodes)
    removed: set = set()
    param_alias: dict = {}
    fused_edges: list = []
    for (kind, _clen, _f, _g, _p, targets), members in \
            sorted(live.items(), key=lambda kv: min(m[0] for m in kv[1])):
        members = sorted(members)
        fid = -(1 + min(m[0] for m in members))  # deterministic, unique

        def stage(k):
            return [nodes[m[k]] if m[k] is not None else None
                    for m in members]

        nodes2[fid] = _FusedVoicesNode(
            fid, stage(0), stage(3), kind, filters=stage(2),
            panners=stage(4), shapers=stage(1), sample_rate=sample_rate)
        for i, (onid, wnid, fnid, gnid, pnid) in enumerate(members):
            removed.add(onid)
            if kind == "const_src":
                param_alias[(onid, "offset")] = (fid, f"v{i}.offset")
            elif not isinstance(kind, tuple):
                param_alias[(onid, "frequency")] = (fid, f"v{i}.frequency")
                param_alias[(onid, "detune")] = (fid, f"v{i}.detune")
            # buffer sources have constant rates, shapers static curves,
            # filters constant coefficients and panners constant pans: no
            # packed rows to remap
            for extra in (wnid, fnid, pnid):
                if extra is not None:
                    removed.add(extra)
            if gnid is not None:
                removed.add(gnid)
                param_alias[(gnid, "gain")] = (fid, f"v{i}.gain")
        for dst, dst_input, pname in targets:
            fused_edges.append(Edge(fid, 0, dst, dst_input, pname or None))

    for nid in removed:
        del nodes2[nid]
    edges2 = [e for e in edges
              if e.src not in removed and e.dst not in removed]
    edges2.extend(fused_edges)
    return nodes2, edges2, param_alias


class _GrainLanePlan:
    """Host-side grain-lane packing for a fused buffer-source bank.

    Computed at FUSE time (not kernel-build time) so the fused node can
    declare per-LANE envelope params before param compilation: grain
    schedules are known at compile time when rates are constant."""

    __slots__ = ("starts", "stops", "rates", "offsets", "durations",
                 "start_times", "offset_pos", "delta_elapsed", "dur_end",
                 "ends", "use_lanes", "K", "lane_start", "lane_end",
                 "lane_voice", "lanes")


def _plan_grain_lanes(sources, fs: float) -> _GrainLanePlan:
    """Pack time-localized grains into K << V concurrency lanes.

    Grains are short and sequential, so the peak overlap is small: greedy
    interval partitioning (optimal for interval graphs) assigns each grain
    to a lane, and the kernel renders (K, B) instead of (V, B).  Requires
    a conservative UPPER bound on each grain's audible end (buffer exit,
    duration cap, stop time); unbounded voices keep a dedicated lane.

    Packing is quantum-ALIGNED: a grain may follow another in the same
    lane only when every possibly-audible frame of the old grain (< ends)
    lies in an earlier quantum than the new grain's start, so any quantum
    sees at most one audible grain per lane and the kernel renders from a
    single per-quantum grain id."""
    p = _GrainLanePlan()
    V = len(sources)
    buf = sources[0].buffer
    buf_len = buf.length
    buf_rate = buf.sample_rate
    buf_duration = buf.length / buf.sample_rate
    ratio = buf_rate / fs

    starts, stops = [], []
    rates, offsets, durations, start_times = [], [], [], []
    for o in sources:
        start, stop = o._schedule_frames(fs)
        starts.append(min(start, INF))
        stops.append(min(stop, INF))
        pr = np.float64(np.float32(o.playback_rate.value))
        dt_ = np.float64(np.float32(o.detune.value))
        rates.append(float(pr * np.exp2(dt_ / 1200.0)))
        offsets.append(float(o._offset))
        d = o._duration
        durations.append(np.inf if d is None else float(d))
        start_times.append(0.0 if o._start_time is None
                           else float(o._start_time))
    p.starts = np.asarray(starts, np.int32)
    p.stops = np.asarray(stops, np.int32)
    p.rates = np.asarray(rates, np.float64)
    p.offsets = np.asarray(offsets, np.float64)
    p.durations = np.asarray(durations, np.float64)
    p.start_times = np.asarray(start_times, np.float64)

    offset_pos = np.zeros(V, np.float64)
    delta_el = np.zeros(V, np.float64)
    ends = np.zeros(V, np.int64)
    for i in range(V):
        start = int(p.starts[i])
        if start >= INF:
            offset_pos[i] = 0.0
            ends[i] = start
            continue
        delta = start / fs - p.start_times[i]
        off_eff = min(max(p.offsets[i] + delta * p.rates[i], 0.0),
                      buf_duration)
        offset_pos[i] = off_eff * buf_rate
        delta_el[i] = abs(delta * p.rates[i]) * fs
        cand = [float(p.stops[i])]
        r_ = p.rates[i] * ratio  # buffer samples per frame
        if r_ > 0:
            cand.append(start + (buf_len - offset_pos[i]) / r_ + 2)
        elif r_ < 0:
            cand.append(start + offset_pos[i] / (-r_) + 2)
        if np.isfinite(p.durations[i]) and abs(p.rates[i]) > 0:
            cand.append(start + (p.durations[i] * fs - delta_el[i])
                        / abs(p.rates[i]) + 2)
        ends[i] = int(min(min(cand), INF))
    p.offset_pos = offset_pos
    p.delta_elapsed = delta_el
    p.ends = ends

    # duration cutoff frame per voice, computed to match the per-sample
    # f64 comparison `n_rel*|rate| + delta_el < dur*fs` exactly (probe
    # the three candidate frames around the analytic boundary)
    dur_end = np.full(V, INF, np.int64)
    for i in range(V):
        if not np.isfinite(p.durations[i]) or p.rates[i] == 0.0:
            continue
        rhs = (p.durations[i] * fs - delta_el[i]) / abs(p.rates[i])
        k0 = int(np.floor(rhs))
        cut = k0 + 2
        for kk in (max(k0 - 1, 0), k0, k0 + 1):
            if not (kk * abs(p.rates[i]) + delta_el[i]
                    < p.durations[i] * fs):
                cut = kk
                break
        dur_end[i] = min(int(p.starts[i]) + cut, INF)
    p.dur_end = dur_end.astype(np.int32)

    order = np.argsort(p.starts, kind="stable")
    lane_end: list = []
    lanes: list = []
    for i in order:
        s, e = int(p.starts[i]), int(ends[i])
        for k in range(len(lane_end)):
            if lane_end[k] <= (s // RENDER_QUANTUM_SIZE) * RENDER_QUANTUM_SIZE:
                lanes[k].append(int(i))
                lane_end[k] = e
                break
        else:
            lanes.append([int(i)])
            lane_end.append(e)
    K = len(lanes)
    p.lanes = lanes
    p.K = K
    # extreme playback rates would overflow the lane path's i32 playhead
    # rebase (the dense (V, B) path stays f64 end to end)
    sane_rates = float(np.max(np.abs(p.rates))) * ratio <= 64.0
    p.use_lanes = K * 4 <= V and sane_rates
    if not p.use_lanes:
        return p
    G = max(len(m) for m in lanes)
    lane_start = np.full((K, G), INF, np.int32)
    lane_endv = np.zeros((K, G), np.int32)
    lane_voice = np.zeros((K, G), np.int32)
    for k, members in enumerate(lanes):
        for j, i in enumerate(members):
            lane_start[k, j] = p.starts[i]
            lane_endv[k, j] = min(int(ends[i]), INF)
            lane_voice[k, j] = i
    p.lane_start = lane_start
    p.lane_end = lane_endv
    p.lane_voice = lane_voice
    return p


class _LaneEnvParam:
    """Synthetic per-LANE gain param for a lane-packed grain bank.

    Grain spans within a lane are disjoint by construction, so the K lane
    rows are spliced on the host from each member's own compiled envelope,
    and the kernel reads gain as a plain (N, K, B) slice of the dense rows
    with no per-voice selection.  Rides the same dense-param machinery as
    real AudioParams: `compile_for_render` (offline, batch, segment and
    session renders; the row is always dense) and `advance_dense`
    (streaming renders)."""

    def __init__(self, plan: _GrainLanePlan, k: int, gains):
        self._plan = plan
        self._members = list(plan.lanes[k])
        self._gains = gains
        g0 = gains[self._members[0]].params["gain"]
        self.min_value = g0.min_value
        self.max_value = g0.max_value
        self.default_value = 0.0

    def _splice(self, row, i, vals, gparam, start_frame, length):
        s_abs = int(self._plan.starts[i])
        if s_abs >= INF:
            return
        e_abs = int(min(self._plan.ends[i], start_frame + length))
        s = max(s_abs - start_frame, 0)
        e = e_abs - start_frame
        if e <= s:
            return
        if np.isscalar(vals):
            row[s:e] = np.float32(
                min(max(vals, gparam.min_value), gparam.max_value))
        else:
            row[s:e] = np.clip(vals[s:e], gparam.min_value,
                               gparam.max_value)

    def compile_for_render(self, sample_rate: float, length: int,
                           start_frame: int = 0, force_dense: bool = False):
        row = np.zeros(length, np.float32)
        for i in self._members:
            g = self._gains[i].params["gain"]
            mplan = g.compile_for_render(sample_rate, length, start_frame)
            vals = mplan.scalar if mplan.is_constant else mplan.dense
            self._splice(row, i, vals, g, start_frame, length)
        return CompiledParam(None, row, 0.0, None)

    def advance_dense(self, sample_rate: float, length: int,
                      start_frame: int = 0) -> np.ndarray:
        row = np.zeros(length, np.float32)
        for i in self._members:
            # advance every member's live timeline each chunk (keeps their
            # state machines in lockstep with the render position)
            g = self._gains[i].params["gain"]
            vals = g.advance_dense(sample_rate, length, start_frame)
            self._splice(row, i, vals, g, start_frame, length)
        return row


class _FusedVoicesNode:
    """Synthetic graph node standing in for V fused source chains.

    Exposes exactly the protocol compile_graph consumes: node_id, params
    (the member AudioParams re-homed under per-voice aliases, or the
    per-lane spliced envelopes), channel config, and make_kernel."""

    number_of_inputs = 0
    number_of_outputs = 1

    def __init__(self, fid, sources, gains, kind, filters=None,
                 panners=None, shapers=None, sample_rate=None):
        self.node_id = fid
        # block-size budget: the kernel materializes ~(V, B) f64
        # temporaries (phase math), i.e. ~4V times a single node's (1, B)
        # f32 buffers
        self.compile_weight = 4 * len(sources)
        self.sources = sources
        self.gains = gains
        self.filters = filters or [None] * len(sources)
        self.panners = panners or [None] * len(sources)
        self.shapers = shapers or [None] * len(sources)
        self.kind = kind  # OscillatorType, "const_src" or ("bufsrc", id)
        self._channel_config = sources[0]._channel_config
        self.lane_plan = None
        self.lane_env = False
        if isinstance(kind, tuple) and sample_rate is not None:
            self.lane_plan = _plan_grain_lanes(sources, float(sample_rate))
            if self.lane_plan.use_lanes:
                # lane-packed temporaries are (K, B), not (V, B): budget on
                # K so the block policy can pick render-sized blocks
                self.compile_weight = 4 * self.lane_plan.K + 4
        # aliases grouped by param kind so each group's dense rows pack
        # contiguously (the compiler slices each group in one op)
        self._params = {}
        if kind == "const_src":
            for i, src in enumerate(sources):
                self._params[f"v{i}.offset"] = src.params["offset"]
        elif not isinstance(kind, tuple):
            for name in ("frequency", "detune"):
                for i, src in enumerate(sources):
                    self._params[f"v{i}.{name}"] = src.params[name]
        if (self.lane_plan is not None and self.lane_plan.use_lanes
                and gains[0] is not None):
            # per-LANE spliced envelopes instead of per-voice rows: K dense
            # rows, read verbatim by the kernel (see _LaneEnvParam)
            self.lane_env = True
            for k in range(self.lane_plan.K):
                self._params[f"lane{k}.gain"] = _LaneEnvParam(
                    self.lane_plan, k, gains)
        else:
            for i, g in enumerate(gains):
                if g is not None:
                    self._params[f"v{i}.gain"] = g.params["gain"]

    @property
    def params(self):
        return self._params

    def foreign_params(self):
        return {}

    def output_channel_count(self, input_counts):
        if self.panners[0] is not None:
            return [2]
        if isinstance(self.kind, tuple):
            return [self.sources[0].buffer.number_of_channels]
        return [1]

    def make_kernel(self, rc):
        return _FusedVoicesKernel(self, rc)


def _lead(*tensors) -> int:
    return max(t.shape[0] for t in tensors)


def _take(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-voice values x (1 or I, V) at voice ids v (1 or I, K, nq) ->
    (I, K, nq)."""
    n = _lead(x, v)
    _, K, nq = v.shape
    idx = v.expand(n, K, nq).reshape(n, K * nq)
    return torch.gather(x.expand(n, x.shape[1]), 1, idx).reshape(n, K, nq)


def _pairs(rows: torch.Tensor, idx: torch.Tensor):
    """Pair rows (1 or I, L, 2C) at integer idx (1 or I, M, B) -> the two
    lerp taps, each (I, C, M, B)."""
    C = rows.shape[-1] // 2
    if rows.shape[0] == 1:
        g = rows[0][idx]                                  # (Ii, M, B, 2C)
    else:
        n = _lead(rows, idx)
        inst = torch.arange(n, device=rows.device).view(n, 1, 1)
        g = rows[inst, idx.expand(n, *idx.shape[1:])]     # (I, M, B, 2C)
    g = torch.movedim(g, -1, 1)                           # (I, 2C, M, B)
    return g[:, :C], g[:, C:]


def _classify(plans, names, params):
    """Per-voice param plans -> (const (V,) f32 with the dense voices' slots
    0, the dense voices' positions in row order, the (min, max) clip in
    f32).  names: the voices' aliases; params: their AudioParams."""
    const = np.zeros(len(names), np.float32)
    dense = []
    for i, (name, p) in enumerate(zip(names, params)):
        plan = plans[name]
        if plan.is_constant:
            const[i] = np.float32(min(max(plan.scalar, p.min_value),
                                      p.max_value))
        else:
            dense.append(i)
    return const, np.asarray(dense, np.int64), params[0].f32_bounds()


class _FusedVoicesKernel(Kernel):
    """A fused bank of V source chains.

    Buffer sources: lane-packed (K, B) grain rendering, or the (V, B)
    closed-form playhead of `nodes/buffer_source.py`.  Oscillators and
    constant sources: (V, B) voices of `nodes/oscillator.py` and
    `nodes/constant_source.py`, then the optional stages in the chain's
    order, shaper (K1 over a table of per-voice curves), filter (per-voice
    truncated IRs through one partitioned convolution), gain, and the mono
    or equal-power stereo mixdown."""

    # read only via staged resources: data_host feeds data_rows/edge_vals/
    # data_ext; start_times feeds the staged offset_pos/delta_elapsed and
    # lane tables.  Same-shape different-value banks may bucket together
    # in MixedGraphBatch (their staged leaves stack per instance).
    _fp_staged_attrs = ("data_host", "start_times")

    def __init__(self, node: _FusedVoicesNode, rc):
        self._staged = {}        # host index arrays on the device (_index)
        self.device = rc.device
        self.fs = rc.sample_rate
        self.block_frames = rc.block_frames
        self.V = len(node.sources)
        self.is_bufsrc = isinstance(node.kind, tuple)
        self.has_gain = node.gains[0] is not None
        self.lane_env = node.lane_env
        self.use_lanes = False
        if self.is_bufsrc:
            self._init_grains(node)
        else:
            self._init_voices(node, rc)
        if self.has_gain and not self.lane_env:
            self.gain_const, self.gain_dense, self.gain_lim = _classify(
                rc.param_plans, [f"v{i}.gain" for i in range(self.V)],
                [g.params["gain"] for g in node.gains])
        elif self.has_gain:
            self.gain_lim = node.gains[0].params["gain"].f32_bounds()

    def _init_grains(self, node):
        self.win_Qs = 0        # read geometry (_pick_window)
        self.win_W = 0
        self.read_mode = "gather"
        buf = node.sources[0].buffer
        self.buf_len = buf.length
        self.buf_rate = buf.sample_rate
        self.buf_duration = buf.length / buf.sample_rate
        self.data_host = buf.to_array()  # (C, L) shared by all voices
        # the lane plan (and every schedule-derived host array) comes from
        # the node, computed at fuse time: the same object whose lane
        # structure shaped the node's param declaration
        lp = node.lane_plan if node.lane_plan is not None else \
            _plan_grain_lanes(node.sources, self.fs)
        self.starts = lp.starts
        self.stops = lp.stops
        self.rates = lp.rates
        self.offsets = lp.offsets
        self.durations = lp.durations
        self.start_times = lp.start_times
        self.use_lanes = lp.use_lanes
        if self.use_lanes:
            self.offset_pos = lp.offset_pos
            self.dur_end = lp.dur_end
            self.K = lp.K
            self.lane_start = lp.lane_start
            self.lane_end = lp.lane_end
            self.lane_voice = lp.lane_voice
            self._pick_window()

    def _init_voices(self, node, rc):
        from ..nodes.biquad_filter import _computed_freq, _np_coefs
        from ..nodes.oscillator import OscillatorType
        from ..ops import recurrence

        fs = self.fs
        self.kind = node.kind
        self.is_const_src = node.kind == "const_src"
        self.is_custom = node.kind == OscillatorType.CUSTOM
        self.has_filter = node.filters[0] is not None
        self.has_pan = node.panners[0] is not None
        self.has_shaper = node.shapers[0] is not None
        self.device = rc.device
        if self.has_shaper:
            self.curves = np.stack(
                [np.asarray(w.curve, np.float32) for w in node.shapers])
        if self.has_pan:
            # per-voice constant equal-power gains, mono input path
            # (nodes/stereo_panner.py), computed on the host as the JAX
            # package computes them
            pans = np.asarray(
                [np.clip(np.float32(p.params["pan"]._timeline.intrinsic_value),
                         -1.0, 1.0) for p in node.panners], np.float32)
            x = (pans + 1.0) * np.float32(0.5)
            self.pan_gl = np.sin((1.0 - x) * np.float32(np.pi / 2.0)
                                 ).astype(np.float32)
            self.pan_gr = np.sin(x * np.float32(np.pi / 2.0)
                                 ).astype(np.float32)
        if self.has_filter:
            # per-voice constant-coefficient biquads -> truncated IRs -> one
            # partitioned-convolution bank with voices as channels (as
            # nodes/biquad_filter.py::_BiquadLTIKernel)
            self.partition = fft_conv.choose_partition(rc.block_frames)
            spectra = []
            for fl in node.filters:
                fp = fl.params
                f = _computed_freq(
                    np.float64(np.float32(
                        fp["frequency"]._timeline.intrinsic_value)),
                    np.float64(np.float32(
                        fp["detune"]._timeline.intrinsic_value)))
                b0, b1, b2, a1, a2 = _np_coefs(
                    fl._type, fs, f, fp["gain"]._timeline.intrinsic_value,
                    fp["q"]._timeline.intrinsic_value)
                h = recurrence.iir_impulse_response(
                    [b0, b1, b2], [1.0, a1, a2])
                spectra.append(fft_conv.partition_ir(h, self.partition)[0])
            kmax = max(sp.shape[0] for sp in spectra)
            stack = np.zeros((self.V, kmax, self.partition + 1), np.complex64)
            for i, sp in enumerate(spectra):
                stack[i, :sp.shape[0]] = sp
            self.h_stack = stack
            self.kparts = kmax

        starts, stops, ratios = [], [], []
        for o in node.sources:
            start, stop = o._schedule_frames(fs)
            starts.append(min(start, INF))
            stops.append(min(stop, INF))
            ratios.append(0.0 if start >= INF
                          else float(start - o._start_time * fs))
        self.starts = np.asarray(starts, np.int32)
        self.stops = np.asarray(stops, np.int32)
        self.ratios = np.asarray(ratios, np.float64)
        if self.is_custom:
            self.tables = np.stack(
                [np.asarray(o._periodic_wave.as_array(), np.float32)
                 for o in node.sources])

        plans = rc.param_plans

        def classify(name):
            return _classify(plans, [f"v{i}.{name}" for i in range(self.V)],
                             [o.params[name] for o in node.sources])

        if self.is_const_src:
            self.off_const, self.off_dense, self.off_lim = classify("offset")
            self.all_const_freq = True  # no phase state at all
        else:
            self.freq_const, self.freq_dense, self.freq_lim = \
                classify("frequency")
            self.det_const, self.det_dense, self.det_lim = classify("detune")
            self.all_const_freq = (len(self.freq_dense) == 0
                                   and len(self.det_dense) == 0)
        if not self.is_const_src:
            # bit-identical to the oscillator's host math
            # (nodes/oscillator.py make_kernel: f32 f * exp2(d / 1200)); on
            # the dense path the voices whose frequency and detune are both
            # constant take it too, so fused and unfused voices agree
            f = self.freq_const.astype(np.float32)
            d = self.det_const.astype(np.float32)
            self.computed_const = (
                f * np.exp2(d / np.float32(1200.0))).astype(np.float32)
            dense = set(self.freq_dense.tolist()) | set(self.det_dense.tolist())
            self.const_voices = np.asarray(
                [i not in dense for i in range(self.V)])

    def _pick_window(self):
        """Choose the read mode and its geometry from WEBAUDIO_GRAIN_READ.

        'auto' takes the JAX package's TPU rule: the whole-bank kernel K2
        ('fused') when the bank has per-lane envelopes, at most 2 channels
        and a wide group geometry; else the grouped two-tap lerp (K3) when
        a group geometry fits; else per-sample pair gathers.  Every
        grouped study mode reads through the K3 route, 'window' through
        the same kernel at its (Qs, W) sub-block geometry (K4's contract).
        A group or window stays within one render quantum: a lane's grain
        changes only at quantum boundaries, so each group's playhead is
        monotone."""
        mode = os.environ.get("WEBAUDIO_GRAIN_READ", "auto")
        if mode == "gather":
            return
        ratio = self.buf_rate / self.fs
        rmax = float(np.max(np.abs(self.rates))) * ratio
        C = self.data_host.shape[0]
        if mode in ("auto", "fused") + GROUPED_MODES:
            g, w = pick_group(rmax, C, self.buf_len, self.block_frames)
            gw, ww = pick_group(rmax, C, self.buf_len, self.block_frames,
                                wide=True)
            fused_ok = bool(gw) and self.lane_env and C <= 2
            if mode == "fused" and not fused_ok:
                mode = "grouped_t"
            if mode == "fused":
                self.win_Qs, self.win_W = gw, ww
                self.read_mode = mode
                return
            if g:
                self.win_Qs, self.win_W = g, w
                if mode == "grouped_pl" and C > 2:
                    mode = "grouped_t"
                if mode == "auto":
                    if fused_ok:
                        self.win_Qs, self.win_W = gw, ww
                        self.read_mode = "fused"
                        return
                    mode = "grouped_v"
                self.read_mode = mode
            return
        if mode == "window":
            self.win_Qs, self.win_W = pick_window(rmax, self.block_frames)
            if self.win_W:
                self.read_mode = "window"

    def vector_params(self):
        """Contiguous packed-row groups (compile_graph slices each group
        from the dense rows in one op)."""
        if self.lane_env:
            return {"gain": [f"lane{k}.gain" for k in range(self.K)]}
        if self.is_bufsrc:
            groups = {}
        elif self.is_const_src:
            groups = {"offset": [f"v{i}.offset" for i in range(self.V)]}
        else:
            groups = {name: [f"v{i}.{name}" for i in range(self.V)]
                      for name in ("frequency", "detune")}
        if self.has_gain:
            groups["gain"] = [f"v{i}.gain" for i in range(self.V)]
        return groups

    def resources(self):
        if self.is_bufsrc:
            return self._grain_resources()
        res = {"starts": self.starts, "stops": self.stops}
        if self.is_const_src:
            res["off_const"] = self.off_const
        else:
            res["ratios"] = self.ratios
            res["freq_const"] = self.freq_const
            res["det_const"] = self.det_const
            res["computed_const"] = self.computed_const
            if self.is_custom:
                res["tables"] = self.tables
        if self.has_gain:
            res["gain_const"] = self.gain_const
        if self.has_filter:
            res["h"] = self.h_stack
        if self.has_pan:
            res["pan_gl"] = self.pan_gl
            res["pan_gr"] = self.pan_gr
        if self.has_shaper:
            res["curves"] = self.curves
        return res

    def _grain_resources(self):
        res = {"starts": self.starts, "stops": self.stops,
               "edge_vals": edge_vals(self.data_host),  # non-loop chains
               "rates": self.rates, "offsets": self.offsets,
               "durations": self.durations}
        if self.win_W:
            # contiguous layout (C, L + W + 2) with the end-of-buffer
            # 'next tap' constant at column L (reached only by the +1
            # lerp tap when the playhead sits on sample L - 1)
            C, L = self.data_host.shape
            ext = np.zeros((C, L + self.win_W + 2), np.float32)
            ext[:, :L] = self.data_host
            ext[:, L] = res["edge_vals"]
            res["data_ext"] = ext
        else:
            res["data_rows"] = pair_rows(self.data_host)
        if self.use_lanes:
            res["offset_pos"] = self.offset_pos
            res["dur_end"] = self.dur_end
            res["lane_start"] = self.lane_start
            res["lane_voice"] = self.lane_voice
        else:
            # closed-form playhead constants, staged (not kept in the
            # kernel) so MixedGraphBatch can stack them per instance: two
            # banks that differ only in per-voice offsets or start times
            # share one plan
            started = self.starts < INF
            delta = np.where(started,
                             self.starts / float(self.fs) - self.start_times,
                             0.0)
            offset_eff = np.clip(self.offsets + delta * self.rates,
                                 0.0, self.buf_duration)
            res["offset_pos"] = offset_eff * self.buf_rate      # (V,) f64
            res["delta_elapsed"] = np.abs(delta * self.rates) * float(self.fs)
            if self.has_gain:
                res["gain_const"] = self.gain_const
        return res

    def tail_frames(self):
        """Closed-form phases and playheads are time-indexed; the cumsum
        path carries unbounded phase state (as the oscillator does); a
        filter stage carries (kparts + 1) partitions of FDL history (as the
        LTI biquad does)."""
        if self.is_bufsrc:
            return 0
        if not self.all_const_freq:
            return None
        if self.has_filter:
            return (self.kparts + 1) * self.partition
        return 0

    def init_state(self):
        if self.is_bufsrc:
            return None
        st = {"phase": torch.zeros((self.V,), dtype=torch.float64,
                                   device=self.device)}
        if self.has_filter:
            fdl = fft_conv.init_state(self.V, self.kparts, self.partition,
                                      self.device)
            st["fdl_spectra"] = fdl["spectra"]
            st["fdl_tail"] = fdl["tail"]
        return st

    def process(self, scope, state, inputs, params):
        if self.use_lanes:
            return state, [self._process_grain_lanes(scope, params)]
        if self.is_bufsrc:
            return state, [self._process_dense(scope, params)]
        return self._process_voices(scope, state, params)

    def _mixdown(self, voices, r):
        """(I, V, B) voices -> (I, 1, B) mono sum, or (I, 2, B) per-voice
        equal-power stereo spread when the chains end in panners."""
        if self.has_pan:
            return torch.stack(
                [(voices * r["pan_gl"][..., None]).sum(-2),
                 (voices * r["pan_gr"][..., None]).sum(-2)], dim=-2)
        return voices.sum(-2, keepdim=True)

    def _process_voices(self, scope, state, params):
        """Oscillator and constant-source banks: (I, V, B) voices, then the
        shaper, filter and gain stages in the chain's order, then the
        mixdown."""
        from ..nodes.oscillator import OscillatorType, waveform
        from ..nodes.oscillator_bank import angle_sum_sine

        r = scope.node_resources
        fs = self.fs
        B = scope.frames
        Q = RENDER_QUANTUM_SIZE
        t = scope.t_idx                                        # (B,)
        starts = r["starts"].to(torch.int64)[..., None]        # (I, V, 1)
        mask = (t >= starts) & (t < r["stops"].to(torch.int64)[..., None])
        new_state = dict(state)

        if self.is_const_src:
            off = self._full(r["off_const"], self.off_dense,
                             params.get("offset"), self.off_lim)
            voices = torch.where(mask, off, 0.0)
        else:
            if self.all_const_freq:
                # closed-form phase, f64 only at quantum granularity
                # (I, V, nq) and f32 within the quantum: |incr*127| < 2^7,
                # so the f32 rebase error is <= ~4e-7 of a cycle
                computed = r["computed_const"][..., None]      # (I, V, 1)
                # / fs as XLA computes it: times 1/fs
                incr_host = computed.to(torch.float64) * (1.0 / fs)
                nq = B // Q
                q0 = t.reshape(nq, Q)[:, 0]
                n0 = (q0 - starts).to(torch.float64)           # (I, V, nq)
                ph0 = torch.remainder((n0 + r["ratios"][..., None])
                                      * incr_host, 1.0).to(torch.float32)
                incr = incr_host.to(torch.float32)             # (I, V, 1)
                if self.kind == OscillatorType.SINE:
                    # the angle-sum sine, as the JAX package computes it
                    wave = angle_sum_sine(ph0, incr, nq)
                else:
                    j = torch.arange(Q, dtype=torch.float32, device=t.device)
                    ph = osc_ops.ramp_f32(ph0[..., None], incr[..., None],
                                          j)                 # (I, V, nq, Q)
                    phase = (ph - torch.floor(ph)).reshape(*ph0.shape[:-1], B)
                    wave = waveform(self.kind, phase, incr, r.get("tables"))
            else:
                freq = self._full(r["freq_const"], self.freq_dense,
                                  params.get("frequency"), self.freq_lim)
                det = self._full(r["det_const"], self.det_dense,
                                 params.get("detune"), self.det_lim)
                computed = osc_ops.computed_frequency(freq, det)   # (N, V, B)
                if self.const_voices.any():
                    keep = self._index(self.const_voices)
                    computed = torch.where(keep[:, None],
                                           r["computed_const"][..., None],
                                           computed)
                incr64 = computed.to(torch.float64) * (1.0 / fs)
                incr = incr64.to(torch.float32)
                at_start = t == starts
                corr = torch.where(at_start, incr64, 0.0).sum(-1) * r["ratios"]
                phase, new_state["phase"] = osc_ops.accumulate_phase(
                    state["phase"], incr64, mask, corr)
                wave = waveform(self.kind, phase, incr, r.get("tables"))
            audible = torch.abs(computed) < fs / 2.0
            voices = torch.where(mask & audible, wave, 0.0)

        if self.has_shaper:
            # one K1 launch over a table of per-voice curves: the voices'
            # rows (instances x voices) against the curves tiled to match
            curves = r["curves"]                               # (I, V, n)
            n = _lead(voices, curves)
            x = voices.expand(n, self.V, B).reshape(n * self.V, B)
            tab = curves.expand(n, *curves.shape[1:]).reshape(
                n * self.V, curves.shape[-1])
            voices = curve_lookup(tab.contiguous(), x.contiguous()
                                  ).reshape(n, self.V, B)
        if self.has_filter:
            st = {"spectra": state["fdl_spectra"], "tail": state["fdl_tail"]}
            x = voices.to(torch.float32).expand(
                (st["tail"].shape[0],) + voices.shape[1:])
            st, voices = fft_conv.partitioned_conv_block(
                st, x, r["h"], self.partition)
            new_state["fdl_spectra"] = st["spectra"]
            new_state["fdl_tail"] = st["tail"]
        if self.has_gain:
            voices = voices * self._full(r["gain_const"], self.gain_dense,
                                         params.get("gain"), self.gain_lim)
        return new_state, [self._mixdown(voices, r).to(torch.float32)]

    def _lane_fields(self, scope):
        """The per-quantum fields of each lane's grain (aligned packing:
        the grain whose start is the last one <= the quantum's last frame
        is the quantum's only possibly-audible grain): ok, start and stop
        frames, the f64 playhead at the quantum's first sample split into
        an integer sample base_i and an f32 fraction base_f, and the f32
        rate.  Each (I, K, nq); on the device, as plain tensor code, since
        they are quantum-sized."""
        r = scope.node_resources
        Q = RENDER_QUANTUM_SIZE
        nq = scope.frames // Q
        tq = scope.t_idx.reshape(nq, Q)
        ls = r["lane_start"].to(torch.int64)                  # (Ir, K, G)
        Ir, K, G = ls.shape
        t_end = tq[:, -1].expand(Ir, K, nq).contiguous()
        gid = torch.searchsorted(ls.contiguous(), t_end, right=True) - 1
        ok = gid >= 0
        gc = torch.clamp(gid, 0, G - 1)
        lv = r["lane_voice"].to(torch.int64)
        v = torch.gather(lv.expand(_lead(lv, gc), K, G), 2,
                         gc.expand(_lead(lv, gc), K, nq))     # (I, K, nq)
        startv = _take(r["starts"].to(torch.int64), v)
        stopv = torch.minimum(_take(r["stops"].to(torch.int64), v),
                              _take(r["dur_end"].to(torch.int64), v))
        rate64 = _take(r["rates"], v) * (self.buf_rate / self.fs)
        n0 = (tq[:, 0] - startv).to(torch.float64)
        pos0 = _take(r["offset_pos"], v) + rate64 * n0
        base = torch.floor(pos0)
        base_f = (pos0 - base).to(torch.float32)
        # an unstarted voice's playhead lies far out of range: saturate as
        # XLA's cast does (every such sample is masked)
        base_i = torch.clamp(base, -2.0**31, 2.0**31 - 1).to(torch.int32)
        fields = {"ok": ok, "startv": startv, "stopv": stopv,
                  "base_i": base_i, "base_f": base_f,
                  "rate32": rate64.to(torch.float32)}
        n = _lead(*fields.values())
        return {k: x.expand(n, K, nq) for k, x in fields.items()}

    def _process_grain_lanes(self, scope, params):
        """Lane-packed grain rendering: (K, B) work instead of (V, B).
        The playhead runs in f64 only at quantum granularity and in f32
        within the quantum as (integer base, fractional offset)."""
        r = scope.node_resources
        B = scope.frames
        L = self.buf_len
        f = self._lane_fields(scope)
        I, K, nq = f["ok"].shape
        gain = params.get("gain")                            # (N, K, B)
        if self.read_mode == "fused":
            # the whole bank in one kernel launch (K2): playhead,
            # schedule and bounds masks, lerp, end-of-buffer edge fix and
            # the clipped per-lane envelope, summed over the K lanes
            ext, edge = r["data_ext"], r["edge_vals"]
            n = _lead(ext, edge)
            i32 = torch.int32
            return grain_bank(
                ext.expand(n, *ext.shape[1:]).contiguous(),
                edge.expand(n, edge.shape[1]).contiguous(),
                f["ok"].to(i32).contiguous(),
                f["startv"].to(i32).contiguous(),
                f["stopv"].to(i32).contiguous(),
                f["base_i"].contiguous(), f["base_f"].contiguous(),
                f["rate32"].contiguous(), gain.contiguous(),
                scope.frame0,
                L, self.gain_lim[0], self.gain_lim[1])

        def per_sample(x):                       # (I, K, nq) -> (I, K, nq, Q)
            return x[..., None]

        t = scope.t_idx.reshape(nq, RENDER_QUANTUM_SIZE)
        sched = (per_sample(f["ok"]) & (t >= per_sample(f["startv"]))
                 & (t < per_sample(f["stopv"])))
        j = torch.arange(RENDER_QUANTUM_SIZE, dtype=torch.float32,
                         device=scope.device)
        delta = per_sample(f["base_f"]) + per_sample(f["rate32"]) * j
        dfloor = torch.floor(delta)
        idx = per_sample(f["base_i"]).to(torch.int64) + dfloor.to(torch.int64)
        frac = (delta - dfloor).reshape(I, K, B)
        valid = (sched & (idx >= 0) & (idx <= L - 1)).reshape(I, K, B)
        piv = torch.clamp(idx, 0, L - 1).reshape(I, K, B)
        edge = r["edge_vals"][:, :, None, None]               # (Ie, C, 1, 1)
        if self.win_W:
            # grouped two-tap lerp (K3; K4's contract in 'window' mode):
            # one group's playhead is monotone, so its taps lie in a
            # window of w samples from the group's first or last tap
            smp = grouped_lerp(r["data_ext"], piv.to(torch.int32), frac,
                               self.win_Qs, self.win_W)       # (I, C, K, B)
            cond = (piv + 1 >= L) & ((frac >= EDGE_FRAC) | (piv == 0))
            smp = smp - edge * torch.where(cond, frac, 0.0)[:, None]
        else:
            # per-sample pair gathers (ops/bufread.py); the end-of-buffer
            # extrapolation 2*x[L-1] - x[L-2] is a staged constant
            a, b = _pairs(r["data_rows"], piv)
            beyond = (piv + 1 >= L)[:, None]
            nxt = torch.where(((frac >= EDGE_FRAC) | (piv == 0))[:, None],
                              0.0, edge)
            b = torch.where(beyond, nxt, b)
            smp = a * (1.0 - frac)[:, None] + b * frac[:, None]
        voices = torch.where(valid[:, None], smp, 0.0)
        if self.has_gain:
            # per-LANE spliced envelope rows (_LaneEnvParam)
            voices = voices * torch.clamp(gain, *self.gain_lim)[:, None]
        return voices.sum(dim=2)                               # (I, C, B)

    def _full(self, const, dense, rows, lim):
        """(I, V, B) param matrix from per-voice constants (I, V) and the
        dense voices' packed rows (N, D, B), clipped to lim."""
        lo, hi = lim
        if len(dense) == self.V:
            # every voice is dense in row order: the rows ARE the matrix
            return torch.clamp(rows, lo, hi)
        B = self.block_frames
        full = const[..., None].expand(const.shape[0], self.V, B)
        if len(dense):
            n = _lead(full, rows)
            full = full.expand(n, self.V, B).clone()
            full[:, self._index(dense)] = torch.clamp(rows, lo, hi)
        return full

    def _index(self, arr):
        """A host index array of this kernel's on its device, staged at
        its first block (an eager one) and reused: a captured walk
        uploads nothing."""
        t = self._staged.get(id(arr))
        if t is None:
            t = self._staged[id(arr)] = torch.as_tensor(arr,
                                                        device=self.device)
        return t

    def _process_dense(self, scope, params):
        """The (V, B) closed-form playhead of every voice
        (nodes/buffer_source.py::_process_closed_form), vectorized."""
        r = scope.node_resources
        fs = float(self.fs)
        ratio = self.buf_rate / fs
        L = self.buf_len
        t = scope.t_idx                                        # (B,)
        starts = r["starts"].to(torch.int64)[..., None]        # (Ir, V, 1)
        mask = (t >= starts) & (t < r["stops"].to(torch.int64)[..., None])
        n_rel = (t - starts).to(torch.float64)
        rates = r["rates"][..., None]
        # sub-sample starts contribute |delta*rate| of elapsed duration up
        # front (nodes/buffer_source.py, reference rs:689)
        dur_ok = (n_rel * torch.abs(rates) + r["delta_elapsed"][..., None]
                  < r["durations"][..., None] * fs)
        pos = r["offset_pos"][..., None] + (rates * ratio) * n_rel
        valid = mask & dur_ok & (pos >= 0.0) & (pos < float(L))
        floored = torch.floor(pos)
        prev_i = torch.clamp(floored, 0.0, float(L - 1)).to(torch.int64)
        frac = (pos - floored).to(torch.float32)               # (I, V, B)
        a, b = _pairs(r["data_rows"], prev_i)                  # (I, C, V, B)
        # non-loop end-of-buffer rule (reference rs:795-815): zero when
        # k ~= 1 or a single-sample buffer, else linear extrapolation from
        # the last two samples (a staged constant, since it only applies
        # at prev_i == L - 1)
        beyond = (prev_i + 1 >= L)[:, None]
        edge = torch.where(((frac >= EDGE_FRAC) | (prev_i == 0))[:, None],
                           0.0, r["edge_vals"][:, :, None, None])
        b = torch.where(beyond, edge, b)
        smp = a * (1.0 - frac)[:, None] + b * frac[:, None]
        voices = torch.where(valid[:, None], smp, 0.0)
        if self.has_gain:
            voices = voices * self._full(
                r["gain_const"], self.gain_dense, params.get("gain"),
                self.gain_lim)[:, None]
        return voices.sum(dim=2)                               # (I, C, B)
