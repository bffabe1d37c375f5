"""Automatic fusion of buffer-source banks: many same-buffer grains -> one
node.

Ported from `webaudio_tpu/graph/fusion.py`, the buffer-source half.  The
reference renders each node as a separate processor; a granular graph of
hundreds of short grains of one sample is hundreds of (1, B) nodes.  This
pass rewrites groups of identical-topology chains

    bufsrc_i -> gain_i -> common targets        (envelope chains)
    bufsrc_i -> common targets                  (plain banks)

into ONE fused node, and sums into the shared mix targets (sum_inputs is
additive, so summing V signals before the edge is exactly the per-edge
sum the unfused graph computes).  Members must play one buffer at a
constant compound rate without a loop, and a gain stage must be Max-mode
with no audio-rate input.

A bank renders one of two ways:
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
WEBAUDIO_FUSE_THRESHOLD (<= 0 disables; default 32).  The oscillator and
constant-source banks and the shaper, filter and pan stages of the JAX
package wait for those nodes' ports.
"""

from __future__ import annotations

import os
from collections import defaultdict

import numpy as np
import torch

from ..automation import SET_VALUE, CompiledParam
from ..constants import RENDER_QUANTUM_SIZE
from ..ops.bufread import edge_vals, pair_rows
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

    sample_rate enables fuse-time grain-lane planning (lane-packed kernels
    and per-lane spliced envelope params)."""
    threshold = fuse_threshold()
    if threshold <= 0 or len(nodes) < threshold:
        return nodes, edges, {}

    from ..nodes.buffer_source import AudioBufferSourceNode
    from ..nodes.gain import GainNode
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

    # candidate chains: (source_id, gain_id_or_None, targets, kind)
    chains = []
    for nid, node in nodes.items():
        # same buffer, constant compound rate, no loop (the granular shape:
        # many short grains of one sample)
        if (not isinstance(node, AudioBufferSourceNode)
                or node.buffer is None or node.loop
                or (nid, "playback_rate") in param_in
                or (nid, "detune") in param_in
                or not _const(node.params["playback_rate"])
                or not _const(node.params["detune"])):
            continue
        kind = ("bufsrc", id(node.buffer))
        outs = out_edges.get(nid, [])
        if not outs or any(e.src_output != 0 for e in outs):
            continue
        gain = None
        if (len(outs) == 1 and outs[0].param is None
                and outs[0].dst_input == 0
                and isinstance(nodes.get(outs[0].dst), GainNode)):
            g = outs[0].dst
            if (g != dest_id and audio_in[g] == 1
                    and (g, "gain") not in param_in
                    and out_edges.get(g)
                    # an explicit/clamped channel count up-mixes *inside*
                    # the chain and changes downstream channel propagation;
                    # only Max-mode (pass-through width) gains fuse
                    and nodes[g]._channel_config.mode == ChannelCountMode.MAX):
                gain = g
                outs = out_edges[g]
        targets = tuple(sorted(
            (e.dst, e.dst_input, e.param or "") for e in outs))
        chains.append((nid, gain, targets, kind))

    # group by (buffer, chain shape, target signature)
    groups: dict = defaultdict(list)
    for nid, gain, targets, kind in chains:
        groups[(kind, gain is not None, targets)].append((nid, gain))

    # drop groups whose targets point at nodes another group removes
    # (an env gain feeding another candidate's gain); iterate to a fixed
    # point
    live = {k: v for k, v in groups.items() if len(v) >= threshold}
    while True:
        removed = set()
        for members in live.values():
            for nid, gain in members:
                removed.add(nid)
                if gain is not None:
                    removed.add(gain)
        bad = [k for k in live if any(t[0] in removed for t in k[2])]
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
    for (kind, _has_gain, targets), members in \
            sorted(live.items(), key=lambda kv: min(m[0] for m in kv[1])):
        members = sorted(members)
        fid = -(1 + min(m[0] for m in members))  # deterministic, unique
        nodes2[fid] = _FusedVoicesNode(
            fid, [nodes[m[0]] for m in members],
            [nodes[m[1]] if m[1] is not None else None for m in members],
            kind, sample_rate=sample_rate)
        for i, (onid, gnid) in enumerate(members):
            removed.add(onid)  # constant rates: no packed rows to remap
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
    real AudioParams through `compile_for_render`."""

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
                           start_frame: int = 0):
        row = np.zeros(length, np.float32)
        for i in self._members:
            g = self._gains[i].params["gain"]
            mplan = g.compile_for_render(sample_rate, length, start_frame)
            vals = mplan.scalar if mplan.is_constant else mplan.dense
            self._splice(row, i, vals, g, start_frame, length)
        return CompiledParam(None, row, 0.0, None)


class _FusedVoicesNode:
    """Synthetic graph node standing in for V fused source chains.

    Exposes exactly the protocol compile_graph consumes: node_id, params
    (the member AudioParams re-homed under per-voice aliases, or the
    per-lane spliced envelopes), channel config, and make_kernel."""

    number_of_inputs = 0
    number_of_outputs = 1

    def __init__(self, fid, sources, gains, kind, sample_rate=None):
        self.node_id = fid
        # block-size budget: the dense path materializes ~(V, B) f64
        # temporaries, i.e. ~4V times a single node's (1, B) f32 buffers
        self.compile_weight = 4 * len(sources)
        self.sources = sources
        self.gains = gains
        self.kind = kind  # ("bufsrc", id(buffer))
        self._channel_config = sources[0]._channel_config
        self.lane_plan = None
        self.lane_env = False
        if sample_rate is not None:
            self.lane_plan = _plan_grain_lanes(sources, float(sample_rate))
            if self.lane_plan.use_lanes:
                # lane-packed temporaries are (K, B), not (V, B): budget on
                # K so the block policy can pick render-sized blocks
                self.compile_weight = 4 * self.lane_plan.K + 4
        self._params = {}
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

    def output_channel_count(self, input_counts):
        return [self.sources[0].buffer.number_of_channels]

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


class _FusedVoicesKernel(Kernel):
    """A fused buffer-source bank: lane-packed (K, B) grain rendering, or
    the (V, B) closed-form playhead of `nodes/buffer_source.py`."""

    # read only via staged resources: data_host feeds data_rows/edge_vals/
    # data_ext; start_times feeds the staged offset_pos/delta_elapsed and
    # lane tables.  Same-shape different-value banks may bucket together
    # in MixedGraphBatch (their staged leaves stack per instance).
    _fp_staged_attrs = ("data_host", "start_times")

    def __init__(self, node: _FusedVoicesNode, rc):
        self.fs = rc.sample_rate
        self.block_frames = rc.block_frames
        self.V = len(node.sources)
        self.win_Qs = 0        # read geometry (_pick_window)
        self.win_W = 0
        self.read_mode = "gather"
        self.has_gain = node.gains[0] is not None
        self.lane_env = node.lane_env
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
        if self.has_gain:
            g0 = node.gains[0].params["gain"]
            self.gain_lim = (float(np.float32(g0.min_value)),
                             float(np.float32(g0.max_value)))
        if self.has_gain and not self.lane_env:
            plans = rc.param_plans
            const = np.zeros(self.V, np.float32)
            dense_pos = []
            for i in range(self.V):
                plan = plans[f"v{i}.gain"]
                p = node.gains[i].params["gain"]
                if plan.is_constant:
                    const[i] = np.float32(
                        min(max(plan.scalar, p.min_value), p.max_value))
                else:
                    dense_pos.append(i)
            self.gain_const = const
            self.gain_dense = np.asarray(dense_pos, np.int64)

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
        if self.has_gain:
            return {"gain": [f"v{i}.gain" for i in range(self.V)]}
        return {}

    def resources(self):
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

    def process(self, scope, state, inputs, params):
        if self.use_lanes:
            return state, [self._process_grain_lanes(scope, params)]
        return state, [self._process_dense(scope, params)]

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
                f["rate32"].contiguous(), gain.contiguous(), scope.frame0,
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

    def _full(self, const, rows):
        """(I, V, B) gain matrix from per-voice constants + packed rows."""
        lo, hi = self.gain_lim
        dense = self.gain_dense
        if len(dense) == self.V:
            # every voice is dense in row order: the rows ARE the matrix
            return torch.clamp(rows, lo, hi)
        B = self.block_frames
        full = const[..., None].expand(const.shape[0], self.V, B)
        if len(dense):
            n = _lead(full, rows)
            full = full.expand(n, self.V, B).clone()
            full[:, torch.as_tensor(dense, device=full.device)] = \
                torch.clamp(rows, lo, hi)
        return full

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
            voices = voices * self._full(r["gain_const"],
                                         params.get("gain"))[:, None]
        return voices.sum(dim=2)                               # (I, C, B)
