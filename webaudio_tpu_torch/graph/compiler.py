"""Graph compiler and block renderer: node topology -> a walk over blocks.

This replaces the reference's per-quantum interpreted executor
(reference: src/render/graph.rs:490-587, src/render/thread.rs:260-396) with
plan-then-run: the node DAG is ordered once, every node contributes a
functional ``process`` over (instances, channels, frames) tensors, and a
Python loop runs the whole topology block by block:

    (states, frame0), (param rows) -> (states', dest block)

Ported from `webaudio_tpu/graph/compiler.py`.  The acyclic block plan
(block size, padding) is the JAX package's, unchanged.  Each block runs
eagerly on the context's device; node states are dicts of tensors carried
from one block to the next.

There is one block walk, and it renders N instances of the graph at once:
the JAX package's `vmap` over `scan_render` written out as a leading
instance axis.  Signals are (N, C, B), dense params (N, 1, B), constant
params shared 0-d tensors, every state leaf (N, ...), and every resource
leaf (1, ...) when the instances share it or (N, ...) when each has its
own (`convert.stage_resources`).  `render_compiled` (the offline context)
runs it with N = 1; `parallel/batch.py::GraphBatch` with N instances.

Source fusion (`graph/fusion.py`) rewrites banks of same-buffer buffer
sources into one node before planning, as the JAX package does.  Feedback
cycles and the two-rate cycle compiler are not ported yet: a graph that
needs one raises `NotSupportedError`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from ..constants import (
    RENDER_QUANTUM_SIZE, DEFAULT_QUANTA_PER_BLOCK, NotSupportedError,
)
from ..convert import batch_states, stage_resources, unbatch_states
from ..ops.cuda_lib import KernelError
from ..ops.mixing import (
    ChannelInterpretation, computed_number_of_channels, sum_inputs,
)
from .ir import Edge, order_graph


@dataclass
class RenderContext:
    """Static per-node compile info handed to `AudioNode.make_kernel`."""
    sample_rate: float
    block_frames: int
    input_channel_counts: list[int]
    device: torch.device
    # this node's compiled param timelines (name -> CompiledParam), so
    # kernels can pick const-specialized strategies and read baked values
    param_plans: dict = field(default_factory=dict)


class BlockScope:
    """Per-block values available to kernels (the analog of
    AudioWorkletGlobalScope, reference: src/render/processor.rs:20-27).
    `frame0` and the instance count `n` are host ints; `t_idx` and
    `active_mask` are device tensors shared by all instances."""

    __slots__ = ("frame0", "frames", "n", "device", "_t_idx",
                 "node_resources")

    def __init__(self, frame0: int, frames: int, n: int, device):
        self.frame0 = int(frame0)
        self.frames = frames
        self.n = n
        self.device = device
        self._t_idx = None
        # this node's staged resources (audio buffers, IR spectra, curves)
        self.node_resources = None

    @property
    def t_idx(self) -> torch.Tensor:
        """Global sample indices of this block, (B,) int64."""
        if self._t_idx is None:
            self._t_idx = torch.arange(self.frame0, self.frame0 + self.frames,
                                       dtype=torch.int64, device=self.device)
        return self._t_idx

    def active_mask(self, start_frame: int, stop_frame: int) -> torch.Tensor:
        """Sub-sample-exact scheduling mask: sample n is active iff
        n*dt >= start_time and n*dt < stop_time, reduced host-side to
        integer frame bounds (reference: constant_source.rs:232-249)."""
        t = self.t_idx
        return (t >= min(start_frame, 2**31 - 1)) & (t < min(stop_frame, 2**31 - 1))


class Kernel:
    """Per-node functional processor.

    `process` maps (scope, state, inputs, params) -> (state', [outputs]).
    inputs: list over input ports of (N, C_in, B) f32 tensors (pre-mixed
    fan-in).  params: dict name -> () or (N, 1, B) f32 (clamped, audio
    input summed).  state: the `init_state()` tree with a leading N on
    every leaf.  `scope.node_resources` holds the `resources()` leaves with
    a leading axis of 1 (shared) or N (per instance).  Outputs are
    (N, C, B), or (1, C, B) when every instance's output is the same.  A
    kernel returns new tensors and never writes into its inputs or its old
    state."""

    def init_state(self):
        """One instance's initial state (the walk adds the instance axis)."""
        return None

    def resources(self):
        """Static device data this kernel needs (numpy, staged once per
        compiled graph); read back in `process` via `scope.node_resources`."""
        return None

    def process(self, scope: BlockScope, state, inputs, params):
        raise NotImplementedError


@dataclass
class CompiledGraph:
    """A render plan for one graph snapshot."""
    block_fn: Any
    order: list
    kernels: dict
    param_plan: dict          # (nid, pname) -> CompiledParam
    block_frames: int
    total_frames: int
    device: torch.device
    sample_rate: float
    in_counts: dict
    out_counts: dict
    resource_cache: Any = None
    failed: dict = field(default_factory=dict)
    dense_params: list = field(default_factory=list)  # packed row order
    param_alias: dict = field(default_factory=dict)   # fused (nid, p) remaps


def _propagate_channel_counts(nodes, edges):
    """Static fixpoint of the reference's dynamic per-quantum channel
    counting (graph.rs:524-535).  Counts only grow and are bounded by
    MAX_CHANNELS, so iteration converges."""
    out_counts = {nid: node.output_channel_count([1] * node.number_of_inputs)
                  for nid, node in nodes.items()}
    in_counts = {nid: [1] * node.number_of_inputs for nid, node in nodes.items()}
    in_edges = {nid: [[] for _ in range(node.number_of_inputs)]
                for nid, node in nodes.items()}
    for e in edges:
        if e.param is None and e.dst in in_edges and e.dst_input >= 0:
            in_edges[e.dst][e.dst_input].append(e)

    for _ in range(len(nodes) + 2):
        changed = False
        for nid, node in nodes.items():
            cfg = node._channel_config
            new_in = []
            for i in range(node.number_of_inputs):
                mx = 0
                for e in in_edges[nid][i]:
                    mx = max(mx, out_counts[e.src][e.src_output])
                new_in.append(computed_number_of_channels(cfg.mode, cfg.count, mx))
            new_out = node.output_channel_count(new_in)
            if new_in != in_counts[nid] or new_out != out_counts[nid]:
                changed = True
                in_counts[nid] = new_in
                out_counts[nid] = new_out
        if not changed:
            break
    return in_counts, out_counts, in_edges


def compile_graph(nodes: dict, edges: list[Edge], sample_rate: float,
                  total_frames: int, dest_id: int, device,
                  start_frame: int = 0) -> CompiledGraph:
    """Plan a graph snapshot: block size, node order, param rows, kernels."""
    from . import fusion as _fusion

    device = torch.device(device)
    # rewrite homogeneous source chains into fused banks before anything
    # looks at the topology (see graph/fusion.py)
    nodes, edges, param_alias = _fusion.fuse_sources(
        nodes, edges, dest_id, sample_rate=sample_rate)
    ordered = order_graph(list(nodes.keys()), list(edges), set())
    if ordered.has_cycle:
        raise NotSupportedError(
            "graphs with cycles are not ported to webaudio_tpu_torch yet")

    total_quanta = -(-total_frames // RENDER_QUANTUM_SIZE)
    # pick the largest divisor of the total quantum count <= a memory-aware
    # cap, so the blocks cover exactly ceil(T/128) quanta; partitioned-FFT
    # kernels (the biquad's truncated IR) want blocks with a large
    # power-of-two factor, since their partition is the block's largest
    # pow2 divisor (choose_partition).  The plan is the JAX package's,
    # unchanged, so both packages pick the same block and padding.
    weight = sum(getattr(n, "compile_weight", 1) for n in nodes.values())
    budget_frames = (1 << 25) // max(weight, 1)
    max_qpb = max(DEFAULT_QUANTA_PER_BLOCK,
                  budget_frames // RENDER_QUANTUM_SIZE)
    qpb = 1
    best8 = 0
    pow2_only = any(getattr(n, "block_constraint", lambda: None)() == "pow2"
                    for n in nodes.values())
    wants_pow2 = any(getattr(n, "wants_pow2_partitions", False)
                     for n in nodes.values())
    for d in range(min(max_qpb, total_quanta), 0, -1):
        if total_quanta % d == 0 and (not pow2_only or (d & (d - 1)) == 0):
            if qpb == 1:
                qpb = d
            if d % 8 == 0:
                best8 = d
                break
            if not wants_pow2:
                break
    if wants_pow2:
        # candidates: the largest exact divisor, the largest pow2 <= cap,
        # the first multiple-of-8 divisor, and the padded default; keep
        # those whose pow2 content supports a >= 4096-sample partition and
        # minimize padded work plus a per-block overhead of ~16 quanta
        cap = min(max_qpb, max(total_quanta, 1))
        cands = {qpb, 1 << (cap.bit_length() - 1)}
        if best8:
            cands.add(best8)
        if total_quanta > DEFAULT_QUANTA_PER_BLOCK:
            cands.add(DEFAULT_QUANTA_PER_BLOCK)

        def _content(q):
            bf = q * RENDER_QUANTUM_SIZE
            return bf & -bf

        good = [q for q in cands if _content(q) >= 4096]
        if good:
            cands = good

        def _cost(q):
            nb = -(-total_quanta // q)
            return (nb * q + 16 * nb, -_content(q))

        qpb = min(cands, key=_cost)
    if qpb < 24 and total_quanta > DEFAULT_QUANTA_PER_BLOCK:
        qpb = DEFAULT_QUANTA_PER_BLOCK
    block_frames = qpb * RENDER_QUANTUM_SIZE

    in_counts, out_counts, in_edges = _propagate_channel_counts(nodes, edges)

    # param audio connections: (dst_nid, param_name) -> [(src, src_output)]
    param_edges: dict = {}
    for e in edges:
        if e.param is not None:
            param_edges.setdefault((e.dst, e.param), []).append((e.src, e.src_output))

    # compile every param timeline over the render range
    param_plan = {}
    for nid, node in nodes.items():
        for pname, p in node.params.items():
            param_plan[(nid, pname)] = p.compile_for_render(
                sample_rate, _pad_len(total_frames, block_frames), start_frame)

    # dense params are packed into one (P, B) tensor per block
    dense_params = [key for key, plan in param_plan.items()
                    if not plan.is_constant]
    dense_index = {key: i for i, key in enumerate(dense_params)}

    # build kernels
    kernels = {}
    failed: dict = {}
    for nid, node in nodes.items():
        rc = RenderContext(
            sample_rate=sample_rate,
            block_frames=block_frames,
            input_channel_counts=in_counts[nid],
            device=device,
            param_plans={pname: param_plan[(nid, pname)]
                         for pname in node.params},
        )
        try:
            kernels[nid] = node.make_kernel(rc)
        except (NotSupportedError, KernelError):
            # capability fences and kernel build faults are environment
            # errors, not processor bugs: muting the node would hide them
            raise
        except Exception as exc:
            # a processor whose construction throws is isolated exactly like
            # a process()-time failure: its outputs are silent,
            # onprocessorerror fires, the rest of the graph renders
            # (reference: worklet.rs:301-321 + graph.rs:507-521)
            failed[nid] = exc
            kernels[nid] = Kernel()
            cb = getattr(node, "_onprocessorerror", None)
            if cb is not None:
                cb(exc)

    interp_of = {nid: nodes[nid]._channel_config.interpretation for nid in nodes}
    constants = {}
    for (nid, pname), plan in param_plan.items():
        if plan.is_constant:
            p = nodes[nid].params[pname]
            constants[(nid, pname)] = torch.tensor(
                min(max(plan.scalar, p.min_value), p.max_value),
                dtype=torch.float32, device=device)

    def block_fn(states, frame0, xs_params, resources):
        """One block of N instances: run every node in topological order.
        xs_params: (N, P, B) dense param rows; returns (states', the
        destination's (N, C, B) output)."""
        n = xs_params.shape[0]
        scope = BlockScope(frame0, block_frames, n, device)
        signals: dict = {}
        new_states = dict(states)

        def silence(channels):
            return torch.zeros((n, channels, block_frames),
                               dtype=torch.float32, device=device)

        def gather_inputs(nid, node):
            ins = []
            for i in range(node.number_of_inputs):
                sigs = [signals[(e.src, e.src_output)]
                        for e in in_edges[nid][i]
                        if (e.src, e.src_output) in signals]
                ins.append(sum_inputs(sigs, in_counts[nid][i],
                                      interp_of[nid], block_frames, device,
                                      batch=n))
            return ins

        def gather_params(nid, node):
            vp = getattr(kernels[nid], "vector_params", None)
            if vp is not None:
                # fused kernels consume whole packed-row groups: one slice
                # (N, rows, B) per group (a fused node registers its
                # aliases grouped by param kind, so group rows are
                # contiguous)
                out = {}
                for gname, aliases in vp().items():
                    rows = [dense_index[(nid, a)] for a in aliases
                            if (nid, a) in dense_index]
                    if not rows:
                        out[gname] = None
                        continue
                    r0 = rows[0]
                    if rows != list(range(r0, r0 + len(rows))):
                        raise AssertionError("fused param rows not contiguous")
                    out[gname] = xs_params[:, r0:r0 + len(rows), :]
                return out
            out = {}
            for pname, p in node.params.items():
                if (nid, pname) in constants:
                    val = constants[(nid, pname)]
                else:
                    i = dense_index[(nid, pname)]
                    val = xs_params[:, i:i + 1, :]                   # (N, 1, B)
                aedges = param_edges.get((nid, pname))
                if aedges:
                    sigs = [signals[s] for s in aedges if s in signals]
                    audio = sum_inputs(sigs, 1, ChannelInterpretation.SPEAKERS,
                                       block_frames, device, batch=n)
                    if not p.automation_rate.is_a_rate:
                        q = audio.reshape(n, 1, -1, RENDER_QUANTUM_SIZE)[..., :1]
                        audio = q.expand(n, 1, q.shape[2], RENDER_QUANTUM_SIZE
                                         ).reshape(n, 1, block_frames)
                    val = p.clamp(val + audio)
                elif (nid, pname) not in constants:
                    val = torch.clamp(val, *p.f32_bounds())
                out[pname] = val
            return out

        for nid, _role in ordered.order:
            node = nodes[nid]
            kern = kernels[nid]
            scope.node_resources = resources.get(_k(nid))
            if nid in failed:
                for oi, c in enumerate(out_counts[nid]):
                    signals[(nid, oi)] = silence(c)
                continue
            # per-node failure isolation: a processor that throws is removed
            # from the graph (its outputs go silent) and the rest keeps
            # rendering (reference: graph.rs:507-521,
            # tests/processor_error.rs).  Kernel faults are not processor
            # errors and propagate.
            try:
                ins = gather_inputs(nid, node)
                prm = gather_params(nid, node)
                st, outs = kern.process(scope, states.get(_k(nid)), ins, prm)
                new_states[_k(nid)] = st
                for oi, o in enumerate(outs):
                    # an output shared by all instances broadcasts (a view)
                    signals[(nid, oi)] = o.expand((n,) + o.shape[1:])
            except (NotSupportedError, KernelError):
                raise
            except Exception as exc:
                failed[nid] = exc
                for oi, c in enumerate(out_counts[nid]):
                    signals[(nid, oi)] = silence(c)
                cb = getattr(node, "_onprocessorerror", None)
                if cb is not None:
                    cb(exc)

        return new_states, signals[(dest_id, 0)]

    return CompiledGraph(
        block_fn=block_fn, order=ordered.order, kernels=kernels,
        param_plan=param_plan, block_frames=block_frames,
        total_frames=total_frames, device=device, sample_rate=sample_rate,
        in_counts=in_counts, out_counts=out_counts, failed=failed,
        dense_params=dense_params, param_alias=param_alias)


def collect_resources(cg: CompiledGraph) -> dict:
    """Gather each kernel's static data (numpy, one instance's; staged once
    per compiled graph, reused across renders)."""
    out = {}
    for nid, kern in cg.kernels.items():
        r = kern.resources()
        if r is not None:
            out[_k(nid)] = r
    return out


def _k(nid: int) -> str:
    return f"n{nid}"


def zero_states(cg: CompiledGraph) -> dict:
    """One instance's zero states for every kernel."""
    return {_k(nid): k.init_state() for nid, k in cg.kernels.items()}


def pack_dense_params(cg: CompiledGraph, padded: int,
                      plans: Optional[dict] = None) -> np.ndarray:
    """Stack the dense param arrays in `cg.dense_params` row order into one
    (P, padded) f32 array (edge-padded to `padded` frames)."""
    plans = plans or cg.param_plan
    rows = np.zeros((len(cg.dense_params), padded), np.float32)
    for i, key in enumerate(cg.dense_params):
        arr = plans[key].dense
        n = min(len(arr), padded)
        rows[i, :n] = arr[:n]
        if n < padded:
            rows[i, n:] = arr[-1]
    return rows


def block_rows(packed: np.ndarray, block_frames: int) -> np.ndarray:
    """(..., P, padded) dense rows -> (..., nb, P, B): the layout the block
    walk reads block b from."""
    *lead, P, padded = packed.shape
    nb = padded // block_frames
    return np.swapaxes(packed.reshape(*lead, P, nb, block_frames), -3, -2)


def _pad_len(total_frames: int, block_frames: int) -> int:
    nb = -(-total_frames // block_frames)
    return nb * block_frames


def scan_render(cg: CompiledGraph, states: dict, frame0s, xs: torch.Tensor,
                resources: dict):
    """The block walk over a whole render: N instances, block by block.

    states: leaves (N, ...); frame0s: host ints, one per block; xs:
    (N, nb, P, B) dense rows on the device; resources: staged with their
    leading 1 or N axis.  Returns (final states, (N, C, nb*B) output)."""
    outs = []
    for b, frame0 in enumerate(frame0s):
        states, out = cg.block_fn(states, frame0, xs[:, b], resources)
        outs.append(out)
    return states, torch.cat(outs, dim=-1)


def render_args(cg: CompiledGraph, total_frames: int, start_frame: int = 0,
                init_states: Optional[dict] = None):
    """Stage (states, frame0s, xs, resources) for `scan_render` with one
    instance: dense params as one (1, nb, P, B) f32 tensor on the device,
    zero states for every kernel unless given (unbatched, as
    `zero_states` returns them), resources staged once per compiled
    graph."""
    B = cg.block_frames
    padded = _pad_len(total_frames, B)
    nb = padded // B
    xs = torch.from_numpy(block_rows(pack_dense_params(cg, padded), B)[None]
                          .copy()).to(cg.device)
    frame0s = [start_frame + b * B for b in range(nb)]
    if init_states is None:
        init_states = zero_states(cg)
    if cg.resource_cache is None:
        cg.resource_cache = stage_resources(collect_resources(cg), cg.device)
    return batch_states(init_states, 1), frame0s, xs, cg.resource_cache


def render_compiled(cg: CompiledGraph, total_frames: int,
                    start_frame: int = 0, init_states: Optional[dict] = None):
    """Execute a compiled graph over [start_frame, start_frame+total_frames)
    as one instance of the block walk.

    Returns `(output (C, padded_frames) tensor on the device, final_states)`
    where padded_frames rounds total_frames up to the block size and the
    states carry no instance axis."""
    final, out = scan_render(cg, *render_args(cg, total_frames, start_frame,
                                              init_states))
    return out[0], unbatch_states(final)
