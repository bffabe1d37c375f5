"""Graph compiler and block renderer: node topology -> a walk over blocks.

This replaces the reference's per-quantum interpreted executor
(reference: src/render/graph.rs:490-587, src/render/thread.rs:260-396) with
plan-then-run: the node DAG is ordered once, every node contributes a
functional ``process`` over (instances, channels, frames) tensors, and a
Python loop runs the whole topology block by block:

    (states, frame0), (param rows) -> (states', dest block)

Ported from `webaudio_tpu/graph/compiler.py`.  The acyclic block plan
(block size, padding) is the JAX package's, unchanged.  Node states are
dicts of tensors carried from one block to the next, and the block's first
frame is device data (`BlockScope.frame0`, a 0-d int64 tensor), as it is
under JAX's trace.  So one block's work depends on nothing the host reads
or uploads, and on the card `scan_render` captures it once per plan as a
CUDA graph and replays it a block at a time: the counterpart of JAX's
`jax.jit(scan_render)`.  `WEBAUDIO_CUDA_GRAPHS=0` walks every block
eagerly with the same kernels (the counterpart of `jax.disable_jit`);
plans with host callbacks or user code always do (`CompiledGraph.capture`
says why).

There is one block walk, and it renders N instances of the graph at once:
the JAX package's `vmap` over `scan_render` written out as a leading
instance axis.  Signals are (N, C, B), dense params (N, 1, B), constant
params shared 0-d tensors, every state leaf (N, ...), and every resource
leaf (1, ...) when the instances share it or (N, ...) when each has its
own (`convert.stage_resources`).  `render_args` stages a walk of one
instance for every driver that renders one (the offline and online
contexts, `RenderSession`, time segments, `render_compiled`);
`parallel/batch.py::GraphBatch` stages N instances.

Source fusion (`graph/fusion.py`) rewrites banks of same-buffer buffer
sources into one node before planning, as the JAX package does.

Feedback cycles run through the cycle-breaking DelayNode, split into a
writer and a reader vertex (graph/ir.py).  The delay bounds the block of
the nodes on a cycle, so the two-rate compiler steps each cycle group at
an inner block of `inner_frames` frames, `two_rate_m` sub-steps a block,
while the acyclic rest runs the outer block; the plan is the JAX
package's.  The inner loop is a Python loop over sub-steps here (JAX: a
`lax.scan`), with the same math per sub-step, so a two-rate render is
bit-equal to one that steps every node at the inner block
(`WEBAUDIO_TWO_RATE=0`) or one quantum at a time (`WEBAUDIO_CYCLE_BLOCKS=1`).
A group that is one constant feedback-delay loop (a delay and a chain of
gains, all constant: `_constant_loop`) skips the sub-steps: one call of
`ops/feedback.py::feedback_delay` walks its whole block, with the same
arithmetic frame by frame (`CompiledGraph.cycle_paths` says which groups).
"""

from __future__ import annotations

import contextlib
import gc
import os
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from ..constants import (
    RENDER_QUANTUM_SIZE, DEFAULT_QUANTA_PER_BLOCK, NotSupportedError,
)
from ..convert import batch_states, stage_resources, unbatch_states
from ..diagnostics import recording, span
from ..ops.cuda_lib import KernelError, launch_counters
from ..ops.feedback import MAX_GAINS, feedback_delay
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
    # a cycle-breaking delay whose writer->reader edge was cut
    in_cycle: bool = False
    # this node's compiled param timelines (name -> CompiledParam), so
    # kernels can pick const-specialized strategies and read baked values
    param_plans: dict = field(default_factory=dict)
    # per input port: does any edge feed it?  (the reference's
    # spec-compliant-worklet-inputs empty-vs-silent distinction,
    # worklet.rs:367-385)
    input_connected: list = field(default_factory=list)


class BlockScope:
    """Per-block values available to kernels (the analog of
    AudioWorkletGlobalScope, reference: src/render/processor.rs:20-27).
    `frame0` is the block's first frame as a 0-d int64 tensor on the
    walk's device, as JAX traces it; `t_idx` and `active_mask` are device
    tensors shared by all instances; the instance count `n` is a host int.
    `frame0_host` is the same frame as a host int, set only in an eager
    walk (`eager`): there kernels read the block's position on the host
    (slices, host branches) and the device scalar is made only where a
    kernel asks for it.  Inside a captured walk they compute on the device
    scalar, and reading `frame0_host` raises, so a plan whose kernels need
    it stays eager (`CompiledGraph.capture`).  A host int given as
    `frame0` makes an eager scope."""

    __slots__ = ("_frame0", "frames", "n", "device", "_t_idx", "_base",
                 "_frame0_host", "node_resources")

    def __init__(self, frame0, frames: int, n: int, device,
                 frame0_host: Optional[int] = None, base=None, t_idx=None):
        if not isinstance(frame0, (torch.Tensor, type(None))):
            frame0, frame0_host = None, int(frame0)
        self._frame0 = frame0
        self.frames = frames
        self.n = n
        self.device = device
        self._frame0_host = frame0_host
        # arange(frames) on the device, made once per plan
        self._base = base
        self._t_idx = t_idx
        # this node's staged resources (audio buffers, IR spectra, curves)
        self.node_resources = None

    @property
    def eager(self) -> bool:
        """Whether the block's position is known on the host."""
        return self._frame0_host is not None

    @property
    def frame0_host(self) -> int:
        """The block's first frame on the host (eager walks only)."""
        if self._frame0_host is None:
            raise KernelError(
                "a kernel read the block's host frame0 inside a captured "
                "walk; a plan with such a kernel must stay eager "
                "(CompiledGraph.capture)")
        return self._frame0_host

    @property
    def frame0(self) -> torch.Tensor:
        """The block's first frame, a 0-d int64 tensor on the device."""
        if self._frame0 is None:
            self._frame0 = torch.full((), self._frame0_host,
                                      dtype=torch.int64, device=self.device)
        return self._frame0

    @property
    def arange(self) -> torch.Tensor:
        """arange(B), (B,) int64 on the device."""
        if self._base is None:
            self._base = torch.arange(self.frames, dtype=torch.int64,
                                      device=self.device)
        return self._base

    @property
    def t_idx(self) -> torch.Tensor:
        """Global sample indices of this block, (B,) int64."""
        if self._t_idx is None:
            f0 = self._frame0_host
            self._t_idx = (self.frame0 + self.arange if f0 is None else
                           torch.arange(f0, f0 + self.frames,
                                        dtype=torch.int64,
                                        device=self.device))
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

    def tail_frames(self):
        """How much history this kernel's state encodes, in frames, or
        None if unbounded (not time-shardable).  A kernel with a bounded
        tail can start from zero state `tail_frames` early and converge:
        the basis of segment rendering (parallel/segments.py)."""
        return None

    def process(self, scope: BlockScope, state, inputs, params):
        raise NotImplementedError

    # why this kernel's plan cannot be captured as a CUDA graph (a host
    # callback, user code), or None
    capture_refusal: Optional[str] = None


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
    resource_cache: Any = None   # the staged resources (`render_args`)
    failed: dict = field(default_factory=dict)
    dense_params: list = field(default_factory=list)  # packed row order
    param_alias: dict = field(default_factory=dict)   # fused (nid, p) remaps
    param_objects: dict = field(default_factory=dict)  # (nid, p) -> param
    muted: set = field(default_factory=set)          # in delay-free cycles
    cycle_breakers: set = field(default_factory=set)  # cut delays' ids
    cycle_groups: list = field(default_factory=list)  # broken SCCs, in order
    # how each group walks a block: "fused" (a constant feedback-delay
    # loop, one launch: `_constant_loop`) or "stepped" (two-rate sub-steps,
    # or every node at the single-rate block)
    cycle_paths: list = field(default_factory=list)
    two_rate_m: int = 1        # inner sub-steps per block (1 = single-rate)
    inner_frames: int = 0      # delay-bounded inner block (frames)
    # True, or why the walk stays eager on the card ("NodeType #id: ...")
    capture: Any = True
    # the block's CUDA graphs by what they were captured for (_graph_key)
    graphs: dict = field(default_factory=dict)
    warm: set = field(default_factory=set)   # keys walked eagerly once
    walks: int = 0                            # walks of the plan so far


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


def _budget_quanta(nodes) -> int:
    """Quanta a block may hold under the compile-weight memory budget
    (2^25 frames shared by the nodes' weights)."""
    weight = sum(getattr(n, "compile_weight", 1) for n in nodes)
    return ((1 << 25) // max(weight, 1)) // RENDER_QUANTUM_SIZE


def _pow2_only(nodes) -> bool:
    return any(getattr(n, "block_constraint", lambda: None)() == "pow2"
               for n in nodes)


def _wants_pow2(nodes) -> bool:
    """Partitioned-FFT kernels (the biquad's truncated IR, the convolver,
    the IIR filter) take the block's largest pow2 divisor as partition."""
    return any(getattr(n, "wants_pow2_partitions", False) for n in nodes)


def _content(quanta: int) -> int:
    """The largest power of two dividing a block of `quanta` quanta, in
    frames: the partition a partitioned-FFT kernel gets there."""
    bf = quanta * RENDER_QUANTUM_SIZE
    return bf & -bf


def _acyclic_qpb(nodes, total_quanta: int) -> int:
    """Quanta per block of an acyclic graph: the largest divisor of the
    total quantum count <= a memory-aware cap, so the blocks cover exactly
    ceil(T/128) quanta; partitioned-FFT kernels want blocks with a large
    power-of-two factor (`_content`).  The plan is the JAX package's,
    unchanged, so both packages pick the same block and padding."""
    max_qpb = max(DEFAULT_QUANTA_PER_BLOCK, _budget_quanta(nodes.values()))
    qpb = 1
    best8 = 0
    pow2_only = _pow2_only(nodes.values())
    wants_pow2 = _wants_pow2(nodes.values())
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
        good = [q for q in cands if _content(q) >= 4096]
        if good:
            cands = good

        def _cost(q):
            nb = -(-total_quanta // q)
            return (nb * q + 16 * nb, -_content(q))

        qpb = min(cands, key=_cost)
    if qpb < 24 and total_quanta > DEFAULT_QUANTA_PER_BLOCK:
        qpb = DEFAULT_QUANTA_PER_BLOCK
    return qpb


def compile_graph(nodes: dict, edges: list[Edge], sample_rate: float,
                  total_frames: int, dest_id: int, device,
                  start_frame: int = 0,
                  quanta_per_block: Optional[int] = None,
                  force_dense_params: bool = False) -> CompiledGraph:
    """Plan a graph snapshot: block size, node order, param rows, kernels.

    `quanta_per_block` fixes the block (the fixed step of RenderSession and
    of time segments) instead of the chooser; a cyclic graph clamps
    it to the largest divisor within the cycle-delay bound.
    `force_dense_params` gives every param a dense row (streamed per step),
    so no kernel specializes on a constant: the LTI biquad runs the a-rate
    scan, oscillators the cumsum phase, a delay the automated read."""
    with span("plan"):
        return _plan(nodes, edges, sample_rate, total_frames, dest_id,
                     device, start_frame, quanta_per_block,
                     force_dense_params)


def _plan(nodes, edges, sample_rate, total_frames, dest_id, device,
          start_frame, quanta_per_block, force_dense_params):
    """`compile_graph`'s work, its phases in spans of their own."""
    from . import fusion as _fusion
    from ..nodes.delay import DelayNode  # the nodes import this module

    device = torch.device(device)
    # rewrite homogeneous source chains into fused banks before anything
    # looks at the topology (see graph/fusion.py)
    with span("plan.fuse"):
        nodes, edges, param_alias = _fusion.fuse_sources(
            nodes, edges, dest_id, sample_rate=sample_rate)
    with span("plan.order"):
        delay_ids = {nid for nid, n in nodes.items()
                     if isinstance(n, DelayNode)}
        # ordering also respects foreign-param subscriptions: when node X
        # reads node Y's param P, whatever drives (Y, P) with audio runs
        # before X
        order_edges = list(edges)
        for xid, xnode in nodes.items():
            for src_node, pname in xnode.foreign_params().values():
                order_edges += [Edge(e.src, e.src_output, xid, -2)
                                for e in edges if e.param == pname
                                and e.dst == src_node.node_id]
        ordered = order_graph(list(nodes.keys()), order_edges, delay_ids)

        total_quanta = -(-total_frames // RENDER_QUANTUM_SIZE)
        two_rate_m = 1          # inner sub-steps per block (two-rate)
        inner_frames = None     # delay-bounded inner block (frames)
        fast_ids: set = set()   # nodes stepped at the inner rate
        if quanta_per_block is not None:
            qpb = min(quanta_per_block, total_quanta)
            if ordered.has_cycle:
                # an explicit block must still respect the cycle-delay
                # bound (a feedback read inside one block would see
                # unwritten ring samples): the largest divisor of the
                # request within the bound, so callers stepping in
                # multiples of it stay aligned
                bound = _cycle_delay_bound(nodes, edges,
                                           ordered.cycle_breakers,
                                           sample_rate)
                if os.environ.get("WEBAUDIO_CYCLE_BLOCKS", "auto") == "1":
                    bound = 1
                if bound < qpb:
                    qpb = next(d for d in range(bound, 0, -1)
                               if quanta_per_block % d == 0)
        elif not ordered.has_cycle:
            qpb = _acyclic_qpb(nodes, total_quanta)
        elif os.environ.get("WEBAUDIO_CYCLE_BLOCKS", "auto") == "1":
            qpb = 1
        else:
            # a constant delay of d frames admits blocks of up to d - 1
            # frames (`_cycle_safe_qpb`); the delay bound applies only to
            # nodes on a cycle, so each broken SCC steps at the bounded
            # rate inside the larger blocks of the acyclic rest
            # (two-rate).  The plan, switches included, is the JAX
            # package's default one.
            qpb = _cycle_safe_qpb(nodes, edges, ordered.cycle_breakers,
                                  sample_rate, total_quanta)
            # a graph with a pow2-constrained node (the script processor)
            # keeps a pow2 inner block and takes m from `_two_rate_steps`;
            # any other chooses the inner block and m jointly
            # (`_two_rate_plan`)
            pow2_only = _pow2_only(nodes.values())
            if (qpb >= 2 and ordered.cycle_groups
                    and os.environ.get("WEBAUDIO_TWO_RATE", "1") != "0"
                    and not (pow2_only and (qpb & (qpb - 1)))
                    and _two_rate_eligible(nodes, edges, ordered)):
                if pow2_only:
                    inner_qpb = qpb
                    m = _two_rate_steps(nodes, total_quanta, qpb, pow2_only)
                else:
                    plan = _two_rate_plan(nodes, edges,
                                          ordered.cycle_breakers,
                                          sample_rate, total_quanta)
                    inner_qpb, m = plan if plan else (qpb, 1)
                if m >= 2:
                    two_rate_m = m
                    inner_frames = inner_qpb * RENDER_QUANTUM_SIZE
                    fast_ids = {nid for grp in ordered.cycle_groups
                                for (nid, _) in grp}
                    qpb = inner_qpb * two_rate_m
        block_frames = qpb * RENDER_QUANTUM_SIZE

    in_counts, out_counts, in_edges = _propagate_channel_counts(nodes, edges)

    # param audio connections: (dst_nid, param_name) -> [(src, src_output)]
    param_edges: dict = {}
    for e in edges:
        if e.param is not None:
            param_edges.setdefault((e.dst, e.param), []).append((e.src, e.src_output))

    # compile every param timeline over the render range
    param_plan = {}
    param_objects = {}
    with span("plan.params"):
        for nid, node in nodes.items():
            for pname, p in node.params.items():
                param_objects[(nid, pname)] = p
                param_plan[(nid, pname)] = p.compile_for_render(
                    sample_rate, _pad_len(total_frames, block_frames),
                    start_frame, force_dense=force_dense_params)

    # dense params are packed into one (P, B) tensor per block
    dense_params = [key for key, plan in param_plan.items()
                    if not plan.is_constant]
    dense_index = {key: i for i, key in enumerate(dense_params)}

    # foreign params: a node can read another node's params (the
    # reference's hidden listener->panner port, concrete_base.rs:511-534),
    # alias -> (node id, param name)
    foreign = {}
    for nid, node in nodes.items():
        fp = node.foreign_params()
        if fp:
            foreign[nid] = {alias: (src.node_id, pname)
                            for alias, (src, pname) in fp.items()
                            if src.node_id in nodes}

    # build kernels
    kernels = {}
    failed: dict = {}

    def fail(nid, exc):
        # per-node failure isolation: a processor that throws is removed
        # from the graph (its outputs go silent) and the rest keeps
        # rendering (reference: graph.rs:507-521, tests/processor_error.rs)
        failed[nid] = exc
        cb = getattr(nodes[nid], "_onprocessorerror", None)
        if cb is not None:
            cb(exc)

    # the kernels, and what the block's closure reads
    with span("plan.kernels"):
        for nid, node in nodes.items():
            rc = RenderContext(
                sample_rate=sample_rate,
                # two-rate: cycle-group members process inner_frames at a
                # time
                block_frames=(inner_frames if nid in fast_ids
                              else block_frames),
                input_channel_counts=in_counts[nid],
                device=device,
                in_cycle=nid in ordered.cycle_breakers,
                param_plans={pname: param_plan[(nid, pname)]
                             for pname in node.params},
                input_connected=[bool(in_edges[nid][i])
                                 for i in range(node.number_of_inputs)],
            )
            try:
                kernels[nid] = node.make_kernel(rc)
            except (NotSupportedError, KernelError):
                # capability fences and kernel build faults are
                # environment errors, not processor bugs: muting the node
                # would hide them
                raise
            except Exception as exc:
                # a processor whose construction throws is isolated
                # exactly like a process()-time failure: its outputs are
                # silent, onprocessorerror fires, the rest of the graph
                # renders (reference: worklet.rs:301-321 +
                # graph.rs:507-521)
                kernels[nid] = Kernel()
                fail(nid, exc)

        # a host callback or user code keeps the walk eager (decided here,
        # never by a capture that failed)
        capture = True
        for nid, kern in kernels.items():
            if kern.capture_refusal:
                capture = (f"{type(nodes[nid]).__name__} #{nid}: "
                           f"{kern.capture_refusal}")
                break

        interp_of = {nid: nodes[nid]._channel_config.interpretation
                     for nid in nodes}
        constants = {}
        for (nid, pname), plan in param_plan.items():
            if plan.is_constant:
                p = nodes[nid].params[pname]
                constants[(nid, pname)] = torch.tensor(
                    min(max(plan.scalar, p.min_value), p.max_value),
                    dtype=torch.float32, device=device)

        # execution plan: the vertices in topological order, each one
        # stepped once at the block (members, 1, block_frames), except
        # that two-rate collapses each broken-SCC group into one step at
        # its first vertex (the groups are contiguous in ordered.order,
        # graph/ir.py): its members stepped m times at the inner block,
        # or, a group that is one constant feedback-delay loop, a `_Loop`
        # walked in one launch a block (`run_loop`)
        group_of = {v: gi for gi, grp in enumerate(ordered.cycle_groups)
                    for v in grp} if two_rate_m > 1 else {}
        exec_plan = []
        loops: dict = {}        # group -> its _Loop, or None: it steps
        for v in ordered.order:
            gi = group_of.get(v)
            if gi is None:
                exec_plan.append(([v], 1, block_frames))
            elif gi not in loops:
                grp = ordered.cycle_groups[gi]
                loops[gi] = _constant_loop(grp, nodes, kernels, edges,
                                           param_plan, in_counts, out_counts)
                exec_plan.append(loops[gi] or (grp, two_rate_m, inner_frames))
        cycle_paths = ["fused" if loops.get(gi) else "stepped"
                       for gi in range(len(ordered.cycle_groups))]
        # each vertex's input sources by port, (node id, output)
        in_refs = {nid: [[(e.src, e.src_output) for e in port]
                         for port in in_edges[nid]] for nid in nodes}

    def run_node(kern, role, scope, state, ins, prm, traced):
        """One vertex: (state', outputs); a writer has no outputs.  traced:
        a `walk.node.<kernel class>` span around it."""
        with (span("walk.node." + type(kern).__name__) if traced
              else _UNTRACED):
            if role == "node":
                return kern.process(scope, state, ins, prm)
            if role == "reader":
                return kern.process_reader(scope, state, prm)
            return kern.process_writer(scope, state, ins, prm), []

    # the blocks' arange(B) for t_idx = frame0 + base, made once per plan
    # at its first block with frame0 on the device (eager walks make
    # t_idx on the host's frame0)
    bases: dict = {}

    def base(frames):
        if frames not in bases:
            bases[frames] = torch.arange(frames, dtype=torch.int64,
                                         device=device)
        return bases[frames]

    def block_fn(states, frame0, xs_params, resources, frame0_host=None):
        """One block of N instances: run every node in topological order.
        frame0: the block's first frame, a 0-d int64 tensor on the device
        (None in an eager walk: made from frame0_host where a kernel asks);
        frame0_host: the same on the host, None inside a captured walk.
        xs_params: (N, P, B) dense param rows; returns (states', the
        destination's (N, C, B) output)."""
        n = xs_params.shape[0]
        scope = BlockScope(frame0, block_frames, n, device, frame0_host,
                           None if frame0 is None else base(block_frames))
        # a span a node while a profiler records, never inside a capture
        traced = recording() and not _capturing()
        signals: dict = {}
        new_states = dict(states)

        def silence(channels, frames=block_frames):
            return torch.zeros((n, channels, frames),
                               dtype=torch.float32, device=device)

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
            items = [(pname, nid, pname) for pname in node.params]
            items += [(alias, src, pname) for alias, (src, pname)
                      in foreign.get(nid, {}).items()]
            for alias, pnid, pname in items:
                p = nodes[pnid].params[pname]
                if (pnid, pname) in constants:
                    val = constants[(pnid, pname)]
                else:
                    i = dense_index[(pnid, pname)]
                    val = xs_params[:, i:i + 1, :]                   # (N, 1, B)
                aedges = param_edges.get((pnid, pname))
                if aedges:
                    sigs = [signals[s] for s in aedges if s in signals]
                    audio = sum_inputs(sigs, 1, ChannelInterpretation.SPEAKERS,
                                       block_frames, device, batch=n)
                    if not p.automation_rate.is_a_rate:
                        q = audio.reshape(n, 1, -1, RENDER_QUANTUM_SIZE)[..., :1]
                        audio = q.expand(n, 1, q.shape[2], RENDER_QUANTUM_SIZE
                                         ).reshape(n, 1, block_frames)
                    val = p.clamp(val + audio)
                elif (pnid, pname) not in constants:
                    val = torch.clamp(val, *p.f32_bounds())
                out[alias] = val
            return out

        def part(val, s, frames):
            # a dense (.., B) value's sub-step s of `frames` frames;
            # constants pass as-is
            if val is not None and val.dim() >= 1 and \
                    val.shape[-1] == block_frames:
                return val[..., s * frames:(s + 1) * frames]
            return val

        def run_step(members, m, frames):
            """Step `members`, (node id, role) vertices in topological
            order, m times at `frames` frames: a lone vertex once at the
            block, a two-rate group's members m sub-steps of the block at
            the delay-bounded inner block.  Outside signals and dense
            params are sliced per sub-step (views), signals among the
            members resolve inside the sub-step, and each member's state
            carries through the block's running states: a delay's reader
            sees the ring its writer wrote earlier in the block, and cycle
            feedback is the math of stepping these nodes at the inner
            block, bit-equal to it.  A member that throws is isolated and
            silent for the whole block."""
            prms: dict = {}         # each member's params, once a block
            parts: dict = {}        # each output's sub-step signals
            # captured, the sub-steps take views of the block's t_idx
            t_block = scope.t_idx if m > 1 and frame0_host is None else None
            for s in range(m):
                if m == 1:
                    # the block's scope; outputs go straight to its signals
                    sc, local = scope, signals
                elif t_block is None:
                    sc, local = BlockScope(None, frames, n, device,
                                           frame0_host + s * frames), {}
                else:
                    sc, local = BlockScope(
                        t_block[s * frames], frames, n, device, None,
                        base(frames), t_block[s * frames:(s + 1) * frames]), {}
                for nid, role in members:
                    if nid in ordered.muted or nid in failed:
                        continue
                    sc.node_resources = resources.get(_k(nid))
                    # a processor that throws is isolated; capability
                    # fences and kernel faults are not processor errors
                    # and propagate
                    try:
                        ins = [] if role == "reader" else [
                            sum_inputs([local[r] if r in local
                                        else part(signals[r], s, frames)
                                        for r in refs
                                        if r in local or r in signals],
                                       in_counts[nid][i], interp_of[nid],
                                       frames, device, batch=n)
                            for i, refs in enumerate(in_refs[nid])]
                        prm = prms.get(nid)
                        if prm is None:
                            prm = prms[nid] = gather_params(nid, nodes[nid])
                        if m > 1:
                            prm = {a: part(v, s, frames)
                                   for a, v in prm.items()}
                        st, o = run_node(kernels[nid], role, sc,
                                         new_states.get(_k(nid)), ins, prm,
                                         traced)
                        new_states[_k(nid)] = st
                        for oi, y in enumerate(o):
                            # an output shared by all instances
                            # broadcasts (a view)
                            local[(nid, oi)] = y.expand((n,) + y.shape[1:])
                    except (NotSupportedError, KernelError):
                        raise
                    except Exception as exc:
                        if _capture_fault(exc):
                            raise
                        fail(nid, exc)
                if m > 1:
                    for nid, role in members:
                        if role == "writer" or nid in failed or \
                                nid in ordered.muted:
                            continue
                        for oi, c in enumerate(out_counts[nid]):
                            parts.setdefault((nid, oi), []).append(
                                local[(nid, oi)] if (nid, oi) in local
                                else silence(c, frames))
            # muted and failed members emit the block's silence
            for nid, role in members:
                if role == "writer":
                    continue
                for oi, c in enumerate(out_counts[nid]):
                    key = (nid, oi)
                    if nid in failed or key not in (parts if m > 1
                                                    else signals):
                        signals[key] = silence(c)
                    elif m > 1:
                        signals[key] = torch.cat(parts[key], dim=-1)

        def run_loop(loop):
            """A constant feedback-delay loop over the whole block in one
            call of `ops/feedback.py::feedback_delay`: the arithmetic of
            `run_step`'s sub-steps, frame by frame, so bit-equal to it."""
            with span("walk.cycle"):
                x = signals.get(loop.x) if loop.x is not None else None
                if x is not None:
                    if x.shape[0] > 1 and x.stride(0) == 0:
                        x = x[:1]          # one signal every instance shares
                    x = x.contiguous()
                key = _k(loop.delay)
                r, y, ring = feedback_delay(
                    states[key]["ring"], x, block_frames, loop.shift,
                    loop.wa, loop.wb, loop.gains,
                    scope.frame0 if frame0_host is None else frame0_host)
                new_states[key] = {"ring": ring}
                signals[(loop.delay, 0)] = r
                signals[(loop.tail, 0)] = y

        for entry in exec_plan:
            if isinstance(entry, _Loop):
                run_loop(entry)
            else:
                run_step(*entry)

        return new_states, signals[(dest_id, 0)]

    return CompiledGraph(
        block_fn=block_fn, order=ordered.order, kernels=kernels,
        param_plan=param_plan, block_frames=block_frames,
        total_frames=total_frames, device=device, sample_rate=sample_rate,
        in_counts=in_counts, out_counts=out_counts, failed=failed,
        dense_params=dense_params, param_alias=param_alias,
        param_objects=param_objects, muted=ordered.muted,
        cycle_breakers=set(ordered.cycle_breakers),
        cycle_groups=ordered.cycle_groups, cycle_paths=cycle_paths,
        two_rate_m=two_rate_m, inner_frames=inner_frames or 0,
        capture=capture)


_UNTRACED = contextlib.nullcontext()


def _capturing() -> bool:
    """Whether this thread's CUDA stream is capturing a graph."""
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def _capture_fault(exc: BaseException) -> bool:
    """Whether an exception a node raised is a fault of the CUDA graph
    capture in progress (a host sync, a pageable upload, a CUDA error),
    which propagates, and not a processor error, which isolates the node."""
    if not _capturing():
        return False
    accel = getattr(torch, "AcceleratorError", ())
    msg = str(exc)
    return isinstance(exc, accel) or "captur" in msg or "CUDA" in msg


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


def _cycle_delay_bound(nodes, edges, cycle_breakers, sample_rate) -> int:
    """Max safe quanta-per-block for cyclic stepping: a cycle-breaking
    delay of (constant) d frames only ever reads samples written >= d
    frames ago, so any block <= d-1 frames keeps every in-cycle read
    inside the carried ring state.  Automated or audio-driven delays (read
    distance can shrink mid-render) pin the graph to one-quantum
    stepping."""
    from ..nodes.delay import DelayNode  # the nodes import this module

    d_min = None
    for nid in cycle_breakers:
        node = nodes.get(nid)
        if not isinstance(node, DelayNode):
            return 1
        p = node.params["delay_time"]
        driven = any(e.param == "delay_time" and e.dst == nid for e in edges)
        if driven or not p.is_constant_schedule():
            return 1
        num = float(np.float32(p.value)) * sample_rate
        d_min = num if d_min is None else min(d_min, num)
    if d_min is None:
        return 1  # delay-free (muted) cycle
    return max(1, int((d_min - 1) // RENDER_QUANTUM_SIZE))


def _cycle_safe_qpb(nodes, edges, cycle_breakers, sample_rate,
                    total_quanta, constraint_ids=None) -> int:
    """Largest safe quanta-per-block for a cyclic graph (see
    _cycle_delay_bound), shaped to the render length (divisor / pow2
    preferences).  `constraint_ids` restricts the block-shape preference
    scan (pow2 constraint, FFT-partition content) to the nodes that will
    actually step at this block — the two-rate inner set — while the
    memory budget stays whole-graph."""
    max_by_delay = _cycle_delay_bound(nodes, edges, cycle_breakers,
                                      sample_rate)
    if max_by_delay < 2:
        return 1
    cons = (nodes.values() if constraint_ids is None
            else [nodes[i] for i in constraint_ids])
    budget = max(1, _budget_quanta(nodes.values()))
    cap = min(max_by_delay, budget, total_quanta)
    pow2_only = _pow2_only(cons)
    qpb = 1
    for d in range(cap, 0, -1):
        if total_quanta % d == 0 and (not pow2_only or (d & (d - 1)) == 0):
            qpb = d
            break
    if (qpb < 24 or qpb % 8) and cap >= 24:
        # no good divisor: accept block padding.  With partitioned-FFT
        # kernels in the graph prefer the largest power of two <= cap (the
        # partition is the block's largest pow2 divisor, so e.g. a
        # 104-quanta block caps partitions at 512 while a 64-quanta block
        # gets 8192); otherwise just take the largest multiple of 8.
        if pow2_only or _wants_pow2(cons):
            qpb = 1 << (cap.bit_length() - 1)
        else:
            qpb = max(cap - cap % 8, qpb)
    return qpb


def _two_rate_eligible(nodes, edges, ordered) -> bool:
    """Two-rate stepping requires every group-internal data dependency to
    be expressible inside the inner scan: audio-driven params whose source
    is IN the group, and foreign-param subscriptions by group members,
    fall back to single-rate (the flat delay-bounded scan)."""
    fast = {nid for grp in ordered.cycle_groups for (nid, _) in grp}
    if not fast:
        return False
    for e in edges:
        if e.param is not None and e.dst in fast and e.src in fast:
            return False
    for nid in fast:
        if nodes[nid].foreign_params():
            return False
    return True


@dataclass(frozen=True)
class _Loop:
    """A cycle group that `ops/feedback.py::feedback_delay` walks: the
    delay, its constant read (`_DelayKernel.const_read`), the gains of the
    chain reader -> g1 -> ... -> gk -> writer as f32 values, the chain's
    tail (gk, or the delay's reader when k = 0) and the one outside signal
    added at the writer's input, (node id, output), or None."""
    delay: int
    shift: int
    wa: float
    wb: float
    gains: tuple
    tail: int
    x: Optional[tuple]


def _constant_loop(grp, nodes, kernels, edges, param_plan, in_counts,
                   out_counts) -> Optional[_Loop]:
    """The group as a `_Loop` when it is one constant feedback-delay loop,
    else None (it steps): one DelayNode, as reader and writer, and a chain
    reader -> GainNode_1 -> ... -> GainNode_k -> writer (k >= 0, at most
    MAX_GAINS) with no other members; a constant delay and constant
    gains (no automation, no audio into a param, no dense row); every
    member at the ring's channel
    count, so nothing mixes inside; the writer fed by the chain's tail and
    at most one signal from outside, at that count too (x + y, exact in
    either edge order); and no member output read outside but the
    reader's and the tail's."""
    from ..nodes.delay import _DelayKernel   # the nodes import this module
    from ..nodes.gain import _GainKernel

    members = {nid for nid, _ in grp}
    roles = [role for _, role in grp]
    delays = [nid for nid, role in grp if role == "writer"]
    if len(delays) != 1 or roles.count("reader") != 1 or \
            len(roles) != len(members) + 1:
        return None
    d = delays[0]
    kd = kernels[d]
    gains = members - {d}
    if type(kd) is not _DelayKernel or kd.const_read is None or \
            len(gains) > MAX_GAINS or \
            any(type(kernels[g]) is not _GainKernel for g in gains):
        return None
    C = kd.channels
    if out_counts[d] != [C] or any(in_counts[g] != [C] or out_counts[g] != [C]
                                   for g in gains):
        return None
    into = {nid: [] for nid in members}       # audio edges into members
    for e in edges:
        if e.dst in members:
            if e.param is not None:
                return None               # audio into a member's param
            into[e.dst].append(e)
    # the chain from the reader through every gain to the writer, each
    # gain fed by the chain alone
    chain, prev = [], d
    while True:
        nxt = [e for e in edges if e.src == prev and e.dst in members]
        if len(nxt) != 1 or nxt[0].dst in chain:
            return None
        if nxt[0].dst == d:
            break
        prev = nxt[0].dst
        if into[prev] != nxt:
            return None
        chain.append(prev)
    if set(chain) != gains:
        return None
    tail = chain[-1] if chain else d
    outside = [e for e in into[d] if e.src not in members]
    if len(into[d]) != len(outside) + 1 or len(outside) > 1 or any(
            out_counts[e.src][e.src_output] != C for e in outside):
        return None
    if any(e.src in gains and e.src != tail and e.dst not in members
           for e in edges):
        return None                       # an inner gain heard outside
    consts = []
    for g in chain:
        plan = param_plan[(g, "gain")]
        if not plan.is_constant:
            return None
        p = nodes[g].params["gain"]
        consts.append(float(np.float32(
            min(max(plan.scalar, p.min_value), p.max_value))))
    shift, wa, wb = kd.const_read
    return _Loop(d, shift, wa, wb, tuple(consts), tail,
                 (outside[0].src, outside[0].src_output) if outside else None)


def _two_rate_plan(nodes, edges, cycle_breakers, sample_rate,
                   total_quanta):
    """Joint (inner_qpb, m) choice for the two-rate compiler (r5).

    The inner block is constrained only by the cycle-delay bound (cycle
    members carry no FFT-partition or pow2 preferences; a pow2-constrained
    graph takes `_two_rate_steps`).  Candidates: divisors of the render,
    multiples of 8, and powers of two up to the bound.  For each, the
    best m minimizes  padded_total + 16*outer_steps + 4*inner_substeps
    (quanta-equivalents; 16/outer-step is the acyclic chooser's measured
    per-scan-step overhead, 4/substep its small-body analog), preferring
    outer blocks whose pow2 content keeps partitioned-FFT kernels on
    >= 4096-sample partitions.  Returns (inner_qpb, m) or None."""
    bound = _cycle_delay_bound(nodes, edges, cycle_breakers, sample_rate)
    budget = max(1, _budget_quanta(nodes.values()))
    cap = min(bound, budget, total_quanta)
    if cap < 2:
        return None
    wants_pow2 = _wants_pow2(nodes.values())

    cands = {cap}
    cands.update(q for q in range(8, cap + 1, 8))
    q = 1
    while q * 2 <= cap:
        q *= 2
    cands.add(q)
    for d in range(2, int(total_quanta ** 0.5) + 1):
        if total_quanta % d == 0:
            if d <= cap:
                cands.add(d)
            if total_quanta // d <= cap:
                cands.add(total_quanta // d)

    best = None
    best_good = None
    for qi in sorted(cands):
        max_m = min(budget // qi, -(-total_quanta // qi))
        for m in range(1, max_m + 1):
            outer = m * qi
            nb = -(-total_quanta // outer)
            cost = ((nb * outer + 16 * nb + 4 * nb * m,
                     -_content(outer) if wants_pow2 else 0), qi, m)
            if best is None or cost < best:
                best = cost
            # the FFT-partition content preference is GLOBAL: any plan
            # with >= 4096-sample pow2 content beats every plan without
            # one (a per-inner-candidate filter let inner blocks with no
            # good m win on raw cost while degrading the partitioned
            # kernels' FDL 32x — caught by test_block_policy)
            if wants_pow2 and _content(outer) >= 4096 and \
                    (best_good is None or cost < best_good):
                best_good = cost
    chosen = best_good if best_good is not None else best
    if chosen is None:
        return None
    return chosen[1], chosen[2]


def _two_rate_steps(nodes, total_quanta, qpb_in, pow2_only=False) -> int:
    """Inner sub-steps per outer block at a fixed inner block (the pow2-
    constrained case): minimize padded total + per-outer-step overhead
    (~16 quanta, the acyclic chooser's cost model), keeping partitioned-
    FFT kernels on >= 4096-sample pow2 content."""
    max_qpb = max(DEFAULT_QUANTA_PER_BLOCK, _budget_quanta(nodes.values()))
    max_m = max(1, min(max_qpb // qpb_in, -(-total_quanta // qpb_in)))
    wants_pow2 = _wants_pow2(nodes.values())
    cands = [m for m in range(1, max_m + 1)
             if not pow2_only or ((m * qpb_in) & (m * qpb_in - 1)) == 0]
    if wants_pow2:
        good = [m for m in cands if _content(m * qpb_in) >= 4096]
        if good:
            cands = good

    def _cost(m):
        q = m * qpb_in
        nb = -(-total_quanta // q)
        return (nb * q + 16 * nb, -_content(q) if wants_pow2 else 0)

    return min(cands, key=_cost) if cands else 1


def _pad_len(total_frames: int, block_frames: int) -> int:
    nb = -(-total_frames // block_frames)
    return nb * block_frames


def cuda_graphs_enabled() -> bool:
    """`WEBAUDIO_CUDA_GRAPHS=0` walks every block eagerly on the card with
    the same kernels (the counterpart of `jax.disable_jit`); by default a
    capturable plan's walk replays CUDA graphs."""
    return os.environ.get("WEBAUDIO_CUDA_GRAPHS", "1") != "0"


# a walk captures at block b >= 1 of shapes it marked at an earlier block
# when at least this many blocks are left (b included); a walk after the
# one that marked them captures at its first block
CAPTURE_MIN_BLOCKS_LEFT = 4
# graphs kept per plan (input-state shapes x resources x batch shapes)
MAX_GRAPHS_PER_PLAN = 4

_pool_lock = threading.Lock()
_pools: dict = {}            # CUDA device index -> [pool, graphs alive on it]


def _graph_pool(device: torch.device) -> list:
    """The memory pool the live graphs on `device` share, as [pool
    handle, live graph count].  Each graph keeps alive what it hands out
    (its output block and, where the states change shape, its new states)
    and copies everything else into buffers outside the pool, so graphs
    replayed one after another on a stream reuse each other's scratch
    safely.  Once no graph on the device lives, the handle is forgotten:
    the allocators free a released pool's memory at the next
    `empty_cache` and refuse a capture into it meanwhile, so the next
    capture takes a new pool.  Memory is bounded by the graphs alive."""
    with _pool_lock:
        entry = _pools.get(device.index)
        if entry is None:
            entry = _pools[device.index] = [torch.cuda.graph_pool_handle(), 0]
        entry[1] += 1
        return entry


def _release_pool(index: int, entry: list) -> None:
    with _pool_lock:
        entry[1] -= 1
        if entry[1] == 0 and _pools.get(index) is entry:
            del _pools[index]


_captures = [0, False]        # captures under way, gc enabled before them


def _hold_gc(begin: bool) -> None:
    """No garbage collection while any thread captures: a collected plan's
    graph would be destroyed inside the capture, which CUDA refuses
    (`torch.cuda.graph` collects before it captures instead)."""
    with _pool_lock:
        if begin:
            if _captures[0] == 0:
                _captures[1] = gc.isenabled()
                gc.disable()
            _captures[0] += 1
        else:
            _captures[0] -= 1
            if _captures[0] == 0 and _captures[1]:
                gc.enable()


def _leaves(tree, path=()):
    """(path, tensor) of each tensor leaf of a tree of dicts, keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif tree is not None:
        yield path, tree


def _signature(tree) -> tuple:
    return tuple((p, tuple(t.shape), t.dtype) for p, t in _leaves(tree))


def _graph_key(states, xs_block, resources) -> tuple:
    """What a captured block depends on besides the values in its static
    buffers: the input states' shapes, the rows' shape, and the resources
    it reads by address."""
    res = tuple((p, t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                for p, t in _leaves(resources))
    return _signature(states), tuple(xs_block.shape), xs_block.dtype, res


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return None if tree is None else tree.clone()


def _copy_tree(dst, src):
    """Copy src's leaves into dst's (the same signature), skipping leaves
    that are already dst's; leaves that overlap any of dst's storage are
    cloned first, so no copy reads what an earlier one wrote."""
    pairs = [(d, s) for (_, d), (_, s) in zip(_leaves(dst), _leaves(src))
             if s is not d]
    owned = {d.untyped_storage().data_ptr() for _, d in _leaves(dst)}
    pairs = [(d, s.clone() if s.untyped_storage().data_ptr() in owned else s)
             for d, s in pairs]
    for d, s in pairs:
        d.copy_(s)


class BlockGraph:
    """One block of a plan captured as a CUDA graph.

    It reads the states, the block's dense rows (N, P, B) and frame0 from
    static buffers, writes the new states back into the state buffers and
    advances frame0 by the block itself, so one replay walks one block,
    as one `lax.scan` step does.  Where a block changes the states' shapes
    (the zero states of a walk's start), the new states stay the graph's
    own tensors (`closed` is False) and feed the next block's graph.
    `launches` holds the hand-written kernels' launches in the graph;
    each replay adds them to the wrappers' counters."""

    def __init__(self, cg: CompiledGraph, states, xs_block, resources):
        dev = xs_block.device
        self.block_frames = cg.block_frames
        self.states = _clone_tree(states)
        self.xs = xs_block.clone()
        self.frame0 = torch.zeros((), dtype=torch.int64, device=dev)
        self.next_frame0 = None
        self.resources = resources
        self.replays = 0
        # the graph's pool allocates the block's scratch anew, about what
        # the eager walk left cached: where the card lacks that much free,
        # the cache goes back to it first (`torch.cuda.graph` always does)
        free, _ = torch.cuda.mem_get_info(dev)
        if torch.cuda.memory_reserved(dev) - \
                torch.cuda.memory_allocated(dev) > free:
            torch.cuda.empty_cache()
        entry = _graph_pool(dev)
        weakref.finalize(self, _release_pool, dev.index, entry)
        counters = launch_counters()
        t0 = time.perf_counter()
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with span("capture"):
            while True:
                failed = len(cg.failed)
                before = [k.launches for k in counters]
                graph = torch.cuda.CUDAGraph()
                _hold_gc(True)
                try:
                    with torch.cuda.stream(stream):
                        # thread-local: other threads' CUDA calls (an
                        # online context's render thread, the control
                        # thread) go on meanwhile; this capture makes no
                        # host sync itself
                        graph.capture_begin(
                            pool=entry[0], capture_error_mode="thread_local")
                        try:
                            new, out = cg.block_fn(self.states, self.frame0,
                                                   self.xs, resources)
                            closed = (_signature(new)
                                      == _signature(self.states))
                            if closed:
                                _copy_tree(self.states, new)
                            self.frame0.add_(cg.block_frames)
                        except BaseException:
                            with contextlib.suppress(Exception):
                                graph.capture_end()
                            raise
                        graph.capture_end()
                finally:
                    _hold_gc(False)
                self.launches = {k: k.launches - b0
                                 for k, b0 in zip(counters, before)}
                for k, b0 in zip(counters, before):
                    k.launches = b0          # the capture launched nothing
                if len(cg.failed) == failed:
                    break
                # a node failed while its plan was captured: it is isolated
                # as in an eager block, and the block is captured again
                # without it
        torch.cuda.current_stream(dev).wait_stream(stream)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.graph, self.out, self.closed = graph, out, closed
        self.new_states = self.states if closed else new

    def replay(self, states, frame0: int, xs_block):
        """Walk the block at `frame0` from `states`: -> (states', output
        (N, C, B), valid until the next replay)."""
        with span("walk.replay"):
            if states is not self.states:
                _copy_tree(self.states, states)
            if xs_block.numel():
                self.xs.copy_(xs_block)
            if frame0 != self.next_frame0:
                self.frame0.fill_(frame0)
            self.graph.replay()
        self.replays += 1
        self.next_frame0 = frame0 + self.block_frames
        for k, n in self.launches.items():
            k.launches += n
        return self.new_states, self.out


def scan_render(cg: CompiledGraph, states: dict, frame0s, xs: torch.Tensor,
                resources: dict):
    """The block walk over a whole render: N instances, block by block.

    states: leaves (N, ...); frame0s: host ints, one per block; xs:
    (N, nb, P, B) dense rows on the device; resources: staged with their
    leading 1 or N axis.  Returns (final states, (N, C, nb*B) output),
    both the caller's own: no later walk writes into them.

    On the card, unless `WEBAUDIO_CUDA_GRAPHS=0` or the plan says why not
    (`cg.capture`), a block whose input shapes were walked eagerly once is
    captured as a `BlockGraph` (its frame0 a device scalar) and replayed
    from then on: at a plan's first block of a walk after one that marked
    it, or within a walk when at least `CAPTURE_MIN_BLOCKS_LEFT` blocks are
    left.  A marking block walks eagerly with frame0 on the card, as the
    graph will.  A plan's first walk marks its blocks only where it is
    long enough to capture in; a shorter one (a fresh one-block render)
    and every walk that cannot capture walk eagerly with frame0 on the
    host and no capture bookkeeping, and the plan's next walk marks."""
    nb = len(frame0s)
    capturable = (cg.device.type == "cuda" and cg.capture is True
                  and cuda_graphs_enabled()
                  and (cg.walks > 0 or nb > CAPTURE_MIN_BLOCKS_LEFT))
    marked = set(cg.warm)          # marked by an earlier walk
    outs = []
    graph = None
    for b, frame0 in enumerate(frame0s):
        xb = xs[:, b]
        graph = None
        if capturable:
            key = _graph_key(states, xb, resources)
            graph = cg.graphs.get(key)
            if graph is None and key in cg.warm and (
                    key in marked or nb - b >= CAPTURE_MIN_BLOCKS_LEFT):
                if len(cg.graphs) >= MAX_GRAPHS_PER_PLAN:
                    cg.graphs.pop(next(iter(cg.graphs)))
                graph = BlockGraph(cg, states, xb, resources)
                cg.graphs[key] = graph
        if graph is None and not capturable:
            with span("walk.block"):
                states, y = cg.block_fn(states, None, xb, resources, frame0)
        elif graph is None:
            # the block a later one captures, walked first with frame0 on
            # the card: its device-side code, caches and lazily loaded
            # kernels run once outside the capture
            with span("walk.block"):
                f0 = torch.full((), frame0, dtype=torch.int64,
                                device=cg.device)
                states, y = cg.block_fn(states, f0, xb, resources)
            cg.warm.add(key)
        else:
            states, y = graph.replay(states, frame0, xb)
            y = y.clone()          # the graph's buffer: the next replay's
        outs.append(y)
    cg.walks += 1
    if graph is not None:
        # the graph's buffers: its next replay overwrites them
        states = _clone_tree(states)
    return states, torch.cat(outs, dim=-1)


def drop_graphs(cg: CompiledGraph) -> None:
    """Release a plan's CUDA graphs and their memory (a re-planned online
    graph's, a finished offline render's)."""
    cg.graphs.clear()
    cg.warm.clear()


def render_args(cg: CompiledGraph, rows: np.ndarray, frame0: int = 0,
                states: Optional[dict] = None):
    """Stage one instance's walk of `cg` for `scan_render`: -> (states,
    frame0s, xs, resources).

    rows: the (P, frames) f32 dense params over [frame0, frame0 + frames)
    in `cg.dense_params` order, frames a multiple of the block; they go to
    the device as one (1, nb, P, B) tensor.  states: the walk's (an
    instance axis of 1) or None.  A plan's first walk starts from zero
    states except for each node whose state in `states` has the zero
    state's structure (a re-plan keeps the surviving nodes' states); its
    later walks take `states` as they are, the states its walks returned.
    resources: staged once per plan (`cg.resource_cache`)."""
    B = cg.block_frames
    xs = torch.from_numpy(block_rows(rows, B)[None].copy()).to(cg.device)
    frame0s = [frame0 + b * B for b in range(rows.shape[-1] // B)]
    if states is None or not cg.walks:
        zero = batch_states(zero_states(cg), 1)
        states = zero if states is None else {
            k: old if (old := states.get(k)) is not None
            and _same_structure(old, v) else v for k, v in zero.items()}
    if cg.resource_cache is None:
        with span("render.resources"):
            cg.resource_cache = stage_resources(collect_resources(cg),
                                                cg.device)
    return states, frame0s, xs, cg.resource_cache


def _same_structure(a, b) -> bool:
    """Same dict keys, tensor shapes and dtypes all the way down."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(
            _same_structure(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return a.shape == b.shape and a.dtype == b.dtype
    return a is None and b is None


def render_compiled(cg: CompiledGraph, total_frames: int,
                    start_frame: int = 0, init_states: Optional[dict] = None):
    """Execute a compiled graph over [start_frame, start_frame+total_frames)
    as one instance of the block walk.

    Returns `(output (C, padded_frames) tensor on the device, final_states)`
    where padded_frames rounds total_frames up to the block size and the
    states carry no instance axis."""
    rows = pack_dense_params(cg, _pad_len(total_frames, cg.block_frames))
    final, out = scan_render(cg, *render_args(
        cg, rows, start_frame,
        None if init_states is None else batch_states(init_states, 1)))
    return out[0], unbatch_states(final)
