"""Structured diagnostics snapshots and render profiling.

reference: src/context/diagnostics.rs (AudioContextDiagnostics with full
node/edge dump collected on the render thread via a control message).  Here
the control side *is* the graph, so the dump is synchronous; the last
render's plan contributes ordering / block information.  Ported from
`webaudio_tpu/diagnostics.py`; `profile_render` traces with
`torch.profiler` instead of the XLA profiler, and `span` marks what the
port does on the host in that trace.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.profiler import record_function

# The port's spans, each recorded as "webaudio.<name>"; "walk.node" is
# followed by the node's kernel class ("walk.node._GainKernel").
SPANS = (
    "plan",                   # compile_graph, whole
    "plan.fuse",              # source fusion
    "plan.order",             # topology, block size, the two-rate plan
    "plan.params",            # the dense param timelines
    "plan.kernels",           # node kernels and the block's closure
    "render.stage",           # a fresh render's states, rows, resources
    "render.resources",       # a plan's resources staged, once a plan
    "walk.block",             # one eager block of the walk
    "walk.node",              # one node of an eager block
    "walk.cycle",             # one constant feedback-delay loop, one launch
    "walk.replay",            # one captured block replayed
    "capture",                # one block captured as a CUDA graph
    "render.fetch",           # the copy of a render's output to the host
    "render.finish",          # a render's bookkeeping after its walk
    "batch.override_param",   # GraphBatch's row snapshot
    "batch.override_buffer",  # GraphBatch's per-instance resources
    "batch.stage",            # GraphBatch's uploads
    "batch.upload",           # one row or resource leaf sent by a stage
    "batch.fetch_wait",       # the host waiting for a batch's copy back
    "pin",                    # a host staging buffer (pinned for a card)
    "session.rows",           # a session step's dense rows and their upload
    "session.walk",           # a session step's block walk enqueued
    "session.fetch",          # a session step's copy back, its wait included
    "session.advance",        # a session step's live timelines advanced
    "session.save",           # RenderSession.save
    "session.restore",        # RenderSession.restore
    "build",                  # a kernel or host library compiled
)
PREFIX = "webaudio."
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager recording `webaudio.<name>` (a name of `SPANS`)
    as a `torch.profiler.record_function` range while a torch profiler
    records on this thread (`profile_render`, or any
    `torch.profiler.profile`), in the same session and time base as the
    card's kernels and copies.  Otherwise it returns one shared null
    context: a span costs one check when nothing records."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return record_function(PREFIX + name)


def recording() -> bool:
    """Whether a torch profiler records on this thread (spans are on)."""
    return torch.autograd._profiler_enabled()


def collect_diagnostics(context) -> dict:
    nodes = []
    for nid, node in context._nodes.items():
        nodes.append({
            "id": nid,
            "type": type(node).__name__,
            "number_of_inputs": node.number_of_inputs,
            "number_of_outputs": node.number_of_outputs,
            "channel_count": node.channel_count,
            "channel_count_mode": str(node.channel_count_mode.value),
            "channel_interpretation": str(node.channel_interpretation.value),
            "params": {name: p.value for name, p in node.params.items()},
        })
    edges = [{
        "src": e.src, "src_output": e.src_output,
        "dst": e.dst, "dst_input": e.dst_input, "param": e.param,
    } for e in context._edges]

    diag = {
        "sample_rate": context.sample_rate,
        "state": str(context.state.value),
        "current_time": context.current_time,
        "device": str(context.device),
        "graph": {"nodes": nodes, "edges": edges},
    }
    # fusion preview: what the planner would rewrite (graph/fusion.py)
    from .graph import fusion as _fusion

    n2, _, _ = _fusion.fuse_sources(
        dict(context._nodes), list(context._edges),
        context._destination.node_id, sample_rate=context.sample_rate)
    fused = {nid: node for nid, node in n2.items() if nid < 0}
    diag["fusion"] = {
        "groups": [{
            "fused_id": nid,
            "kind": str(getattr(node, "kind", "?")),
            "voices": len(getattr(node, "sources", [])),
        } for nid, node in sorted(fused.items())],
        "nodes_removed": len(context._nodes) + len(fused) - len(n2),
    }
    from .graph import compiler as _compiler

    cg = getattr(context, "_cg", None)
    if cg is not None:
        diag["compiled"] = {
            "block_frames": cg.block_frames,
            "order": [(nid, role) for nid, role in cg.order],
            "muted": sorted(cg.muted),
            "cycle_breakers": sorted(cg.cycle_breakers),
            # the block walk on the card: captured as CUDA graphs, or why
            # it stays eager (graph/compiler.py::scan_render); the graphs
            # the plan holds (an offline render drops its own at its end)
            "capture": {
                "capturable": cg.capture is True,
                "reason": None if cg.capture is True else cg.capture,
                "enabled": _compiler.cuda_graphs_enabled(),
                "graphs": [{"blocks_replayed": g.replays,
                            "capture_ms": g.capture_ms,
                            "states_closed": g.closed}
                           for g in cg.graphs.values()],
            },
        }
    return diag


class profile_render:
    """Context manager tracing whatever renders inside it with
    `torch.profiler` (host operators, and the card's kernels where CUDA
    is available) into a Chrome trace, `log_dir/trace.json` (the analog
    of the reference's per-callback timing, SURVEY.md §5):

        with profile_render("webaudio-trace"):
            ctx.start_rendering_sync()

    Open it in chrome://tracing or Perfetto; `.profiler` holds the
    `torch.profiler.profile` for `key_averages()`.  The trace carries the
    port's host spans (`span`, named in `SPANS`) beside the kernels:
    `webaudio.plan` (compile_graph) with `plan.fuse`, `plan.order`,
    `plan.params` and `plan.kernels` inside it; an offline render's
    `render.stage` (with `render.resources` where a plan stages its
    resources), `render.fetch` and `render.finish`; the walk's
    `walk.block` and its `walk.node.<kernel class>` a node and
    `walk.cycle` a constant feedback-delay loop, or `walk.replay` a
    captured block, and `capture`; a GraphBatch's
    `batch.override_param`, `batch.override_buffer`, `batch.stage` with a
    `batch.upload` a row or leaf it sends, and `batch.fetch_wait`; a
    RenderSession's `session.rows`, `session.walk`, `session.fetch` and
    `session.advance` a step, `session.save` and `session.restore`; `pin`
    for each host staging buffer allocated (page-locked where it feeds a
    card), and `build` where a kernel or host library compiles."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.path = os.path.join(log_dir, "trace.json")
        self.profiler = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.profiler = profile(activities=acts)
        self.profiler.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.profiler.__exit__(*exc)
        os.makedirs(self.log_dir, exist_ok=True)
        self.profiler.export_chrome_trace(self.path)
        return False
