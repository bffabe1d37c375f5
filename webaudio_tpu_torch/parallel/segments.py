"""Time-axis segments: one long render split into segments that render
independently, each on a device of its own or in turn on a shared one.

The audio analog of sequence parallelism (SURVEY.md §5 long-context note).
A graph is time-shardable when every kernel's state encodes only a bounded
history (`Kernel.tail_frames()`): each segment renders its frames plus a
halo of `max(tail_frames)` leading frames starting from zero state — the
halo warms the states (convolution delay lines, delay rings, FIR tails) to
within the kernels' own truncation floors — and the halo's output is
discarded.  Sources are time-indexed (closed-form phase and playhead), so
they produce the same samples whichever segment renders them.

Ported from `webaudio_tpu/parallel/segments.py`, whose segments are the
shards of a `shard_map` over a `time` mesh axis.  Here the segments'
devices are a `parallel/mesh.py::Mesh` over ("time",) or a list of torch
devices, one per segment, repeats allowed: segment d renders on the d-th
device, and segments that share a device run one after another on it.
The block size, the halo and the refusals are the JAX package's, so both
render the same output.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import NotSupportedError
from ..graph import compiler as _compiler
from .mesh import Mesh, default_mesh, on_device


class NotTimeShardableError(NotSupportedError):
    pass


def halo_frames(cg) -> int:
    """The halo a segment of plan `cg` renders first: the longest state
    history of its kernels.  Raises NotTimeShardableError where a kernel's
    history is unbounded or the graph has a feedback cycle."""
    tails = {}
    for nid, kern in cg.kernels.items():
        t = kern.tail_frames()
        if t is None:
            raise NotTimeShardableError(
                f"node {type(kern).__name__} (id {nid}) has "
                f"unbounded state history; render it sequentially")
        tails[nid] = t
    if cg.cycle_breakers or cg.muted:
        raise NotTimeShardableError("graphs with feedback cycles are sequential")
    return max(tails.values(), default=0)


def segment_plan(total: int, n_dev: int, block_frames: int,
                 halo_frames: int):
    """(halo blocks, net blocks per segment, (n_dev, local blocks) block
    start frames): segment d's net range starts at block d * nb_net and is
    preceded by the halo's blocks, whose starts may be negative."""
    halo_blocks = -(-halo_frames // block_frames) if halo_frames else 0
    nb_total = -(-total // block_frames)
    nb_net = -(-nb_total // n_dev)
    nb_local = nb_net + halo_blocks
    starts = (np.arange(n_dev)[:, None] * nb_net - halo_blocks
              + np.arange(nb_local)[None, :]) * block_frames
    return halo_blocks, nb_net, starts


def render_time_sharded(context, total_frames: int | None = None,
                        mesh: Mesh | None = None, devices=None):
    """Render `context`'s graph over [0, total_frames) split into one time
    segment per entry of `mesh` (a Mesh over ("time",)) or of `devices`
    (a list of devices), not both; with neither, one per visible CUDA
    device.  Returns (channels, total_frames) numpy audio."""
    total = total_frames or context.length
    if mesh is not None and devices is not None:
        raise ValueError("render_time_sharded: pass mesh= or devices=, not "
                         "both")
    if mesh is None:
        mesh = (default_mesh("time") if devices is None
                else Mesh(devices, ("time",)))
    mesh.require("time")
    devices = list(mesh.devices)
    n_dev = len(devices)

    # block size: several blocks per segment (the halo quantizes to whole
    # blocks, so over-large blocks waste halo work)
    total_quanta = -(-total // 128)
    qpb = max(1, min(total_quanta // (n_dev * 4) or 1, 128))
    plans = {}

    def plan_on(dev):
        if dev not in plans:
            plans[dev] = _compiler.compile_graph(
                dict(context._nodes), list(context._edges),
                context.sample_rate, total, context._destination.node_id,
                dev, quanta_per_block=qpb)
        return plans[dev]

    cg = plan_on(devices[0])
    B = cg.block_frames

    halo = halo_frames(cg)
    halo_blocks, nb_net, starts = segment_plan(total, n_dev, B, halo)

    # params: packed dense rows sliced per segment incl. halo; frames
    # outside the render use the edge value (sources are inactive there)
    nb_total = -(-total // B)
    packed = _compiler.pack_dense_params(cg, nb_total * B)    # (P, padded)
    outs = []
    for d, dev in enumerate(devices):
        seg = plan_on(dev)
        f0 = int(starts[d][0])          # the segment's blocks are consecutive
        cols = np.clip(np.arange(f0, f0 + len(starts[d]) * B), 0,
                       nb_total * B - 1)
        args = _compiler.render_args(seg, packed[:, cols], f0)
        with on_device(dev):
            _, out = _compiler.scan_render(seg, *args)
        outs.append(out[0, :, halo_blocks * B:])     # (C, nb_net * B)
    flat = torch.cat([o.cpu() for o in outs], dim=-1)
    return flat[:, :total].numpy()
