"""Batched graph rendering: many instances of one graph in one block walk.

Ported from `webaudio_tpu/parallel/batch.py`.  The reference renders one
graph per thread; the engine's scale axis is batches of independent
graphs.  The JAX package `vmap`s its scan over stacked params, states and
resources; here the same batch is the block walk's leading instance axis
(`graph/compiler.py`), so every launch of the loop carries all N
instances.

With `mesh=` (a `parallel/mesh.py::Mesh` over a "graphs" axis of n
devices) the batch splits into n shards of batch / n instances, in
instance order, each walked on its device with its own plan, rows, states
and resources.  The JAX package shards one jitted computation over the
mesh; here one host thread walks the shards one after another, and the
results are gathered on the context's device.  The bounces run on each
shard's device before the gather, each shard's Philox stream starting at
its first element, so the codes equal one bounce of the unsharded batch.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import convert
from ..diagnostics import span
from ..graph import compiler as _compiler
from ..ops.dither import dither_i16, ulaw_u8
from .mesh import Mesh, default_mesh, indexed, on_device  # noqa: F401


@dataclass
class _Shard:
    """Instances [lo, hi) of a batch, walked on `device` with plan `cg`."""
    lo: int
    hi: int
    device: torch.device
    cg: object


class GraphBatch:
    """Render `batch` instances of one graph topology in one block walk on
    the context's device, or split over a mesh's "graphs" axis.

    Instances share the topology and any baked constants (audio buffers,
    schedules); per-instance variation comes from `override_param` (dense
    per-sample automation differing per instance), `override_buffer`
    (per-instance resources) and per-instance initial states.  Everything
    is staged on the device once; a later stage sends only the rows and
    resource leaves an override replaced since the last one, into the
    device buffers that hold them, so a staged batch re-renders without
    rebuilding or re-copying anything.  `stage_stats` counts what the
    last stage sent and kept.

    mesh: a `Mesh` over ("graphs",) whose size divides `batch` (else
    ValueError); shard s renders instances [s k, (s + 1) k), k = batch / n,
    on the mesh's s-th device.
    """

    def __init__(self, context, batch: int, mesh=None, _cg=None):
        self.context = context
        self.batch = batch
        self.mesh = mesh
        self.device = context.device
        total = context.length
        self.total_frames = total
        self.sample_rate = context.sample_rate
        self.cg = _cg if _cg is not None else _compiler.compile_graph(
            dict(context._nodes), list(context._edges), context.sample_rate,
            total, context._destination.node_id, self.device)
        B = self.cg.block_frames
        self.nb = -(-total // B)
        self.frame0s = [b * B for b in range(self.nb)]
        self._shards = self._split(mesh)

        # base param rows, host (nb, P, B), shared by the instances: the
        # first stage fills each shard's device rows from them; an
        # override_param's row goes to the device rows, not here
        self._base_xs = _compiler.block_rows(
            _compiler.pack_dense_params(self.cg, self.nb * B), B)
        self._on_card = any(sh.device.type == "cuda" for sh in self._shards)
        # row index -> snapshot (batch, total_frames) of its last override,
        # sent at the next stage
        self._rows: dict = {}
        self._states = convert.batch_states(_compiler.zero_states(self.cg),
                                            batch)
        # static kernel data (one instance's numpy): shared by every
        # instance unless overridden per instance via override_buffer, then
        # stacked along a leading batch axis
        self._resources = _compiler.collect_resources(self.cg)
        self._batched_resources: set = set()   # (node_key, leaf_key)
        # per-instance leaves an override replaced since the last stage
        self._stale: set = set()
        self._staged_xs = None     # each shard's (k, nb, P, B) device rows
        self._staged_states = None
        # device copies of the resources, kept across overrides: shared
        # leaves once a device, each shard's per-instance leaves rewritten
        # in place, so a captured walk keeps reading the same addresses
        self._shared_res: dict = {}    # device -> {(node_key, leaf_key)}
        self._res_buffers: dict = {}   # (shard, node_key, leaf_key)
        self.stage_stats = None

    def _split(self, mesh) -> list:
        """The shards: one over the whole batch on the context's device
        without a mesh; else one a mesh entry, with one plan a distinct
        device (the context's own plan on the context's device)."""
        if mesh is None:
            return [_Shard(0, self.batch, self.device, self.cg)]
        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                            f"{type(mesh).__name__}")
        mesh.require("graphs")
        n = mesh.devices.size
        if self.batch % n:
            raise ValueError(f"a batch of {self.batch} does not split over "
                             f"a mesh of {n} devices")
        k = self.batch // n
        ctx = self.context
        plans = {indexed(self.device): self.cg}
        shards = []
        for s, dev in enumerate(mesh.devices):
            if dev not in plans:
                plans[dev] = _compiler.compile_graph(
                    dict(ctx._nodes), list(ctx._edges), ctx.sample_rate,
                    self.total_frames, ctx._destination.node_id, dev)
            shards.append(_Shard(s * k, (s + 1) * k, dev, plans[dev]))
        return shards

    @classmethod
    def from_contexts(cls, contexts, mesh=None) -> "MixedGraphBatch":
        """Batch a heterogeneous list of contexts (mixed topologies):
        instances bucket by structural graph hash, one plan per bucket,
        one `render()` returning per-context results in input order."""
        return MixedGraphBatch(contexts, mesh=mesh)

    def override_buffer(self, node, stacked: np.ndarray, key: str = "data"):
        """Give each instance its own copy of a node resource, e.g. a
        per-instance AudioBuffer for an AudioBufferSourceNode.  stacked:
        (batch, ...) matching the resource's per-instance shape.

        `key="data"` takes raw (batch, C, L) audio and stages the derived
        pair-row layout, end-of-buffer constants and aligned-read layout
        the kernel actually reads (ops/bufread.py)."""
        with span("batch.override_buffer"):
            nk = _compiler._k(node.node_id)
            if nk not in self._resources:
                raise ValueError(f"node has no staged resource {key!r}")
            leaves = self._resources[nk]
            if key == "data" and "data_rows" in leaves:
                from ..ops.bufread import edge_vals, pair_rows

                kern = self.cg.kernels[node.node_id]
                C = leaves["data_rows"].shape[-1] // 2
                want = (self.batch, C, leaves["data_rows"].shape[-2])
                stacked = np.asarray(stacked, np.float32)
                if stacked.shape != want:
                    raise ValueError(f"expected {want}, got {stacked.shape}")
                wrap = int(math.ceil(kern.loop_start * kern.buf_rate)) \
                    if kern.loop else 0
                per_inst = {"data_rows": [pair_rows(inst) for inst in stacked],
                            "edge_vals": [edge_vals(inst, kern.loop, wrap)
                                          for inst in stacked]}
                saved = kern.data_host
                try:
                    for inst in stacked:
                        kern.data_host = inst
                        for rk, rv in kern._read_resources().items():
                            per_inst.setdefault(rk, []).append(rv)
                finally:
                    kern.data_host = saved
                for rk, rvs in per_inst.items():
                    leaves[rk] = np.stack(rvs)
                    self._batched_resources.add((nk, rk))
                    self._stale.add((nk, rk))
                return
            if key not in leaves:
                raise ValueError(f"node has no staged resource {key!r}")
            base = np.asarray(leaves[key])
            if (nk, key) in self._batched_resources:
                base = base[0]
            stacked = np.asarray(stacked, base.dtype)
            if stacked.shape != (self.batch,) + base.shape:
                raise ValueError(
                    f"expected {(self.batch,) + base.shape}, "
                    f"got {stacked.shape}")
            leaves[key] = stacked
            self._batched_resources.add((nk, key))
            self._stale.add((nk, key))

    def override_param(self, node, param_name: str, dense: np.ndarray):
        """Give each instance its own automation row.

        dense: (batch, total_frames) f32, per-instance per-sample values,
        copied once into a snapshot (pinned for a card) that the next stage
        sends: the caller may reuse `dense` as soon as this returns.
        """
        with span("batch.override_param"):
            arr = np.asarray(dense, np.float32)
            if arr.shape != (self.batch, self.total_frames):
                raise ValueError(
                    f"expected ({self.batch}, {self.total_frames}), "
                    f"got {arr.shape}")
            key = (node.node_id, param_name)
            key = self.cg.param_alias.get(key, key)  # fused chains remap rows
            kern = self.cg.kernels.get(key[0])
            if getattr(kern, "lane_env", False) and \
                    str(key[1]).endswith(".gain"):
                # a lane-packed grain bank (graph/fusion.py) splices its
                # voices' envelopes into per-lane rows: no per-voice row
                # exists
                raise ValueError(
                    "this envelope compiled into the grain bank's per-lane "
                    "spliced rows (its per-voice dense row does not exist), "
                    "so it cannot be batch-overridden")
            if key not in self.cg.dense_params:
                raise ValueError(
                    "param was compiled as a constant; schedule at least "
                    "one automation event before batching to make it dense")
            row = self.cg.dense_params.index(key)
            self._rows[row] = convert.snapshot(arr, self._on_card)

    def _stage(self):
        """Send each shard what changed since the last stage, into the
        device buffers that hold it, and return (states, xs, resources) for
        each shard's block walk, in shard order.

        Rows: a shard's (k, nb, P, B) device array is filled on the
        device from the host base rows (nb, P, B), sent once, at the first
        stage; an overridden row goes from its snapshot into its slice,
        its pad filled on the device.  Resources:
        a per-instance leaf is written in place (`convert.upload_into`) at
        the first stage and after an override replaced it; a shared leaf
        once a device.  Each send is a `batch.upload` span.

        `stage_stats` then lists each shard's items, its rows and the
        resource leaves its walk reads, under "uploaded" (sent by this
        stage) or "kept" (left on the device), by name: a leaf as
        "<node key>.<leaf key>" ("n1.data_rows"), a row as "<node
        key>.<param>" ("n3.ratio"); "bytes_uploaded" and "bytes_kept" sum
        their sizes on the device."""
        with span("batch.stage"):
            stats = {"uploaded": [], "kept": [], "bytes_uploaded": 0,
                     "bytes_kept": 0}

            def tally(sent, name, t):
                stats["uploaded" if sent else "kept"].append(name)
                stats["bytes_uploaded" if sent else "bytes_kept"] += \
                    t.numel() * t.element_size()

            shards = self._shards
            if self._staged_states is None:
                self._staged_states = [convert.tree_map(
                    lambda x, sh=sh: x[sh.lo:sh.hi].to(sh.device),
                    self._states)
                    for sh in shards]
            first = self._staged_xs is None
            if first:
                self._staged_xs = []
                for sh in shards:
                    with span("batch.upload"):
                        base = convert.upload(self._base_xs, sh.device)
                        self._staged_xs.append(base.expand(
                            (sh.hi - sh.lo,) + base.shape).contiguous())
            rows, self._rows = self._rows, {}
            names = [f"{_compiler._k(nid)}.{param}"
                     for nid, param in self.cg.dense_params]
            for sh, xs in zip(shards, self._staged_xs):
                for r, name in enumerate(names):
                    if r in rows:
                        with span("batch.upload"):
                            _write_row(xs, r, rows[r][sh.lo:sh.hi])
                    tally(first or r in rows, name, xs[:, :, r])

            batched = self._batched_resources
            stale, self._stale = self._stale, set()
            staged_res = []
            for s, sh in enumerate(shards):
                shared = self._shared_res.setdefault(sh.device, {})
                tree = {}
                for nk, leaves in self._resources.items():
                    tree[nk] = {}
                    for lk, v in leaves.items():
                        if (nk, lk) in batched:
                            key = (s, nk, lk)
                            buf = self._res_buffers.get(key)
                            sent = buf is None or (nk, lk) in stale
                            if sent:
                                with span("batch.upload"):
                                    buf = self._res_buffers[key] = \
                                        convert.upload_into(
                                            buf, v[sh.lo:sh.hi], sh.device)
                        else:
                            buf = shared.get((nk, lk))
                            sent = buf is None
                            if sent:
                                with span("batch.upload"):
                                    buf = shared[nk, lk] = convert.upload(
                                        np.asarray(v)[None], sh.device)
                        tally(sent, f"{nk}.{lk}", buf)
                        tree[nk][lk] = buf
                staged_res.append(tree)
            self.stage_stats = stats
            return list(zip(self._staged_states, self._staged_xs, staged_res))

    def _walk(self) -> list:
        """Each shard's (k, channels, padded_frames) f32 on its device."""
        outs = []
        for sh, (states, xs, res) in zip(self._shards, self._stage()):
            with on_device(sh.device):
                _, out = _compiler.scan_render(sh.cg, states, self.frame0s,
                                               xs, res)
            outs.append(out)
        return outs

    def _bounce(self, quantize, seed) -> list:
        """Each shard's codes on its device: the shard's Philox stream
        starts at its first element's flat index in the whole batch."""
        outs = self._walk()
        per = outs[0][0].numel()
        codes = []
        for sh, out in zip(self._shards, outs):
            with on_device(sh.device):
                codes.append(quantize(out, seed, offset=sh.lo * per))
        return codes

    def _gather(self, parts: list) -> torch.Tensor:
        if len(parts) == 1:
            return parts[0].to(self.device)
        return torch.cat([p.to(self.device) for p in parts])

    def render(self) -> torch.Tensor:
        """-> (batch, channels, padded_frames) f32 on the context's device;
        slice [..., :total_frames] for the render's length."""
        return self._gather(self._walk())

    def render_i16(self, seed: int = 0) -> torch.Tensor:
        """Render and quantize to dithered int16 on the device (kernel K5,
        ops/dither.py, once a shard) before any transfer: half the bytes of
        f32."""
        return self._gather(self._bounce(dither_i16, seed))

    def render_u8(self, seed: int = 0) -> torch.Tensor:
        """Render and compand to dithered 8-bit u-law on the device (kernel
        K6, once a shard): a preview-grade bounce, a quarter of the bytes
        of f32.  Decode host-side with `ops.dither.ulaw_decode_u8`."""
        return self._gather(self._bounce(ulaw_u8, seed))

    def render_stream(self, count: int, updates=None, fetch: str = "i16"):
        """Double-buffered serving loop: yields `count` host numpy arrays,
        dispatching batch k+1's render before fetching batch k, so the
        device computes the next batch while the previous one crosses to
        the host.  On CUDA each batch is copied on a side stream into a
        pinned host buffer of its own (each shard into its rows, from its
        own device), and an event per shard says when it has landed.

        updates: optional callable (gb, k) -> None run before dispatch k to
        change per-batch inputs (override_param / override_buffer); fetch:
        'f32' | 'i16' | 'u8' selects the on-device bounce depth.
        """
        dispatch = {"f32": self._walk,
                    "i16": lambda: self._bounce(dither_i16, 0),
                    "u8": lambda: self._bounce(ulaw_u8, 0)}[fetch]
        copiers: dict = {}
        prev = None
        for k in range(count):
            if updates is not None:
                updates(self, k)
            cur = _fetch_async(dispatch(), self._shards, copiers)
            if prev is not None:
                yield prev()
            prev = cur
        if prev is not None:
            yield prev()


def _write_row(xs: torch.Tensor, r: int, snap: torch.Tensor) -> None:
    """Write row r of a shard's rows xs (k, nb, P, B) from its snapshot
    (k, total_frames) on the host: one copy to xs's device (non-blocking
    from pinned memory), then into the row's blocks there, the last value
    repeated over the pad past total_frames.  In stream order after the
    walks queued before it."""
    k, nb, _, B = xs.shape
    src = snap.to(xs.device, non_blocking=True)
    n, rem = divmod(src.shape[1], B)
    dst = xs[:, :, r, :]
    dst[:, :n].copy_(src[:, :n * B].view(k, n, B))
    if rem:
        dst[:, n, :rem].copy_(src[:, n * B:])
        dst[:, n, rem:].copy_(src[:, -1:].expand(k, B - rem))


def _fetch_async(parts: list, shards: list, copiers: dict):
    """Start copying each shard's part into its rows of one host array;
    return a callable that waits for the copies and returns the array.
    A part on a card is copied on a side stream of that card (`copiers`,
    one a card, made here at first use) into pinned memory."""
    if len(parts) == 1 and parts[0].device.type == "cpu":
        return parts[0].numpy
    on_card = any(p.device.type == "cuda" for p in parts)
    with span("pin"):
        host = torch.empty((shards[-1].hi,) + tuple(parts[0].shape[1:]),
                           dtype=parts[0].dtype, pin_memory=on_card)
    done = []
    for sh, t in zip(shards, parts):
        rows = host[sh.lo:sh.hi]
        if t.device.type != "cuda":
            rows.copy_(t)
            continue
        if t.device not in copiers:
            copiers[t.device] = torch.cuda.Stream(t.device)
        copier = copiers[t.device]
        event = torch.cuda.Event()
        copier.wait_stream(torch.cuda.current_stream(t.device))
        with torch.cuda.stream(copier):
            rows.copy_(t, non_blocking=True)
            event.record(copier)
        # the render's allocator must not hand t's memory out again before
        # the side stream has read it
        t.record_stream(copier)
        done.append(event)

    def result():
        with span("batch.fetch_wait"):
            for event in done:
                event.synchronize()
        return host.numpy()

    return result


# --- mixed-topology batching -----------------------------------------------


def _fp_tokens(v, out: list, depth: int = 0, staged_ids: frozenset = frozenset()):
    """Append hashable fingerprint tokens for one kernel attribute.

    Everything baked into a kernel must reach the fingerprint by value
    (scalars, strings, schedule frames, baked coefficients, and host numpy
    arrays or torch tensors the kernel keeps).  Arrays that ride the
    staged-resource path (the same object returned by `resources()`, or
    named in the kernel's `_fp_staged_attrs`) keep shape/dtype-only
    tokens: per-instance content there is stacked by MixedGraphBatch, so
    value differences must not split buckets."""
    if depth > 6:
        out.append("deep")
        return
    if v is None or isinstance(v, (bool, int, float, str)):
        out.append(repr(v))
    elif isinstance(v, (np.floating, np.integer)):
        out.append(repr(float(v)))
    elif isinstance(v, torch.device):
        out.append(repr(v))
    elif isinstance(v, (list, tuple)):
        out.append(f"seq{len(v)}")
        for item in v:
            _fp_tokens(item, out, depth + 1, staged_ids)
    elif isinstance(v, dict):
        out.append(f"map{len(v)}")
        for k in sorted(v, key=repr):
            out.append(repr(k))
            _fp_tokens(v[k], out, depth + 1, staged_ids)
    elif isinstance(v, (np.ndarray, torch.Tensor)):
        out.append(f"arr{tuple(v.shape)}{v.dtype}")
        if id(v) not in staged_ids:
            # not a staged resource: the kernel may read these values
            # directly, so two graphs differing here must bucket apart
            host = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
                else v
            out.append(hashlib.sha1(
                np.ascontiguousarray(host).tobytes()).hexdigest()[:16])
    elif callable(v):
        # same callable object => same bucket; different callables split
        out.append(f"fn{getattr(v, '__qualname__', '')}{id(v)}")
    elif callable(getattr(v, "process", None)):
        # worklet processor instances carry user state and options the
        # kernel runs verbatim: split by identity, as callables are
        out.append(f"proc{type(v).__name__}{id(v)}")
    else:
        # engine objects (node back-refs etc.): type identity only; their
        # kernel-relevant content is copied onto the kernel
        out.append(type(v).__name__)


def graph_fingerprint(cg) -> str:
    """Structural fingerprint of a compiled graph: two graphs bucket
    together iff one plan can render both, with per-instance dense params,
    initial states and (stacked) resources."""
    toks: list = [
        f"B{cg.block_frames}", f"fs{cg.sample_rate}",
        f"T{cg.total_frames}",   # render length: nb/total may differ
        f"dev{cg.device!r}",
        # the two-rate plan: inner sub-steps and their block (a constant
        # delay's read offset is baked into its kernel, below)
        f"m{cg.two_rate_m}", f"Bi{cg.inner_frames}",
        repr(cg.order),
        repr(cg.dense_params),
        repr(sorted(cg.in_counts.items())),
        repr(sorted(cg.out_counts.items())),
    ]
    # constant params are shared 0-d tensors of the plan -> by value; a
    # fused bank (a kernel with `vector_params`) reads its voices'
    # constants from staged resources instead, stacked per instance
    banks = {nid for nid, k in cg.kernels.items()
             if hasattr(k, "vector_params")}
    for key, plan in sorted(cg.param_plan.items(), key=repr):
        if plan.is_constant and key[0] not in banks:
            toks.append(f"c{key}={np.float32(plan.scalar)!r}")
    for nid in sorted(cg.kernels):
        kern = cg.kernels[nid]
        r = kern.resources() or {}
        staged = {id(leaf) for leaf in r.values()}
        d = getattr(kern, "__dict__", None) or {}
        for name in getattr(kern, "_fp_staged_attrs", ()):
            if isinstance(d.get(name), np.ndarray):
                staged.add(id(d[name]))
        staged_ids = frozenset(staged)
        toks.append(f"k{nid}:{type(kern).__name__}")
        for name in sorted(d):
            toks.append(name)
            _fp_tokens(d[name], toks, staged_ids=staged_ids)
        for lk in sorted(r):
            arr = np.asarray(r[lk])
            toks.append(f"r{lk}:{arr.shape}{arr.dtype}")
    return hashlib.sha256("|".join(toks).encode()).hexdigest()


class MixedGraphBatch:
    """Batch-render a heterogeneous corpus of graphs in one call.

    Contexts are bucketed by `graph_fingerprint`; each bucket is planned
    once (the first member's plan serves all members) and renders as one
    GraphBatch with per-instance dense automation, initial states, and
    stacked resources where members' staged arrays differ (e.g. different
    audio buffers of the same shape).  Contexts whose structure, baked
    constants, length, device or resource shapes differ land in different
    buckets: correctness never depends on bucketing, only the number of
    block walks does.  Build same-topology contexts in the same node
    order: node ids are part of the structure.

    With `mesh=`, a bucket whose size the mesh's size divides renders
    sharded over it; any other bucket renders unsharded on its context's
    device (its GraphBatch's `mesh` is None), as in the JAX package."""

    def __init__(self, contexts, mesh=None):
        contexts = list(contexts)
        if not contexts:
            raise ValueError("need at least one context")
        self.contexts = contexts
        self.mesh = mesh
        cgs = [_compiler.compile_graph(
            dict(c._nodes), list(c._edges), c.sample_rate, c.length,
            c._destination.node_id, c.device) for c in contexts]
        buckets: dict = {}
        for idx, (ctx, cg) in enumerate(zip(contexts, cgs)):
            buckets.setdefault(graph_fingerprint(cg), []).append((idx, ctx, cg))
        self._buckets = []
        for members in buckets.values():
            idxs = [m[0] for m in members]
            _, leader_ctx, leader_cg = members[0]
            bucket_mesh = mesh
            if mesh is not None and len(members) % mesh.devices.size:
                bucket_mesh = None   # odd bucket: render unsharded
            gb = GraphBatch(leader_ctx, batch=len(members), mesh=bucket_mesh,
                            _cg=leader_cg)
            # per-instance dense automation straight from each member's
            # own compiled timelines (row order is part of the
            # fingerprint): a snapshot a row, over the padded frames,
            # that the first stage sends as it sends an override_param's
            packed = np.stack([_compiler.pack_dense_params(
                cg, gb.nb * gb.cg.block_frames) for _, _, cg in members])
            for r in range(packed.shape[1]):
                gb._rows[r] = convert.snapshot(packed[:, r], gb._on_card)
            # initial states stacked per member, not the leader's broadcast
            gb._states = convert.stack_states(
                [_compiler.zero_states(cg) for _, _, cg in members])
            # resources: leaves identical across members stay shared;
            # differing leaves stack along the batch axis
            member_res = [_compiler.collect_resources(cg)
                          for _, _, cg in members]
            for nk, leaves in gb._resources.items():
                for lk in leaves:
                    arrs = [np.asarray(mr[nk][lk]) for mr in member_res]
                    if all(np.array_equal(arrs[0], a) for a in arrs[1:]):
                        continue
                    leaves[lk] = np.stack(arrs)
                    gb._batched_resources.add((nk, lk))
            self._buckets.append((idxs, gb))

    @property
    def num_buckets(self) -> int:
        return len(self._buckets)

    def render(self) -> list:
        """Render every context; returns a list aligned with the input
        order, each entry a (channels, length) float32 numpy array."""
        results: list = [None] * len(self.contexts)
        # dispatch every bucket first (the device queue pipelines), fetch
        # after
        outs = [(idxs, gb, gb.render()) for idxs, gb in self._buckets]
        for idxs, gb, out in outs:
            host = out.cpu().numpy()
            for j, idx in enumerate(idxs):
                results[idx] = host[j, :, : gb.total_frames]
        return results
