"""Batched graph rendering: many instances of one graph in one block walk.

Ported from `webaudio_tpu/parallel/batch.py`.  The reference renders one
graph per thread; the engine's scale axis is batches of independent
graphs.  The JAX package `vmap`s its scan over stacked params, states and
resources; here the same batch is the block walk's leading instance axis
(`graph/compiler.py`), so every launch of the loop carries all N
instances.  One card, no mesh: `mesh=` raises `NotSupportedError`.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from .. import convert
from ..constants import NotSupportedError
from ..graph import compiler as _compiler
from ..ops.dither import dither_i16, ulaw_u8


def _refuse_mesh(mesh):
    if mesh is not None:
        raise NotSupportedError(
            "sharding a batch over a device mesh is not ported to "
            "webaudio_tpu_torch yet; render on one device")


class GraphBatch:
    """Render `batch` instances of one graph topology in one block walk on
    the context's device.

    Instances share the topology and any baked constants (audio buffers,
    schedules); per-instance variation comes from `override_param` (dense
    per-sample automation differing per instance), `override_buffer`
    (per-instance resources) and per-instance initial states.  Everything
    is staged on the device once and re-staged only where an override
    changed it, so a staged batch re-renders without rebuilding or
    re-copying anything.
    """

    def __init__(self, context, batch: int, mesh=None, _cg=None):
        _refuse_mesh(mesh)
        self.context = context
        self.batch = batch
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

        # base param rows (shared across instances unless overridden),
        # host (batch, nb, P, B); override_param writes into it
        base = _compiler.block_rows(
            _compiler.pack_dense_params(self.cg, self.nb * B), B)
        self._xs = np.broadcast_to(base[None], (batch,) + base.shape).copy()
        self._states = convert.batch_states(_compiler.zero_states(self.cg),
                                            batch)
        # static kernel data (one instance's numpy): shared by every
        # instance unless overridden per instance via override_buffer, then
        # stacked along a leading batch axis
        self._resources = _compiler.collect_resources(self.cg)
        self._batched_resources: set = set()   # (node_key, leaf_key)
        self._staged_xs = None
        self._staged_res = None

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
            self._staged_res = None
            return
        if key not in leaves:
            raise ValueError(f"node has no staged resource {key!r}")
        base = np.asarray(leaves[key])
        if (nk, key) in self._batched_resources:
            base = base[0]
        stacked = np.asarray(stacked, base.dtype)
        if stacked.shape != (self.batch,) + base.shape:
            raise ValueError(
                f"expected {(self.batch,) + base.shape}, got {stacked.shape}")
        leaves[key] = stacked
        self._batched_resources.add((nk, key))
        self._staged_res = None

    def override_param(self, node, param_name: str, dense: np.ndarray):
        """Give each instance its own automation row.

        dense: (batch, total_frames) f32, per-instance per-sample values.
        """
        B = self.cg.block_frames
        padded = self.nb * B
        arr = np.asarray(dense, np.float32)
        if arr.shape != (self.batch, self.total_frames):
            raise ValueError(
                f"expected ({self.batch}, {self.total_frames}), got {arr.shape}")
        if arr.shape[1] < padded:
            arr = np.concatenate(
                [arr, np.repeat(arr[:, -1:], padded - arr.shape[1], 1)], axis=1)
        key = (node.node_id, param_name)
        key = self.cg.param_alias.get(key, key)  # fused chains remap rows
        kern = self.cg.kernels.get(key[0])
        if getattr(kern, "lane_env", False) and str(key[1]).endswith(".gain"):
            # a lane-packed grain bank (graph/fusion.py) splices its voices'
            # envelopes into per-lane rows: no per-voice row exists
            raise ValueError(
                "this envelope compiled into the grain bank's per-lane "
                "spliced rows (its per-voice dense row does not exist), so "
                "it cannot be batch-overridden")
        if key not in self.cg.dense_params:
            raise ValueError(
                "param was compiled as a constant; schedule at least one "
                "automation event before batching to make it dense")
        row = self.cg.dense_params.index(key)
        self._xs[:, :, row, :] = arr.reshape(self.batch, self.nb, B)
        self._staged_xs = None

    def _stage(self):
        """Upload params and resources where an override changed them (from
        snapshots no later override touches) and return (states, xs,
        resources) for the block walk."""
        if self._staged_xs is None:
            self._staged_xs = convert.upload(self._xs, self.device)
        if self._staged_res is None:
            self._staged_res = convert.stage_resources(
                self._resources, self.device, self._batched_resources)
        return self._states, self._staged_xs, self._staged_res

    def render(self) -> torch.Tensor:
        """-> (batch, channels, padded_frames) f32 on the device; slice
        [..., :total_frames] for the render's length."""
        states, xs, res = self._stage()
        _, out = _compiler.scan_render(self.cg, states, self.frame0s, xs, res)
        return out

    def render_i16(self, seed: int = 0) -> torch.Tensor:
        """Render and quantize to dithered int16 on the device (kernel K5,
        ops/dither.py) before any host transfer: half the bytes of f32."""
        return dither_i16(self.render(), seed)

    def render_u8(self, seed: int = 0) -> torch.Tensor:
        """Render and compand to dithered 8-bit u-law on the device (kernel
        K6): a preview-grade bounce, a quarter of the bytes of f32.
        Decode host-side with `ops.dither.ulaw_decode_u8`."""
        return ulaw_u8(self.render(), seed)

    def render_stream(self, count: int, updates=None, fetch: str = "i16"):
        """Double-buffered serving loop: yields `count` host numpy arrays,
        dispatching batch k+1's render before fetching batch k, so the
        device computes the next batch while the previous one crosses to
        the host.  On CUDA each batch is copied on a side stream into a
        pinned host buffer of its own, and an event per batch says when it
        has landed.

        updates: optional callable (gb, k) -> None run before dispatch k to
        change per-batch inputs (override_param / override_buffer); fetch:
        'f32' | 'i16' | 'u8' selects the on-device bounce depth.
        """
        dispatch = {"f32": self.render,
                    "i16": self.render_i16,
                    "u8": self.render_u8}[fetch]
        copier = (torch.cuda.Stream(self.device)
                  if self.device.type == "cuda" else None)
        prev = None
        for k in range(count):
            if updates is not None:
                updates(self, k)
            cur = _fetch_async(dispatch(), copier)
            if prev is not None:
                yield prev()
            prev = cur
        if prev is not None:
            yield prev()


def _fetch_async(t: torch.Tensor, copier):
    """Start copying t to the host; return a callable that waits for the
    copy and returns the numpy array."""
    if copier is None:
        return t.numpy
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    done = torch.cuda.Event()
    copier.wait_stream(torch.cuda.current_stream(t.device))
    with torch.cuda.stream(copier):
        host.copy_(t, non_blocking=True)
        done.record(copier)
    # the render's allocator must not hand t's memory out again before the
    # side stream has read it
    t.record_stream(copier)

    def result():
        done.synchronize()
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
    order: node ids are part of the structure."""

    def __init__(self, contexts, mesh=None):
        _refuse_mesh(mesh)
        contexts = list(contexts)
        if not contexts:
            raise ValueError("need at least one context")
        self.contexts = contexts
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
            gb = GraphBatch(leader_ctx, batch=len(members), _cg=leader_cg)
            B = gb.cg.block_frames
            # per-instance dense automation straight from each member's
            # own compiled timelines (row order is part of the fingerprint)
            for j, (_, _, cg) in enumerate(members):
                gb._xs[j] = _compiler.block_rows(
                    _compiler.pack_dense_params(cg, gb.nb * B), B)
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
