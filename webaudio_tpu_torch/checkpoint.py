"""Checkpoint / resume for long renders.

The reference has no persistence (SURVEY.md §5: "nothing persistent");
because this engine's node state is an explicit tree of tensors carried
from block to block, checkpointing is a natural extension: serialize the
state dict + frame cursor, resume by seeding the block walk with it.
Useful for multi-hour renders, preemptible workers, and migrating renders
across hosts and cards.  Ported from `webaudio_tpu/checkpoint.py`.

The file format is the JAX package's: an npz holding a `__header__` JSON
(`frame`, `n_leaves`, `meta`) and the leaves `leaf_i` in JAX's tree-flatten
order (dict keys sorted, depth first, None subtrees holding no leaf).  A
checkpoint the JAX `RenderSession` wrote (its header also holds the JAX
`treedef`) therefore restores here through `convert.states_from_jax`.
This package's header adds the leaves' `paths` ("n3/ring"), against which
a restore checks the graph; every restore checks each leaf's shape and
dtype.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .convert import batch_states, states_from_jax, unbatch_states
from .diagnostics import span
from .graph import compiler as _compiler


def _flatten(tree, prefix=""):
    """[(path, leaf)] in JAX's tree-flatten order: dict keys sorted, depth
    first, None holding no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{prefix}{k}/")
        return out
    return [(prefix.rstrip("/"), tree)]


def _unflatten(template, leaves):
    """`template`'s structure with its leaves replaced, in `_flatten`'s
    order, by the tensors of `leaves`."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(template)


def save_states(path: str, states: dict, frame: int, meta: dict | None = None):
    """Serialize a state tree (dict of dicts of tensors, one instance, no
    instance axis) + frame cursor; returns the number of leaves."""
    flat = _flatten(states)
    arrays = {f"leaf_{i}": x.detach().cpu().numpy()
              for i, (_, x) in enumerate(flat)}
    header = {
        "frame": int(frame),
        "n_leaves": len(flat),
        "paths": [p for p, _ in flat],
        "meta": meta or {},
    }
    with open(path, "wb") as f:
        np.savez(f, __header__=json.dumps(header), **arrays)
    return len(flat)


def load_states(path: str, template_states: dict, device):
    """Load a checkpoint onto `device`; the template (from a fresh plan)
    gives the tree's structure, and every leaf must match its shape and
    dtype.  Returns (states, frame)."""
    with np.load(path, allow_pickle=False) as z:
        header = json.loads(str(z["__header__"]))
        leaves = [z[f"leaf_{i}"] for i in range(header["n_leaves"])]
    tmpl = _flatten(template_states)
    if len(tmpl) != len(leaves):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves, graph expects "
            f"{len(tmpl)} — was the graph changed?")
    paths = header.get("paths")
    if paths is not None and paths != [p for p, _ in tmpl]:
        raise ValueError("checkpoint's state paths differ from the graph's "
                         "— was the graph changed?")
    for (p, t), x in zip(tmpl, leaves):
        if tuple(t.shape) != x.shape or \
                torch.from_numpy(np.empty(0, x.dtype)).dtype != t.dtype:
            raise ValueError(
                f"checkpoint leaf {p} is {x.dtype}{list(x.shape)}, the graph "
                f"expects {t.dtype}{list(t.shape)}")
    # either package's leaves, in the same order
    tensors = [states_from_jax(x, device) for x in leaves]
    return _unflatten(template_states, tensors), header["frame"]


class RenderSession:
    """Incremental offline rendering with checkpoint/resume.

    >>> session = RenderSession(ctx)
    >>> chunk = session.step(16384)      # the next 16,384 frames
    >>> session.save("ckpt.npz")
    >>> session2 = RenderSession(ctx2)   # same graph topology
    >>> session2.restore("ckpt.npz")
    >>> session2.step(16384)             # continues from there

    Every step renders on the context's device with a fixed block (state
    shapes such as delay rings and FDLs depend on it) and every param as
    a dense row compiled for that step on the host (the online-loop
    pattern): the LTI biquad runs its a-rate scan, oscillators their
    cumsum phase.

    While a torch profiler records, a step's host work is traced as the
    spans `session.rows` (the dense rows compiled, laid out in blocks and
    uploaded), `session.walk` (the block walk enqueued), `session.fetch`
    (`step`'s copy of the output to the host, its wait for the walk
    included) and `session.advance` (the live timelines advanced), and
    `save` and `restore` as `session.save` and `session.restore`.
    `stats` counts the steps taken, the saves and restores, and holds the
    last save's bytes on disk and state leaves."""

    def __init__(self, context, quanta_per_block: int = 128):
        self._context = context
        self._frame = 0
        self._states = None          # with the walk's instance axis of 1
        self._cg = None
        self._version = None
        self._qpb = quanta_per_block
        self.block_frames = quanta_per_block * 128
        self.stats = {"steps": 0, "saves": 0, "restores": 0,
                      "save_bytes": 0, "save_leaves": 0}

    def _ensure_compiled(self):
        """One plan per graph version, with a fixed block size and dense
        params streamed per step."""
        ctx = self._context
        if self._cg is not None and self._version == ctx._graph_version:
            return
        self._cg = _compiler.compile_graph(
            dict(ctx._nodes), list(ctx._edges), ctx.sample_rate,
            self.block_frames, ctx._destination.node_id, ctx.device,
            start_frame=self._frame, quanta_per_block=self._qpb,
            force_dense_params=True)
        self._version = ctx._graph_version

    def step_device(self, frames: int) -> torch.Tensor:
        """Render the next `frames` frames (a multiple of the session block
        size); returns the (channels, frames) f32 tensor on the context's
        device."""
        if frames % self.block_frames != 0:
            raise ValueError(
                f"frames must be a multiple of {self.block_frames}")
        self._ensure_compiled()
        cg = self._cg
        ctx = self._context
        with span("session.rows"):
            rows = np.zeros((len(cg.dense_params), frames), np.float32)
            for i, key in enumerate(cg.dense_params):
                plan = cg.param_objects[key].compile_for_render(
                    ctx.sample_rate, frames, self._frame, force_dense=True)
                rows[i] = plan.dense
            # a cyclic graph may plan a smaller (delay-bounded) block that
            # divides the requested session block (compile_graph's clamp)
            args = _compiler.render_args(cg, rows, self._frame, self._states)
        with span("session.walk"):
            self._states, out = _compiler.scan_render(cg, *args)
        self._frame += frames
        ctx._current_time = self._frame / ctx.sample_rate
        # advance live timelines so control-side values stay coherent
        with span("session.advance"):
            for node in ctx._nodes.values():
                for p in node.params.values():
                    p.advance_dense(ctx.sample_rate, frames,
                                    self._frame - frames)
        self.stats["steps"] += 1
        return out[0, :, :frames]

    def step(self, frames: int) -> np.ndarray:
        """Render the next `frames` frames (a multiple of the session block
        size); returns (channels, frames) f32 on the host."""
        out = self.step_device(frames)
        with span("session.fetch"):
            return out.cpu().numpy()

    @property
    def frame(self) -> int:
        return self._frame

    def save(self, path: str):
        with span("session.save"):
            leaves = save_states(
                path, unbatch_states(self._states), self._frame,
                meta={"sample_rate": self._context.sample_rate,
                      "block_frames": self.block_frames})
        self.stats["saves"] += 1
        self.stats["save_bytes"] = os.path.getsize(path)
        self.stats["save_leaves"] = leaves

    def restore(self, path: str):
        with span("session.restore"):
            self._ensure_compiled()
            states, self._frame = load_states(
                path, _compiler.zero_states(self._cg), self._cg.device)
            self._states = batch_states(states, 1)
            self._context._current_time = \
                self._frame / self._context.sample_rate
            # consume timelines up to the restored cursor
            for node in self._context._nodes.values():
                for p in node.params.values():
                    p.advance_dense(self._context.sample_rate, self._frame,
                                    0)
        self.stats["restores"] += 1
