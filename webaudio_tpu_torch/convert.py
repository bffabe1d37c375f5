"""Carry resources and render states over from the JAX package, and stage
them for the block walk.

The engine has no learned weights.  What one render hands the next is:

- the per-node resources (`graph.compiler.collect_resources`): buffer
  layouts (`data_rows`, `edge_vals`, `data_tiled`, `data_ext`), a fused
  bank's per-voice schedule and lane tables, truncated-IR spectra (`h`:
  the LTI biquad's and the IIR filter's, (1, K, P+1) complex64, and the
  convolver's, one row per lane) and shaping curves (`curve`); an oscillator or constant-source bank's
  per-voice constants (`freq_const`, `det_const`, `computed_const`,
  `off_const`, `gain_const`, `ratios`), custom wave `tables`, IR spectra
  stack `h`, pan gains (`pan_gl`, `pan_gr`) and `curves`; an oscillator's
  custom `table`; an OscillatorBankNode's voices (`freq`, `start`, ...);
  an HRTF panner's vertex spectra (`spectra`, (V, 2, K, P+1) complex64),
  direction grid (`grid_vids`, `grid_w`) and front-direction spectra
  (`front`; the JAX package stages DFT matrices in its place);
- the node states that cross a suspend boundary: the FDL delay line
  (`spectra`, `tail`: a biquad's, an IIR filter's, a convolver's), a
  DelayNode's `ring` (C, R) of the last R input frames (frame t at
  t mod R), the buffer playhead (`buffer_time`, `elapsed`,
  `entered`), the a-rate biquad's history (`xy`), an oscillator's f64
  `phase` carry, a voice bank's f64 `phase` (one per voice) with its
  filter stage's FDL (`fdl_spectra`, `fdl_tail`), an oversampled
  WaveShaper's FIR histories (`up`: the last 48 input samples a channel,
  `down`: the last 48 x factor upsampled ones), a DynamicsCompressor's
  level `detector`, lookahead `delay` ring (C, frames) and last
  `reduction` in dB, an AnalyserNode's `ring` of the last 32,768 mono
  samples, and an HRTF panner's FDL (`xspec`, the last K-1 input spectra;
  `tail`, the last input quantum) with its previous quantum's HRIR
  spectra and gain (`h_prev`, `g_prev`) and `started`.

Both arrive as trees of dicts whose leaves are numpy arrays (a JAX tree
converts with `jax.tree_util.tree_map(np.asarray, tree)`, which this
module does not import).  Leaves keep their dtype: f64 stays f64,
complex64 stays complex64, bool stays bool.

The block walk (`graph/compiler.py`) renders N instances at once: every
state leaf carries a leading instance axis of N, and every resource leaf a
leading axis of 1 (shared by all instances) or N (one per instance), the
written-out form of the JAX package's `vmap(in_axes=(0, 0, res_axes))`.
"""

from __future__ import annotations

import numpy as np
import torch

from .diagnostics import span


def tree_map(fn, tree):
    """Apply fn to every non-None leaf of a tree of dicts."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def snapshot(arr: np.ndarray, pin: bool) -> torch.Tensor:
    """A host copy of `arr` that nothing else touches, page-locked where
    `pin` (a card will read it without blocking); the caller may change
    `arr` as soon as this returns.  The allocation is a `pin` span."""
    src = torch.from_numpy(np.ascontiguousarray(arr))
    with span("pin"):
        host = torch.empty(src.shape, dtype=src.dtype, pin_memory=pin)
    host.copy_(src)
    return host


def upload(arr: np.ndarray, device) -> torch.Tensor:
    """Copy a host array to `device` from a `snapshot`: on CUDA a pinned
    one and a non-blocking copy (the host may overwrite `arr` while the
    copy is in flight, and the copy does not wait for work already queued
    on the stream); on the CPU the snapshot is the copy."""
    on_card = torch.device(device).type == "cuda"
    host = snapshot(arr, on_card)
    return host.to(device, non_blocking=True) if on_card else host


def upload_into(dst, arr: np.ndarray, device) -> torch.Tensor:
    """`upload(arr, device)`, written into `dst` where it has arr's shape
    and dtype (in stream order, after the work queued before it), else
    into a new tensor; returns the tensor written."""
    arr = np.ascontiguousarray(arr)
    if dst is None or tuple(dst.shape) != arr.shape or \
            dst.dtype != torch.from_numpy(arr[:0]).dtype:
        return upload(arr, device)
    on_card = torch.device(device).type == "cuda"
    src = snapshot(arr, True) if on_card else torch.from_numpy(arr)
    dst.copy_(src, non_blocking=on_card)
    return dst


def to_torch_tree(tree, device):
    """Copy a tree of dicts with numpy leaves onto `device` as torch
    tensors of the same dtypes; None leaves stay None."""
    return tree_map(lambda x: torch.from_numpy(np.array(x)).to(device), tree)


def stage_resources(tree: dict, device) -> dict:
    """Stage a `collect_resources` tree ({node_key: {leaf_key: array}}) for
    the block walk: every leaf is shared by the instances and gets a
    leading axis of 1."""
    return {nk: {lk: upload(np.asarray(v)[None], device)
                 for lk, v in leaves.items()}
            for nk, leaves in tree.items()}


def batch_states(states: dict, n: int) -> dict:
    """Unbatched states (each kernel's `init_state()`) -> the walk's states:
    every leaf repeated along a new leading instance axis of n."""
    return tree_map(lambda x: x.unsqueeze(0).repeat((n,) + (1,) * x.dim()),
                    states)


def stack_states(member_states: list) -> dict:
    """Stack the unbatched states of N members (same structure) along a new
    leading instance axis."""
    first = member_states[0]
    if isinstance(first, dict):
        return {k: stack_states([m[k] for m in member_states]) for k in first}
    if first is None:
        return None
    return torch.stack(member_states)


def unbatch_states(states: dict) -> dict:
    """The only instance's states, without the instance axis."""
    return tree_map(lambda x: x[0], states)


def resources_from_jax(tree, device):
    """A JAX `collect_resources` tree (numpy leaves) -> the port's
    resources on `device`, without the instance axis."""
    return to_torch_tree(tree, device)


def states_from_jax(tree, device):
    """A JAX render's final states (numpy leaves) -> init states for the
    port's `render_compiled` on `device`."""
    return to_torch_tree(tree, device)
