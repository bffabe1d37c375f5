"""Buffer-sample fetch as ONE row gather.

AudioBufferSource-style kernels lerp between sample i and i+1 at
playhead-dependent indices.  The buffer is staged once in a pair-row layout

    rows[i] = [x_0[i], ..., x_{C-1}[i],  x_0[i+1], ..., x_{C-1}[i+1]]

so a single row gather of (idx,) fetches both lerp taps for every channel:
2C contiguous floats per playhead.  End-of-buffer neighbors (loop wrap /
linear extrapolation) are per-kernel CONSTANTS and are patched in by the
caller with a `where` on its own `beyond` predicate.  Ported from
`webaudio_tpu/ops/bufread.py`: the staging stays numpy, `gather_pairs`
takes torch tensors.
"""

from __future__ import annotations

import numpy as np
import torch


def pair_rows(data: np.ndarray) -> np.ndarray:
    """(C, L) f32 -> (L, 2C) f32 pair-row layout (host-side, staged once).
    Row L-1's 'next' half is zero; callers mask it via their beyond rule."""
    C, L = data.shape
    rows = np.zeros((L, 2 * C), np.float32)
    rows[:, :C] = data.T
    rows[:-1, C:] = data.T[1:]
    return rows


def edge_vals(data: np.ndarray, loop: bool = False,
              wrap_index: int = 0) -> np.ndarray:
    """Per-buffer end-of-buffer 'next tap' constant (C,) f32:
    looping sources wrap to the loop start sample
    (audio_buffer_source.rs:772-795); non-looping sources linearly
    extrapolate from the last two samples (rs:795-815)."""
    C, L = data.shape
    if loop:
        return np.asarray(data[:, min(max(wrap_index, 0), L - 1)], np.float32)
    return (2.0 * data[:, L - 1] - data[:, max(L - 2, 0)]).astype(np.float32)


def gather_pairs(rows: torch.Tensor, idx: torch.Tensor):
    """rows (..., L, 2C), integer idx of any shape -> (a, b) each
    (..., C, *idx.shape): a = data[..., :, idx], b = data[..., :, idx + 1]
    (b undefined at idx == L-1).  Leading axes of rows (per-instance
    buffers, or a shared one with a leading 1) share the one idx."""
    lead = rows.shape[:-2]
    C = rows.shape[-1] // 2
    flat = rows[..., idx.reshape(-1), :]             # (..., M, 2C)
    g = flat.reshape(lead + idx.shape + (2, C))
    g = torch.movedim(g, (-2, -1), (0, len(lead) + 1))  # (2, ..., C, *idx.shape)
    return g[0], g[1]


def gather_lanes(rows: torch.Tensor, idx: torch.Tensor):
    """rows (R, L, 2C), integer idx (M, 1, B), one row of indices an
    instance -> (a, b) each (max(R, M), C, B): instance i reads its own
    buffer (R = N) or the shared one (R = 1) at its own indices (M = N) or
    the shared ones (M = 1)."""
    C = rows.shape[-1] // 2
    r = torch.arange(rows.shape[0], device=rows.device)[:, None]
    g = rows[r, idx[:, 0]]                           # (max(R, M), B, 2C)
    g = g.transpose(1, 2)                            # (.., 2C, B)
    return g[:, :C], g[:, C:]
