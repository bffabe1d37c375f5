"""Grain reads: the grouped two-tap lerp and the whole grain bank, as CUDA
kernels and their plain versions.

Ports the TPU kernels of `webaudio_tpu/ops/grain_read.py`:

- K3 `grouped_row_lerp_v`, K4 `windowed_read_tpu` and K7
  `grouped_row_lerp_pl` compute one contract, `grouped_row_lerp`
  (equal to `windowed_read_reference` under `windowed_lerp`'s w0/loc).
  For each group of g samples along the last axis of `pi`:

      w0  = min(pi[first], pi[last])
      loc = clip(pi - w0, 0, w - 2)
      w0  = w0 mod wrap_len                  (when wrap_len > 0)
      out[c] = ext[c, w0 + loc] * (1 - fr) + ext[c, w0 + loc + 1] * fr

  `grouped_lerp` serves all three (and the JAX study modes grouped,
  grouped_t, grouped_t2 and grouped_dot, which compute the same function).
- K2 `_kernel_grain_fused` under `_grain_bank_fused`: a lane-packed grain
  bank's playhead, schedule and buffer-bound masks, lerp, non-looping
  end-of-buffer correction and clipped envelope, summed over the K lanes
  in ascending k.  `grain_bank` serves it.

Both read the (C, L + W + 2) extended buffer layout directly (column L
holds the end-of-buffer constant, and whole-buffer loops carry their
continuation past it).  The TPU staged w-wide row copies of that layout
and padded them to its tiles only to save gather descriptors; Hopper
gathers from L2, so nothing is staged.

Instances: `ext` is (1 or I, C, Lx); the sample-index tensors carry a
leading axis of 1 or I too, and the outputs carry I.  The wrappers launch
their kernel (`csrc/grain_read.cu`) for CUDA tensors and raise
`KernelError` for anything they cannot take; they run the plain versions
only for tensors on the CPU.  Kernel and plain version agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..constants import RENDER_QUANTUM_SIZE
from .cuda_lib import KernelError, check, load_library

_SOURCE = "grain_read.cu"

RENDER_QUANTUM_MAX_GROUP = 128   # a group must stay within one quantum
_MAX_GRID_YZ = 65535             # rows a grouped-lerp launch takes
_MAX_INDEX = 2**31 - 1024        # sample indices the kernels keep in 32 bits

# the non-looping end-of-buffer rule's "frac ~= 1" threshold, as the f32
# that JAX and torch compare an f32 frac with
EDGE_FRAC = float(np.float32(1.0 - 1e-6))


def pick_window(rmax: float, block_frames: int):
    """(Qs, W) windowed-read geometry for max |buffer samples per output
    frame| `rmax`, or (0, 0) when no bounded window fits.  Qs stays <= one
    render quantum."""
    for Qs in (128, 64, 32):
        if block_frames % Qs:
            continue
        W = 64 * int(np.ceil((Qs * rmax + 6) / 64.0))
        if W <= 512 and W <= 4 * Qs:
            return Qs, W
    return 0, 0


def pick_group(rmax: float, C: int, L: int, block_frames: int,
               wide: bool = False):
    """(g, w) grouped-read geometry, or (0, 0) when ineligible: rows of
    w <= 32 lanes (48 with `wide`, the grain bank's geometry, which
    prefers g = 32) and a staged row matrix <= 128 MB, as the JAX package
    bounds them, so both packages pick the same geometry."""
    wmax = 48 if wide else 32
    for g in ((32, 16, 8) if wide else (16, 8)):
        if block_frames % g or g > RENDER_QUANTUM_MAX_GROUP:
            continue
        w = int(np.ceil(g * rmax)) + 3
        if w <= wmax and (L + 2) * C * w * 4 <= (128 << 20):
            return g, w
    return 0, 0


def _lead(*tensors) -> int:
    """The common instance count of tensors whose leading axis is 1 or I."""
    n = max(t.shape[0] for t in tensors)
    for t in tensors:
        if t.shape[0] not in (1, n):
            raise KernelError(f"leading axes {[x.shape[0] for x in tensors]} "
                              "are neither 1 nor one common count")
    return n


def _taps(ext: torch.Tensor, idx: torch.Tensor):
    """ext (Ie, C, Lx), integer idx (Ii, M, B) -> ext[c, idx] and
    ext[c, idx + 1], each (I, C, M, B)."""
    n = _lead(ext, idx)
    Ie, C, Lx = ext.shape
    _, M, B = idx.shape
    flat = idx.reshape(idx.shape[0], 1, M * B).expand(n, C, M * B)
    src = ext.expand(n, C, Lx)
    a = torch.gather(src, 2, flat).reshape(n, C, M, B)
    b = torch.gather(src, 2, flat + 1).reshape(n, C, M, B)
    return a, b


def grouped_lerp_reference(ext, pi, fr, g: int, w: int, wrap_len: int = 0):
    """Plain version of the grouped two-tap lerp: ext (Ie, C, Lx) f32;
    pi (Ip, R, B) integer sample indices, monotone within each g-sample
    group; fr (Ip, R, B) f32 -> (I, C, R, B) f32.  Reads are clamped to
    the layout, as XLA's gathers clamp them."""
    Ip, R, B = pi.shape
    Lx = ext.shape[-1]
    piq = pi.to(torch.int64).reshape(Ip, R, B // g, g)
    w0 = torch.minimum(piq[..., 0], piq[..., -1])
    loc = torch.clamp(piq - w0[..., None], 0, w - 2)
    if wrap_len:
        w0 = torch.remainder(w0, wrap_len)
    idx = torch.clamp(w0[..., None] + loc, 0, Lx - 2).reshape(Ip, R, B)
    a, b = _taps(ext, idx)
    f = fr[:, None]
    return a * (1.0 - f) + b * f


def grain_bank_reference(ext, edge, ok, sv, ev, base_i, base_f, rate, gain,
                         frame0: torch.Tensor, L: int, gl0: float,
                         gl1: float):
    """Plain version of the grain bank (K2's contract).

    ext (Ie, C, Lx) f32 with column L the end-of-buffer constant; edge
    (Ie, C) f32; per-quantum lane fields (If, K, nq): ok, sv, ev
    (start/stop frames), base_i int32 and base_f, rate f32 (the playhead
    at the quantum start, split, and buffer samples per frame); gain
    (Ig, K, B) f32 envelope rows, B = nq * 128, clipped to [gl0, gl1];
    frame0 the block's first frame, a 0-d int64 tensor (device data, as
    the block walk's).  -> (I, C, B) f32: the masked,
    enveloped lane samples summed over k in ascending order."""
    Q = RENDER_QUANTUM_SIZE
    If, K, nq = ok.shape
    B = nq * Q
    dev = ext.device

    def per_sample(x):                                   # (If, K, nq) -> B
        return x[..., None].expand(If, K, nq, Q).reshape(If, K, B)

    j = torch.arange(Q, dtype=torch.float32, device=dev).repeat(nq)
    t = frame0 + torch.arange(B, dtype=torch.int64, device=dev)
    delta = per_sample(base_f) + per_sample(rate) * j
    dfl = torch.floor(delta)
    idx = per_sample(base_i).to(torch.int64) + dfl.to(torch.int64)
    frac = delta - dfl
    piv = torch.clamp(idx, 0, L - 1)
    valid = ((per_sample(ok) != 0) & (t >= per_sample(sv))
             & (t < per_sample(ev)) & (idx >= 0) & (idx <= L - 1))
    a, b = _taps(ext, piv)                               # (I, C, K, B)
    f = frac[:, None]
    smp = a * (1.0 - f) + b * f
    et = torch.where((piv + 1 >= L) & ((frac >= EDGE_FRAC) | (piv == 0)),
                     frac, torch.zeros_like(frac))
    smp = smp - edge[:, :, None, None] * et[:, None]
    env = torch.clamp(gain, float(np.float32(gl0)),
                      float(np.float32(gl1)))[:, None]
    vals = torch.where(valid[:, None], smp, torch.zeros_like(smp)) * env
    out = vals[:, :, 0]
    for k in range(1, K):
        out = out + vals[:, :, k]
    return out


def _bind(lib):
    """The C entry points of a loaded grain_read library, typed."""
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lerp = lib.grouped_lerp_f32
    # ext, pi, fr, out, I, ext_inst, pi_inst, C, Lx, R, B, g, w, wrap, stream
    lerp.argtypes = [p, p, p, p, i, i, i, i, ll, i, ll, i, i, ll, p]
    lerp.restype = ctypes.c_int
    bank = lib.grain_bank_launch
    # ext, edge, ok, sv, ev, base_i, base_f, rate, gain, out,
    # I, ext_inst, field_inst, gain_inst, C, Lx, L, K, nq, frame0 (a
    # device pointer), gl0, gl1, edge_frac, stream
    bank.argtypes = [p] * 10 + [i, i, i, i, i, ll, ll, i, i, p, f, f, f, p]
    bank.restype = ctypes.c_int
    return {"grouped_lerp": lerp, "grain_bank": bank}


@functools.cache
def _launchers():
    return _bind(load_library(_SOURCE))


def _launch_lerp(entry, out, ext, pi, fr, g, w, wrap_len=0):
    """One launch of the grouped-lerp C entry point `entry` on checked
    CUDA tensors, writing into `out` (I, C, R, B)."""
    check(entry(ext.data_ptr(), pi.data_ptr(), fr.data_ptr(), out.data_ptr(),
                out.shape[0], int(ext.shape[0] > 1), int(pi.shape[0] > 1),
                ext.shape[1], ext.shape[2], pi.shape[1], pi.shape[2], g, w,
                int(wrap_len), torch.cuda.current_stream(out.device)
                .cuda_stream), "grouped_lerp launch")
    return out


def _launch_bank(entry, out, ext, edge, ok, sv, ev, base_i, base_f, rate,
                 gain, frame0, L, gl0, gl1):
    """One launch of the grain-bank C entry point `entry` on checked CUDA
    tensors, writing into `out` (I, C, B); frame0 a 0-d int64 tensor on
    the card."""
    check(entry(ext.data_ptr(), edge.data_ptr(), ok.data_ptr(), sv.data_ptr(),
                ev.data_ptr(), base_i.data_ptr(), base_f.data_ptr(),
                rate.data_ptr(), gain.data_ptr(), out.data_ptr(),
                out.shape[0], int(ext.shape[0] > 1), int(ok.shape[0] > 1),
                int(gain.shape[0] > 1), ext.shape[1], ext.shape[2], L,
                ok.shape[1], ok.shape[2], frame0.data_ptr(),
                float(np.float32(gl0)), float(np.float32(gl1)), EDGE_FRAC,
                torch.cuda.current_stream(out.device).cuda_stream),
          "grain_bank launch")
    return out


def _check_cuda(name, tensors: dict, dtypes: dict):
    """Refuse what the kernel does not take: every tensor on the current
    CUDA device, of its dtype, contiguous."""
    dev = next(iter(tensors.values())).device
    for key, t in tensors.items():
        if t.device.type != "cuda" or t.device != dev:
            raise KernelError(f"{name}: {key} on {t.device}; every input must "
                              "lie on one CUDA device")
        if t.dtype != dtypes[key]:
            raise KernelError(f"{name}: {key} must be {dtypes[key]}, got "
                              f"{t.dtype}")
        if not t.is_contiguous():
            raise KernelError(f"{name}: {key} must be contiguous")
    if dev.index != torch.cuda.current_device():
        raise KernelError(f"{name}: inputs are not on the current device")
    return dev


def grouped_lerp(ext: torch.Tensor, pi: torch.Tensor, fr: torch.Tensor,
                 g: int, w: int, wrap_len: int = 0) -> torch.Tensor:
    """The grouped two-tap lerp (K3/K4/K7's contract; shapes as in
    `grouped_lerp_reference`, pi int32 for the kernel).  CUDA tensors go
    through the hand-written kernel (each launch adds one to
    `grouped_lerp.launches`); CPU tensors take the plain version."""
    if all(t.device.type == "cpu" for t in (ext, pi, fr)):
        return grouped_lerp_reference(ext, pi, fr, g, w, wrap_len)
    dev = _check_cuda("grouped_lerp", {"ext": ext, "pi": pi, "fr": fr},
                      {"ext": torch.float32, "pi": torch.int32,
                       "fr": torch.float32})
    if ext.dim() != 3 or pi.dim() != 3 or fr.shape != pi.shape:
        raise KernelError(f"grouped_lerp: needs ext (I, C, Lx) and pi, fr "
                          f"(I, R, B), got {tuple(ext.shape)}, "
                          f"{tuple(pi.shape)}, {tuple(fr.shape)}")
    n = _lead(ext, pi)
    _, C, Lx = ext.shape
    _, R, B = pi.shape
    if not (1 <= g <= RENDER_QUANTUM_MAX_GROUP and B % g == 0
            and 2 <= w and Lx >= 2 and R <= _MAX_GRID_YZ
            and B < _MAX_INDEX and 0 <= wrap_len < 2**31):
        raise KernelError(f"grouped_lerp: bad geometry g={g}, w={w}, R={R}, "
                          f"B={B}, Lx={Lx}, wrap_len={wrap_len}")
    out = torch.empty((n, C, R, B), dtype=torch.float32, device=dev)
    _launch_lerp(_launchers()["grouped_lerp"], out, ext, pi, fr, g, w,
                 wrap_len)
    grouped_lerp.launches += 1
    return out


def grain_bank(ext, edge, ok, sv, ev, base_i, base_f, rate, gain,
               frame0: torch.Tensor, L: int, gl0: float,
               gl1: float) -> torch.Tensor:
    """The grain bank (K2's contract; arguments as in
    `grain_bank_reference`, with ok, sv, ev and base_i int32 for the
    kernel, at most 2 channels, and frame0 a 0-d int64 tensor that the
    kernel reads on the card).  CUDA tensors go through the hand-written
    kernel (each launch adds one to `grain_bank.launches`); CPU tensors
    take the plain version."""
    args = {"ext": ext, "edge": edge, "ok": ok, "sv": sv, "ev": ev,
            "base_i": base_i, "base_f": base_f, "rate": rate, "gain": gain,
            "frame0": frame0}
    if not isinstance(frame0, torch.Tensor) or frame0.shape != ():
        raise KernelError("grain_bank: frame0 must be a 0-d int64 tensor")
    if all(t.device.type == "cpu" for t in args.values()):
        return grain_bank_reference(ext, edge, ok, sv, ev, base_i, base_f,
                                    rate, gain, frame0, L, gl0, gl1)
    i32, f32 = torch.int32, torch.float32
    dev = _check_cuda("grain_bank", args, {
        "ext": f32, "edge": f32, "ok": i32, "sv": i32, "ev": i32,
        "base_i": i32, "base_f": f32, "rate": f32, "gain": f32,
        "frame0": torch.int64})
    if ext.dim() != 3 or edge.shape != ext.shape[:2] or gain.dim() != 3:
        raise KernelError(f"grain_bank: needs ext (I, C, Lx), edge (I, C), "
                          f"gain (I, K, B), got {tuple(ext.shape)}, "
                          f"{tuple(edge.shape)}, {tuple(gain.shape)}")
    fields = (ok, sv, ev, base_i, base_f, rate)
    if ok.dim() != 3 or any(x.shape != ok.shape for x in fields):
        raise KernelError("grain_bank: the lane fields must share one "
                          "(I, K, nq) shape")
    _, C, Lx = ext.shape
    _, K, nq = ok.shape
    B = nq * RENDER_QUANTUM_SIZE
    if C > 2 or gain.shape[1:] != (K, B) or not 1 <= L < min(Lx, _MAX_INDEX):
        raise KernelError(f"grain_bank: needs C <= 2, gain (I, {K}, {B}) and "
                          f"1 <= L < Lx, L < 2^31, got C={C}, gain "
                          f"{tuple(gain.shape)}, L={L}, Lx={Lx}")
    n = _lead(ext, ok, gain)
    out = torch.empty((n, C, B), dtype=torch.float32, device=dev)
    _launch_bank(_launchers()["grain_bank"], out, ext, edge, ok, sv, ev,
                 base_i, base_f, rate, gain, frame0, L, gl0, gl1)
    grain_bank.launches += 1
    return out


grouped_lerp.launches = 0
grain_bank.launches = 0
