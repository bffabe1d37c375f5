"""The buffer source's automated-rate playhead: the CUDA kernel's wrapper.

An AudioBufferSourceNode whose compound rate playback_rate *
2^(detune / 1200) is a dense row computes its playhead as an exclusive
masked cumsum of the per-frame increments, carried across blocks in
(buffer_time, elapsed, entered), and reads the buffer's pair rows there
(`nodes/buffer_source.py::_BufferSourceKernel._process_cumsum`, the plain
version and the contract: the CPU path).  On the card `buffer_playhead`
computes the same block in one launch of `csrc/buffer_playhead.cu`, in
place of that tensor code's ~155 device operations; each launch adds one
to `buffer_playhead.launches`.  The two agree but for each quantum's f64
sum, which torch reduces in an order of its own (~1e-16 relative); two
launches on the same input agree bit for bit.

The wrapper refuses, on any device, the shapes, dtypes and strides the
kernel does not take, and CPU tensors: the node takes the plain version
there.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..constants import RENDER_QUANTUM_SIZE
from .cuda_lib import KernelError, check, load_library

_SOURCE = "buffer_playhead.cu"


class Constants(ctypes.Structure):
    """A source's host constants, csrc/buffer_playhead.cu's
    PlayheadConstants field for field (the node's `consts`)."""
    _fields_ = [(name, ctypes.c_double) for name in (
        "ratio", "fs", "buf_rate", "buf_duration", "offset", "delta",
        "dur_fs", "loop_start", "loop_end", "ls", "le", "loop_len", "tol")] + \
        [(name, ctypes.c_longlong) for name in (
            "start_frame", "start_i", "stop_i", "length")] + \
        [("loop", ctypes.c_int), ("cond_ge", ctypes.c_int)]


@functools.cache
def _lib():
    lib = load_library(_SOURCE)
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    launch = lib.buffer_playhead_launch
    # pr, pr_rs, pr_cs, dt, dt_rs, dt_cs, bt_in, el_in, en_in, rows,
    # rows_rs, edge, edge_rs, channels, B, n, consts, frame0, frame0_dev,
    # out, bt_out, el_out, en_out, stream
    launch.argtypes = [p, ll, i, p, ll, i, p, p, p, p, ll, p, ll, i, ll, ll,
                       ctypes.POINTER(Constants), ll, p, p, p, p, p, p]
    launch.restype = ctypes.c_int
    return launch


def _rate_strides(name, t, n, frames):
    """(row stride, frame stride) of a rate: a 0-d value for the block, or
    (1 or n, 1, frames) rows whose frames lie side by side."""
    if t.dim() == 0:
        return 0, 0
    if t.dim() != 3 or t.shape[0] not in (1, n) or t.shape[1] != 1 \
            or t.shape[2] != frames:
        raise KernelError(f"buffer_playhead: needs {name} 0-d or (1 or {n}, "
                          f"1, {frames}), got {tuple(t.shape)}")
    if t.stride(2) != 1:
        raise KernelError(f"buffer_playhead: {name}'s frames must be "
                          "contiguous")
    return (t.stride(0) if t.shape[0] > 1 else 0), 1


def _check(playback_rate, detune, state, rows, edge, frames, frame0):
    """Refuse what the kernel does not take; return the strides."""
    name = "buffer_playhead"
    bt, el, en = state["buffer_time"], state["elapsed"], state["entered"]
    if bt.dim() != 1 or el.shape != bt.shape or en.shape != bt.shape:
        raise KernelError(f"{name}: needs the state's three leaves (n,), got "
                          f"{tuple(bt.shape)}, {tuple(el.shape)}, "
                          f"{tuple(en.shape)}")
    n = bt.shape[0]
    if frames < 1 or frames % RENDER_QUANTUM_SIZE:
        raise KernelError(f"{name}: needs a block of whole quanta, got "
                          f"{frames} frames")
    strides = [_rate_strides("playback_rate", playback_rate, n, frames),
               _rate_strides("detune", detune, n, frames)]
    if rows.dim() != 3 or rows.shape[0] not in (1, n) or \
            not 1 <= rows.shape[1] < 2**31 or rows.shape[2] < 2 or \
            rows.shape[2] % 2:
        raise KernelError(f"{name}: needs pair rows (1 or {n}, L, 2C), got "
                          f"{tuple(rows.shape)}")
    C = rows.shape[2] // 2
    if edge.shape != (rows.shape[0], C):
        raise KernelError(f"{name}: needs edge values ({rows.shape[0]}, {C}),"
                          f" got {tuple(edge.shape)}")
    dtypes = {"playback_rate": (playback_rate, torch.float32),
              "detune": (detune, torch.float32), "rows": (rows, torch.float32),
              "edge": (edge, torch.float32),
              "buffer_time": (bt, torch.float64),
              "elapsed": (el, torch.float64), "entered": (en, torch.bool)}
    for key, (t, dtype) in dtypes.items():
        if t.dtype != dtype:
            raise KernelError(f"{name}: {key} is {t.dtype}, needs {dtype}")
        if key not in ("playback_rate", "detune") and not t.is_contiguous():
            raise KernelError(f"{name}: {key} must be contiguous")
    for key, (t, _) in dtypes.items():
        if t.device != bt.device or t.device.type != "cuda":
            raise KernelError(f"{name}: {key} on {t.device}; every input "
                              "must lie on one CUDA device (the plain "
                              "version runs on the CPU)")
    if bt.device.index != torch.cuda.current_device():
        raise KernelError(f"{name}: the state is not on the current device")
    if isinstance(frame0, torch.Tensor) and (
            frame0.shape != () or frame0.dtype != torch.int64
            or frame0.device != bt.device):
        raise KernelError(f"{name}: frame0 must be a host int or a 0-d "
                          "int64 tensor on the state's device")
    return strides


def buffer_playhead(playback_rate, detune, state, rows, edge, frames: int,
                    frame0, consts: Constants):
    """One block of n instances' automated-rate playback.  playback_rate,
    detune: f32, 0-d or (1 or n, 1, frames) with contiguous frames; state:
    {"buffer_time", "elapsed": (n,) f64, "entered": (n,) bool}; rows
    (1 or n, L, 2C), edge (1 or n, C) f32: the staged pair rows and
    end-of-buffer values (ops/bufread.py); frame0 the block's first frame,
    a host int or a 0-d int64 tensor on the card read when the kernel runs
    (a captured walk's); consts the node's `consts`.
    -> ((n, C, frames) f32 output, the new state)."""
    (pr_rs, pr_cs), (dt_rs, dt_cs) = _check(playback_rate, detune, state,
                                            rows, edge, frames, frame0)
    bt, el, en = state["buffer_time"], state["elapsed"], state["entered"]
    n, C = bt.shape[0], rows.shape[2] // 2
    dev = bt.device
    out = torch.empty((n, C, frames), dtype=torch.float32, device=dev)
    new = {"buffer_time": torch.empty_like(bt),
           "elapsed": torch.empty_like(el), "entered": torch.empty_like(en)}
    on_card = isinstance(frame0, torch.Tensor)
    check(_lib()(playback_rate.data_ptr(), pr_rs, pr_cs, detune.data_ptr(),
                 dt_rs, dt_cs, bt.data_ptr(), el.data_ptr(), en.data_ptr(),
                 rows.data_ptr(),
                 rows.stride(0) if rows.shape[0] > 1 else 0,
                 edge.data_ptr(), edge.stride(0) if edge.shape[0] > 1 else 0,
                 C, frames, n, ctypes.byref(consts),
                 0 if on_card else int(frame0),
                 frame0.data_ptr() if on_card else 0, out.data_ptr(),
                 new["buffer_time"].data_ptr(), new["elapsed"].data_ptr(),
                 new["entered"].data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream),
          "buffer_playhead launch")
    buffer_playhead.launches += 1
    return out, new


buffer_playhead.launches = 0
