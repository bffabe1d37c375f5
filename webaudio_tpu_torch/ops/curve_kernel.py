"""WaveShaper curve lookup: the CUDA kernel and its plain version.

Ports the TPU kernel K1 (`webaudio_tpu/ops/curve_kernel.py::
curve_lookup_tpu_v3`) and its study-mode siblings (`curve_lookup_tpu`,
`curve_lookup_tpu_v2`), which all compute the contract
`webaudio_tpu/nodes/waveshaper.py::_apply_curve_gather`.  The TPU
versions' segment table and two-hot contraction existed because gathers
were slow there; the Hopper kernels (`csrc/curve_lookup.cu`) gather the
two curve taps directly: one curve through the read-only cache, a table of
per-instance curves from each block's copy of its row's curve in shared
memory.

`curve_lookup` launches the kernel for CUDA tensors and raises
`KernelError` for anything it cannot take; it runs the plain version only
for tensors on the CPU.  The two versions agree bit for bit, NaN samples
included (a NaN sample reads index 0 and yields NaN).  `launch_plan`
decides how a launch runs (which kernel, the grid, the block, the shared
memory) from the shapes and the card's limits alone.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from .cuda_lib import KernelError, check, load_library

_SOURCE = "curve_lookup.cu"

_BAR_BYTES = 16          # the block's mbarrier, ahead of the curve
_MAX_GRID_Y = 65535
# the kernels (csrc/curve_lookup.cu), and the threads a block and a SM each
# runs in one wave: "global" 8 blocks of 256 a SM, "shared" 2 of 512,
# "cached" 1 of 1024
KERNELS = {"global": 0, "shared": 1, "cached": 2}
_THREADS = {"global": 256, "shared": 512, "cached": 1024}
_SM_THREADS = {"global": 2048, "shared": 1024, "cached": 1024}
# the longest curve a table block stages in shared memory (32 KB, inside
# the 48 KB a block has without opting in to more): up to it, staging beat
# the read-only cache at every table shape measured (PERF.md)
_STAGE_MAX_POINTS = 8192


@functools.cache
def _half_nm1(n: int) -> float:
    """(n-1)/2 rounded to f32 on the host, as JAX's weak-typed Python
    float enters the f32 product."""
    return float(np.float32((n - 1) / 2.0))


def curve_lookup_reference(curve: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain gather + lerp (`_apply_curve_gather` in torch): curve (n,) f32,
    x any shape f32 -> the shaped x.  An (R, n) curve table shapes x[r]
    through row r (x has R rows on its leading axis)."""
    n = curve.shape[-1]
    v = (x + 1.0) * _half_nm1(n)
    v = torch.clamp(v, 0.0, float(n - 1))                    # keeps NaN
    k = torch.nan_to_num(torch.floor(v), nan=0.0).to(torch.int64)
    k = torch.clamp(k, max=n - 2)
    f = v - k.to(torch.float32)
    if curve.dim() == 2:
        rows = torch.arange(curve.shape[0], device=curve.device)
        k = k + (rows * n).reshape(-1, *(1,) * (x.dim() - 1))
        curve = curve.reshape(-1)
    return (1.0 - f) * curve[k] + f * curve[k + 1]


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one launch runs.  mode: the kernel ("global": one curve, taps
    through the read-only cache, one sample a thread step; "shared": a
    table's rows, each block's copy of its row's curve in shared memory,
    filled by one bulk copy, x and y in 16-byte steps; "cached": the same
    rows, taps through the read-only cache); grid (x, y), y over the table
    rows; threads a block; smem_bytes a block's dynamic shared memory."""
    mode: str
    grid: tuple
    threads: int
    smem_bytes: int


def staged_bytes(points: int) -> int:
    """A block's shared memory for `points` curve points: the barrier and
    the 16-byte units a bulk copy of them spans, wherever they start."""
    return _BAR_BYTES + 16 * -(-(points + 6) // 4)


def _grid(mode, n, row_len, rows, sms, resident):
    """The one-wave plan of kernel `mode` (a key of KERNELS)."""
    smem = staged_bytes(n) if mode == "shared" else 0
    threads = _THREADS[mode]
    total = sms * (_SM_THREADS[mode] // threads)
    if resident is not None:
        total = min(total, resident(mode, threads, smem))
    gy = min(rows, total, _MAX_GRID_Y)
    # a thread's step: 1 sample in "global", 4 in the table kernels
    steps = row_len if mode == "global" else -(-row_len // 4)
    gx = max(1, min(-(-steps // threads), total // gy))
    return LaunchPlan(mode, (gx, gy), threads, smem)


def launch_plan(n: int, m: int, rows: int, sms: int, smem_limit: int,
                resident=None) -> LaunchPlan:
    """The launch of a lookup of m samples through n-point curves: one
    curve (rows = 1) or a table of `rows` curves, each shaping m / rows
    consecutive samples; on a card with `sms` SMs and `smem_limit` bytes
    of shared memory a block.  `resident(mode, threads, smem_bytes)`, where
    given, says how many such blocks the card holds at once (the occupancy
    query); without it the plan assumes the threads and shared memory allow
    it.  The grid is one wave."""
    args = (n, m // rows, rows, sms, resident)
    if rows == 1:
        return _grid("global", *args)
    if n <= _STAGE_MAX_POINTS and staged_bytes(n) <= smem_limit:
        return _grid("shared", *args)
    return _grid("cached", *args)


class _Kernel:
    """A built `curve_lookup.cu`: its launch entry point, the card's limits
    and one plan per shape, cached per device."""

    def __init__(self, lib):
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
            ctypes.c_float
        self._launch = lib.curve_lookup_launch
        # x, curve, y, rows, row_len, n, half_nm1, kernel, grid_x, grid_y,
        # threads, smem_bytes, stream
        self._launch.argtypes = [p, p, p, ll, ll, i, f, i, i, i, i, i, p]
        self._launch.restype = i
        self._resident = lib.curve_lookup_resident
        self._resident.argtypes = [i, i, i, ctypes.POINTER(i)]
        self._resident.restype = i
        self._device = lib.curve_lookup_device
        self._device.argtypes = [ctypes.POINTER(i), ctypes.POINTER(i)]
        self._device.restype = i
        self._limits: dict = {}
        self._plans: dict = {}
        self._occupancy: dict = {}

    def limits(self):
        """(SM count, shared memory a block) of the current device."""
        dev = torch.cuda.current_device()
        if dev not in self._limits:
            sms, smem = ctypes.c_int(), ctypes.c_int()
            check(self._device(ctypes.byref(sms), ctypes.byref(smem)),
                  "curve_lookup device query")
            self._limits[dev] = (sms.value, smem.value)
        return self._limits[dev]

    def resident(self, mode, threads, smem_bytes):
        key = (torch.cuda.current_device(), mode, threads, smem_bytes)
        if key not in self._occupancy:
            blocks = ctypes.c_int()
            check(self._resident(KERNELS[mode], threads, smem_bytes,
                                 ctypes.byref(blocks)),
                  "curve_lookup occupancy query")
            if blocks.value < 1:
                raise KernelError(f"curve_lookup: no {mode} block of {threads} "
                                  f"threads and {smem_bytes} B fits the card")
            self._occupancy[key] = blocks.value
        return self._occupancy[key]

    def plan(self, n, m, rows):
        """The launch plan on the current device, made once per shape."""
        key = (torch.cuda.current_device(), n, m, rows)
        if key not in self._plans:
            sms, smem = self.limits()
            self._plans[key] = launch_plan(n, m, rows, sms, smem,
                                           self.resident)
        return self._plans[key]

    def __call__(self, out, curve, x, rows, plan):
        n = curve.shape[-1]
        if plan is None:
            plan = self.plan(n, x.numel(), rows)
        return self._launch(
            x.data_ptr(), curve.data_ptr(), out.data_ptr(), rows,
            x.numel() // rows, n, _half_nm1(n), KERNELS[plan.mode],
            plan.grid[0], plan.grid[1], plan.threads, plan.smem_bytes,
            torch.cuda.current_stream(x.device).cuda_stream)


@functools.cache
def _kernel():
    return _Kernel(load_library(_SOURCE))


def _launch(entry, out, curve, x, plan=None):
    """One launch of `entry` (a `_Kernel`) on checked CUDA tensors,
    writing the shaped x into `out` (x's shape, f32, contiguous, on x's
    device); curve (n,) or an (R, n) table.  `plan` forces a launch plan;
    by default the entry plans for the card."""
    if (out.shape != x.shape or out.dtype != torch.float32
            or out.device != x.device or not out.is_contiguous()):
        raise KernelError("curve_lookup: out must be a contiguous f32 tensor "
                          "of x's shape on x's device")
    if x.numel():
        rows = curve.shape[0] if curve.dim() == 2 else 1
        check(entry(out, curve, x, rows, plan), "curve_lookup launch")
    return out


def curve_lookup(curve: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Shape x through curve: (n,), or an (R, n) table whose row r shapes
    x[r] (x has R rows on its leading axis; a (1, n) table is one curve).
    CUDA tensors go through the hand-written kernel (each launch adds one
    to `curve_lookup.launches`; an empty x launches nothing); CPU tensors
    take `curve_lookup_reference`."""
    if curve.dim() == 2 and curve.shape[0] == 1:
        curve = curve[0]
    if x.device.type == "cpu" and curve.device.type == "cpu":
        return curve_lookup_reference(curve, x)
    if x.device.type != "cuda" or curve.device != x.device:
        raise KernelError(
            f"curve_lookup: x on {x.device}, curve on {curve.device}; both "
            "must lie on the same CUDA device")
    if x.device.index != torch.cuda.current_device():
        raise KernelError("curve_lookup: x is not on the current device")
    if x.dtype != torch.float32 or curve.dtype != torch.float32:
        raise KernelError(f"curve_lookup: needs f32, got x {x.dtype}, "
                          f"curve {curve.dtype}")
    if curve.dim() not in (1, 2) or not 2 <= curve.shape[-1] < 2**31:
        raise KernelError(f"curve_lookup: curve must be (n,) or (R, n) with "
                          f"2 <= n < 2**31, got shape {tuple(curve.shape)}")
    if curve.dim() == 2 and (x.dim() == 0 or x.shape[0] != curve.shape[0]):
        raise KernelError(f"curve_lookup: a {tuple(curve.shape)} curve "
                          f"table needs x with {curve.shape[0]} rows, got "
                          f"{tuple(x.shape)}")
    if not (x.is_contiguous() and curve.is_contiguous()):
        raise KernelError("curve_lookup: x and curve must be contiguous")
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if y.numel():
        check(_kernel()(y, curve, x, curve.shape[0] if curve.dim() == 2 else 1,
                        None), "curve_lookup launch")
        curve_lookup.launches += 1
    return y


curve_lookup.launches = 0
