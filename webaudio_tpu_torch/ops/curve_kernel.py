"""WaveShaper curve lookup: the CUDA kernel and its plain version.

Ports the TPU kernel K1 (`webaudio_tpu/ops/curve_kernel.py::
curve_lookup_tpu_v3`) and its study-mode siblings (`curve_lookup_tpu`,
`curve_lookup_tpu_v2`), which all compute the contract
`webaudio_tpu/nodes/waveshaper.py::_apply_curve_gather`.  The TPU
versions' segment table and two-hot contraction existed because gathers
were slow there; the Hopper kernel (`csrc/curve_lookup.cu`) gathers the
two curve taps directly, one thread per sample.

`curve_lookup` launches the kernel for CUDA tensors and raises
`KernelError` for anything it cannot take; it runs the plain version only
for tensors on the CPU.  The two versions agree bit for bit, NaN samples
included (a NaN sample reads index 0 and yields NaN).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .cuda_lib import KernelError, check, load_library

_SOURCE = "curve_lookup.cu"


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


@functools.cache
def _launcher():
    lib = load_library(_SOURCE)
    fn = lib.curve_lookup_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def curve_lookup(curve: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Shape x through curve: (n,), or an (R, n) table whose row r shapes
    x[r] (x has R rows on its leading axis; a (1, n) table is one curve).
    CUDA tensors go through the hand-written kernel (each launch adds one
    to `curve_lookup.launches`); CPU tensors take `curve_lookup_reference`."""
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
    row_len = 0
    if curve.dim() == 2:
        if x.dim() == 0 or x.shape[0] != curve.shape[0]:
            raise KernelError(f"curve_lookup: a {tuple(curve.shape)} curve "
                              f"table needs x with {curve.shape[0]} rows, got "
                              f"{tuple(x.shape)}")
        row_len = x.numel() // curve.shape[0]
    if not (x.is_contiguous() and curve.is_contiguous()):
        raise KernelError("curve_lookup: x and curve must be contiguous")
    n = curve.shape[-1]
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    rc = _launcher()(x.data_ptr(), curve.data_ptr(), y.data_ptr(),
                     x.numel(), n, _half_nm1(n), row_len,
                     torch.cuda.current_stream(x.device).cuda_stream)
    check(rc, "curve_lookup launch")
    curve_lookup.launches += 1
    return y


curve_lookup.launches = 0
