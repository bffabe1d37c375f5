"""The compressor's sequential level detector: the CUDA kernel and its plain
version.

    tau  = x[i] > y[i-1] ? attack_tau : release_tau
    y[i] = tau * y[i-1] + (1 - tau) * x[i]

over (N, B): one recurrence per instance, y[-1] = y0[n].  It replaces the
per-sample `lax.scan` of
`webaudio_tpu/nodes/dynamics_compressor.py::_detector_sequential`, which
had no Pallas kernel on the TPU.  On the card it is the compressor's
default detector (nodes/dynamics_compressor.py::detector_mode), and on
every device the exact fallback for the instances whose fixed-point branch
pattern did not settle.  `csrc/detector.cu` runs one chain thread an
instance, up to 32 instances a CTA, with tiles of x staged through shared
memory by TMA bulk copies (`launch_plan` says how the card's launch is cut).

`detector_scan` launches the kernel for CUDA tensors and raises
`KernelError` for anything it cannot take; it runs `detector_reference`
only for tensors on the CPU.  The two agree bit for bit: each product and
the sum are rounded apart in both.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .cuda_lib import KernelError, check, load_library

_SOURCE = "detector.cu"


def _taus(x, at, rt):
    """at, rt as (N, B) (one tau a sample) or (N, 1) (one an instance)."""
    N, B = x.shape
    at, rt = (t if isinstance(t, torch.Tensor)
              else torch.as_tensor(t, device=x.device) for t in (at, rt))
    at, rt = (t.reshape(-1, 1) if t.dim() < 2 else t for t in (at, rt))
    if at.shape[1] == 1 and rt.shape[1] == 1:
        return at.expand(N, 1), rt.expand(N, 1)
    return at.expand(N, B), rt.expand(N, B)


def detector_reference(y0: torch.Tensor, x: torch.Tensor, at, rt) -> torch.Tensor:
    """Plain version: a loop over the B samples, all instances at once.
    y0 (N,), x (N, B) f32 CPU tensors; at, rt broadcastable to (N, B) (a
    scalar, (N,), (N, 1) or (N, B)).  Returns y (N, B) f32.  Each step runs
    on numpy views of the tensors, in f32: a step of torch calls would
    cost ~30 us of dispatch a sample, numpy's ~5."""
    at, rt = _taus(x, at, rt)
    xt = np.ascontiguousarray(x.numpy().T, np.float32)         # (B, N)
    att = np.ascontiguousarray(at.numpy().T, np.float32)
    rtt = np.ascontiguousarray(rt.numpy().T, np.float32)
    per_sample = att.shape[0] > 1
    one = np.float32(1.0)
    y = np.empty_like(xt)
    prev = y0.numpy().astype(np.float32)
    for i in range(xt.shape[0]):
        xi = xt[i]
        a = att[i] if per_sample else att[0]
        r = rtt[i] if per_sample else rtt[0]
        tau = np.where(xi > prev, a, r)
        prev = tau * prev + (one - tau) * xi
        y[i] = prev
    return torch.from_numpy(np.ascontiguousarray(y.T))


@functools.cache
def _launcher():
    lib = load_library(_SOURCE)
    fn = lib.detector_seq_launch
    p = ctypes.c_void_p
    fn.argtypes = [p, p, p, p, p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _planner():
    fn = load_library(_SOURCE).detector_seq_plan
    fn.argtypes = [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return fn


def launch_plan(n: int, b: int, per_sample: bool) -> dict:
    """The kernel's launch on the current CUDA device for (n, b): `rows`
    instances a CTA (one chain thread each), `tile` samples a staged tile,
    `ctas` and `smem` bytes of shared memory a CTA.  Needs the card."""
    out = (ctypes.c_int * 4)()
    check(_planner()(n, b, int(per_sample), out), "detector_scan plan")
    return dict(zip(("rows", "tile", "ctas", "smem"), out))


def _launch(y0, x, at, rt, out):
    """One launch on checked CUDA tensors, writing into `out` (x's shape),
    uncounted.  at, rt: (N, B) or (N, 1), contiguous."""
    N, B = x.shape
    rc = _launcher()(y0.data_ptr(), x.data_ptr(), at.data_ptr(),
                     rt.data_ptr(), out.data_ptr(), N, B,
                     int(at.shape[1] != 1),
                     torch.cuda.current_stream(x.device).cuda_stream)
    check(rc, "detector_scan launch")
    return out


def detector_scan(y0: torch.Tensor, x: torch.Tensor, at, rt) -> torch.Tensor:
    """The detector over (N, B): y0 (N,), x (N, B) f32; at, rt a scalar,
    (N,), (N, 1) or (N, B).  CUDA tensors go through the hand-written
    kernel (each launch adds one to `detector_scan.launches`; an empty x
    launches nothing); CPU tensors take `detector_reference`."""
    if x.device.type == "cpu" and y0.device.type == "cpu":
        return detector_reference(y0, x, at, rt)
    name = "detector_scan"
    if x.device.type != "cuda" or y0.device != x.device:
        raise KernelError(f"{name}: x on {x.device}, y0 on {y0.device}; both "
                          "must lie on the same CUDA device")
    if x.device.index != torch.cuda.current_device():
        raise KernelError(f"{name}: x is not on the current device")
    if x.dim() != 2 or y0.shape != x.shape[:1]:
        raise KernelError(f"{name}: needs x (N, B) and y0 (N,), got "
                          f"{tuple(x.shape)} and {tuple(y0.shape)}")
    at, rt = _taus(x, at, rt)
    tensors = (y0, x, at, rt)
    if any(t.dtype != torch.float32 for t in tensors):
        raise KernelError(f"{name}: needs f32, got "
                          f"{[str(t.dtype) for t in tensors]}")
    if not (x.is_contiguous() and y0.is_contiguous()):
        raise KernelError(f"{name}: x and y0 must be contiguous")
    at, rt = at.contiguous(), rt.contiguous()
    y = torch.empty_like(x)
    if y.numel():
        _launch(y0, x, at, rt, y)
        detector_scan.launches += 1
    return y


detector_scan.launches = 0
