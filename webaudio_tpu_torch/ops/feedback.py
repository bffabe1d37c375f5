"""The constant feedback-delay loop: the CUDA kernel and its plain version.

A DelayNode with a constant delay (`nodes/delay.py::_DelayKernel.const_read`:
it reads `shift` frames back with lerp weights wa, wb) whose output runs
through k GainNodes of constant gain g1..gk back into the delay, with at
most one signal x from outside the loop added at the delay's input.  Over
a block of B frames from frame0, for frame n, t = frame0 + n,
p = t - shift, in the stepped walk's f32 order
(`graph/compiler.py::run_step`, `_DelayKernel.process_reader`,
`_GainKernel`, `sum_inputs`, `process_writer`):

    r = ring[p mod R] * wa + ring[(p + 1) mod R] * wb
        (b * wb where p == -1, 0 where p < -1: nothing written there yet)
    y = ((r * g1) * g2) ... * gk
    ring[t mod R] = x + y        (y where the loop has no x)

A frame reads frames at least shift - 1 before it, so the frames of a run
of consecutive frames that short read only earlier runs: both versions
walk the block run by run, all frames of a run at once, reading the taps
back from the ring in runs of min(shift - 1, R - shift) (so a run writes
no slot it still reads).  Each product and sum is rounded apart in both,
so the two agree bit for bit, and with the stepped walk at any inner block
the plan may pick.

`feedback_delay` launches `csrc/feedback_delay.cu` for CUDA tensors (each
launch adds one to `feedback_delay.launches`) and raises `KernelError` for
anything it cannot take; it runs `feedback_delay_reference` only for
tensors on the CPU.  Neither writes the ring it is given: the new ring is
another tensor.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .cuda_lib import KernelError, check, load_library

_SOURCE = "feedback_delay.cu"
MAX_GAINS = 16          # csrc/feedback_delay.cu's kMaxGains


def feedback_delay_reference(ring: torch.Tensor, x, frames: int, shift: int,
                             wa: float, wb: float, gains, frame0):
    """Plain version: ring (N, C, R) f32, x (N or 1, C, frames) f32 or
    None, frame0 an int (or a 0-d tensor).  -> (r, y, ring'), r and y
    (N, C, frames) (y is r when there are no gains)."""
    N, C, R = ring.shape
    f0 = int(frame0)
    run = min(shift - 1, R - shift)   # R - shift: writes no slot it reads
    out = ring.clone(memory_format=torch.contiguous_format)
    rs, ys = [], []
    for n0 in range(0, frames, run):
        m = min(run, frames - n0)
        t = torch.arange(f0 + n0, f0 + n0 + m, dtype=torch.int64,
                         device=ring.device)
        p = t - shift
        a = out.index_select(-1, torch.remainder(p, R))
        bw = out.index_select(-1, torch.remainder(p + 1, R)) * wb
        r = torch.where(p >= 0, a * wa + bw, bw.masked_fill(p < -1, 0.0))
        y = r
        for g in gains:
            y = y * g
        w = y if x is None else x[..., n0:n0 + m] + y
        out.index_copy_(-1, torch.remainder(t, R), w.expand(N, C, m))
        rs.append(r)
        ys.append(y)
    r = torch.cat(rs, dim=-1)
    return r, (torch.cat(ys, dim=-1) if len(gains) else r), out


@functools.cache
def _lib():
    lib = load_library(_SOURCE)
    p, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float)
    launch = lib.feedback_delay_launch
    # ring_in, ring_out, x, r, y, rows, channels, x_shared, R, B, shift,
    # wa, wb, gains, k, frame0, frame0_dev, stream
    launch.argtypes = [p, p, p, p, p, ll, i, i, ll, ll, ll, f, f, p, i, ll,
                       p, p]
    launch.restype = ctypes.c_int
    return launch


def _check(ring, x, frames, shift, gains, frame0):
    """Refuse what neither version takes; on a card, also what the kernel
    does not take (device, dtype, contiguity, frame0's form)."""
    name = "feedback_delay"
    if ring.dim() != 3:
        raise KernelError(f"{name}: needs ring (N, C, R), got "
                          f"{tuple(ring.shape)}")
    N, C, R = ring.shape
    if x is not None and (x.dim() != 3 or x.shape[0] not in (1, N)
                          or tuple(x.shape[1:]) != (C, frames)):
        raise KernelError(f"{name}: needs x (N or 1, {C}, {frames}), got "
                          f"{tuple(x.shape)}")
    if not 2 <= shift < R or len(gains) > MAX_GAINS:
        raise KernelError(f"{name}: needs 2 <= shift < R and at most "
                          f"{MAX_GAINS} gains, got shift {shift}, R {R}, "
                          f"{len(gains)} gains")
    if ring.device.type == "cpu":
        return
    tensors = {"ring": ring} if x is None else {"ring": ring, "x": x}
    for key, t in tensors.items():
        if t.device != ring.device or t.device.type != "cuda":
            raise KernelError(f"{name}: {key} on {t.device}; every input "
                              "must lie on one CUDA device")
        if t.dtype != torch.float32:
            raise KernelError(f"{name}: {key} is {t.dtype}, needs float32")
        if not t.is_contiguous():
            raise KernelError(f"{name}: {key} must be contiguous")
    if ring.device.index != torch.cuda.current_device():
        raise KernelError(f"{name}: ring is not on the current device")
    if isinstance(frame0, torch.Tensor) and (
            frame0.shape != () or frame0.dtype != torch.int64
            or frame0.device != ring.device):
        raise KernelError(f"{name}: frame0 must be a host int or a 0-d "
                          "int64 tensor on the ring's device")


def feedback_delay(ring: torch.Tensor, x, frames: int, shift: int,
                   wa: float, wb: float, gains, frame0):
    """One block of the loop: ring (N, C, R) f32, the delay's carried
    state; x (N, C, frames), or (1, C, frames) when every instance shares
    it, f32, or None; gains g1..gk as f32-exact floats; frame0 the block's
    first frame, a host int or (on the card) a 0-d int64 tensor on the
    ring's device that the kernel reads when it runs (a captured walk's).
    -> (r, y, ring'): the delay's output, the last gain's (r itself with
    no gains), the new ring."""
    gains = tuple(gains)
    _check(ring, x, frames, shift, gains, frame0)
    if ring.device.type == "cpu":
        return feedback_delay_reference(ring, x, frames, shift, wa, wb,
                                        gains, frame0)
    N, C, R = ring.shape
    out = torch.empty_like(ring)
    r = torch.empty((N, C, frames), dtype=torch.float32, device=ring.device)
    y = torch.empty_like(r) if gains else None
    g = (ctypes.c_float * max(len(gains), 1))(*gains)
    on_card = isinstance(frame0, torch.Tensor)
    check(_lib()(ring.data_ptr(), out.data_ptr(),
                 0 if x is None else x.data_ptr(), r.data_ptr(),
                 0 if y is None else y.data_ptr(), N * C, C,
                 int(x is not None and x.shape[0] == 1 and N > 1), R,
                 frames, shift, wa, wb, g, len(gains),
                 0 if on_card else int(frame0),
                 frame0.data_ptr() if on_card else 0,
                 torch.cuda.current_stream(ring.device).cuda_stream),
          "feedback_delay launch")
    feedback_delay.launches += 1
    return r, (r if y is None else y), out


feedback_delay.launches = 0
