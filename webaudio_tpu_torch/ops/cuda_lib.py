"""Build and load the port's hand-written CUDA kernels.

Each kernel source under `webaudio_tpu_torch/csrc/` has a plain C entry
point.  At first use it is compiled with `nvcc` for Hopper (`sm_90a`) into
a shared library under `webaudio_tpu_torch/build/` and loaded with
`ctypes`; the library's name carries a hash of the source and the flags,
so an edited source is rebuilt.  Nothing here runs at import time: the
CPU tests import every module of the port on machines without `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from ..diagnostics import span

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()                       # guards _source_locks
_source_locks: dict[str, threading.Lock] = {}
_libs: dict[str, ctypes.CDLL] = {}


class KernelError(RuntimeError):
    """A hand-written kernel failed to build, was handed a tensor it does
    not take, or reported a launch error.  The render's per-node failure
    isolation re-raises it: a kernel fault is an environment or engine
    error, never a reason to mute the node."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise KernelError("nvcc not found: the CUDA kernels build on a machine "
                      "with the CUDA toolkit")


def load_library(source: str) -> ctypes.CDLL:
    """Compile `csrc/<source>` (once per process and source hash) and
    return the loaded library.  Threads loading different sources run
    their `nvcc`s at the same time."""
    with _lock:
        lock = _source_locks.setdefault(source, threading.Lock())
    with lock:
        lib = _libs.get(source)
        if lib is not None:
            return lib
        src = CSRC_DIR / source
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        out = BUILD_DIR / f"{src.stem}-{digest}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            with span("build"):
                proc = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                    capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise KernelError(
                    f"nvcc failed on {source}:\n{proc.stderr[-4000:]}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        _libs[source] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise KernelError for a nonzero cudaError_t returned by a launch."""
    if rc != 0:
        raise KernelError(f"{what}: CUDA error {rc}")


def launch_counters() -> tuple:
    """The wrappers of the port's hand-written kernels.  Each carries a
    plain integer `launches` that it raises by one where it launches its
    kernel; a captured block walk adds its graph's launches on every
    replay (graph/compiler.py)."""
    from . import curve_kernel, detector, dither, feedback, grain_read, \
        playhead

    return (curve_kernel.curve_lookup, detector.detector_scan,
            dither.dither_i16, dither.ulaw_u8, feedback.feedback_delay,
            grain_read.grain_bank, grain_read.grouped_lerp,
            playhead.buffer_playhead)
