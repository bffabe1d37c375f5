"""Run a JAX-package test file on the port (webaudio_tpu_torch), on the CPU.

`load_on_port(path)` reads a test file as text, rewrites `webaudio_tpu`
to `webaudio_tpu_torch`, and runs the result as a module of its own.  The
file is read, never edited.  The switch changes only what the port's API
asks for:

- contexts default to `device="cpu"` (the port's default is the card);
- `render_time_sharded` defaults to 8 CPU devices (the JAX package's
  tests run on 8 virtual CPU devices);
- `ops.mixing.mix` takes tensors on the port: numpy inputs are converted
  on the way in;
- `jax.numpy` processors get a torch twin of the two names the suites use
  (`zeros`, `float32`);
- `from test_x import ...` of another such file imports that file loaded
  on the port.

`collect(paths, left_out)` gathers every test the files define as
`test_<suite>__<name>`, apart from the cases in `left_out`.
"""

import functools
import re
import sys
import types
from pathlib import Path

import numpy as np
import torch

import webaudio_tpu_torch as wt
from webaudio_tpu_torch.ops import mixing as _mixing
from webaudio_tpu_torch.parallel import segments as _segments

HERE = Path(__file__).resolve().parent
_ON_CPU = "webaudio_tpu_torch_on_cpu"


class OfflineAudioContext(wt.OfflineAudioContext):
    def __init__(self, *args, device="cpu", **kw):
        super().__init__(*args, device=device, **kw)


class AudioContext(wt.AudioContext):
    def __init__(self, *args, device="cpu", **kw):
        super().__init__(*args, device=device, **kw)


_CPU_DEFAULTS = {"OfflineAudioContext": OfflineAudioContext,
                 "AudioContext": AudioContext}


def _package():
    """`webaudio_tpu_torch` as the switched files see it: contexts default
    to the CPU, every other name is the port's."""
    mod = types.ModuleType(_ON_CPU)
    mod.__getattr__ = lambda name: _CPU_DEFAULTS.get(name) or getattr(wt, name)
    return mod


sys.modules.setdefault(_ON_CPU, _package())


def _mix(signal, c_out, interpretation):
    if isinstance(signal, np.ndarray):
        signal = torch.from_numpy(signal)
    return _mixing.mix(signal, c_out, interpretation)


_PATCHES = (
    (_mixing.mix, _mix),
    (_segments.render_time_sharded, functools.partial(
        _segments.render_time_sharded, devices=["cpu"] * 8)),
)

_JNP_TWIN = types.SimpleNamespace(
    zeros=lambda shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype),
    float32=torch.float32)


def load_on_port(path: Path) -> types.ModuleType:
    """The test file at `path` run on the port, as module torch_<stem>."""
    name = f"torch_{path.stem}"
    if name in sys.modules:
        return sys.modules[name]
    src = path.read_text()
    src = re.sub(r"\b(from|import) webaudio_tpu\b(?!\.)", rf"\1 {_ON_CPU}",
                 src)
    src = re.sub(r"\bwebaudio_tpu\b", "webaudio_tpu_torch", src)
    src = src.replace("import jax.numpy as jnp\n", "")
    for other in set(re.findall(r"^from (test_\w+) import", src, re.M)):
        load_on_port(path.parent / f"{other}.py")
        src = re.sub(rf"^from {other} import", f"from torch_{other} import",
                     src, flags=re.M)
    mod = types.ModuleType(name)
    mod.__file__ = str(path)
    mod.jnp = _JNP_TWIN
    sys.modules[name] = mod
    exec(compile(src, str(path), "exec"), mod.__dict__)
    for key, value in list(mod.__dict__.items()):
        for port, switched in _PATCHES:
            if value is port:
                mod.__dict__[key] = switched
    return mod


def collect(paths, left_out, prefix) -> dict:
    """{test_<suite>__<name>: test} over the files, `prefix` cut from each
    file's stem to name its suite; `left_out` holds (file name, test
    name) pairs."""
    tests = {}
    for path in paths:
        suite = path.stem[len(prefix):].lstrip("_") or "main"
        for key, value in vars(load_on_port(path)).items():
            if not key.startswith("test_") or not callable(value) or \
                    (path.name, key) in left_out:
                continue
            tests[f"test_{suite}__{key[len('test_'):]}"] = value
    return tests
