"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module name, and the reference loads nothing of the port.
Each check runs in a fresh interpreter."""

import json
import subprocess
import sys

from wabench.core import bench

PROBE = r"""
import importlib, json, sys
from pathlib import Path
pkg = Path("wabench")
import wabench.run, wabench.control
from wabench.core import bench
for sub in ("configs", "drivers"):
    for p in sorted((pkg / sub).glob("*.py")):
        importlib.import_module(f"wabench.{sub}." + p.stem)
for p in sorted((pkg / "metrics").glob("*.py")):
    if p.stem != "__init__":
        bench.metric_reader(p.stem)
if {run_cell}:
    from wabench.tests import tiny
    tiny.run("reverb.bounce", seconds=0.2)
print(json.dumps(sorted(sys.modules)))
"""

REFERENCE = r"""
import importlib, json, sys
from pathlib import Path
for p in sorted(Path("wabench/reference").glob("*.py")):
    importlib.import_module("wabench.reference." + p.stem)
print(json.dumps(sorted(sys.modules)))
"""


def _modules(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=bench.ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _top(mods):
    return {m.split(".")[0] for m in mods}


def test_the_harness_and_a_run_load_no_jax():
    from wabench.core.guard import FORBIDDEN, forbidden_loaded

    mods = _modules(PROBE.replace("{run_cell}", "True"))
    assert not _top(mods) & FORBIDDEN
    assert forbidden_loaded(mods) == []
    assert "webaudio_tpu_torch" in _top(mods)
    assert forbidden_loaded(["webaudio_tpu.ops", "jax"]) == \
        ["jax", "webaudio_tpu"]


def test_the_reference_loads_nothing_of_the_port():
    mods = _top(_modules(REFERENCE))
    assert not mods & {"webaudio_tpu_torch", "webaudio_tpu", "jax",
                       "jaxlib", "torch"}
