"""BENCHMARK.json against the contract's shape, and every cell resolved to
its files by name."""

import json
import re

import pytest

from wabench.core import bench

B = bench.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in B["workloads"]]


def test_top_level_keys_and_size():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len((bench.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert B["paths"] == ["wabench"]
    assert 1 <= B["run_seconds"] <= 51
    assert len(B["command"]) <= 32


def test_names_units_and_keys():
    names = [c["name"] for c in B["configs"]] + CELLS
    metrics = B["end_to_end"] + B["per_layer"]
    names += [m["name"] for m in metrics]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("wabench/")
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert set(m["workloads"]) <= set(CELLS)
    assert any(m["name"] == "setup_s" for m in B["end_to_end"])


HOOKS = ("inputs", "settings", "prepare", "build", "stage", "reference")


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    c = bench.cell(name)
    assert c.cfg["name"] == c.entry["config"]
    assert (bench.PKG / "drivers" / f"{c.traffic['driver']}.py").exists()
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    assert c.limits and all(v > 0 for v in c.limits.values())
    for m in c.end_to_end + c.per_layer:
        assert callable(bench.metric_reader(m["name"]))
    assert "tiny" in c.cfg and "tiny" in c.traffic
    n = c.traffic["host_threads"]
    assert n is None or (isinstance(n, int) and n >= 1)


@pytest.mark.parametrize("config", [c["name"] for c in B["configs"]])
def test_every_configuration_has_every_hook(config):
    """Any driver runs any configuration: the hooks are the same."""
    mod = bench.make({"name": "x", "config": config,
                      "traffic": B["workloads"][0]["traffic"], "chips": 1},
                     B).config_module
    for hook in HOOKS:
        assert callable(getattr(mod, hook)), hook


def test_config_files_hold_their_sizes():
    for c in B["configs"]:
        cfg = json.loads((bench.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["precision"] == "float32"
