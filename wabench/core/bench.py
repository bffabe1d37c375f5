"""A cell of BENCHMARK.json and the files it names, found by name."""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PKG = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    """One workload with its configuration, traffic mix, metrics and
    limits."""
    name: str
    entry: dict
    config_entry: dict
    cfg: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    limits: dict
    chips: int = 1
    config_module: object = field(default=None, repr=False)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """Whether `cell` reports `metric`: its `workloads` list names the cell,
    or it has none and the cell reports the metric it moves (an
    end-to-end metric without the key is reported everywhere)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def cell(name: str, bench: dict | None = None, root: Path = ROOT) -> Cell:
    """The cell `name` of BENCHMARK.json, with its files loaded."""
    bench = bench if bench is not None else benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(entries)})")
    return make(entries[name], bench)


def make(entry: dict, bench: dict, root: Path = ROOT) -> Cell:
    """The cell of a workload entry (`name`, `config`, `traffic`,
    `chips`) whose configuration BENCHMARK.json lists."""
    name = entry["name"]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[entry["config"]]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, set())]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, name, e2e_names)]
    return Cell(
        name=name, entry=entry, config_entry=cfg_entry,
        cfg=load_json(root / cfg_entry["file"]),
        traffic=load_json(PKG / "traffic" / f"{entry['traffic']}.json"),
        end_to_end=e2e, per_layer=per_layer,
        limits=_limits(name),
        chips=int(entry["chips"]),
        config_module=importlib.import_module(
            f"wabench.configs.{entry['config']}"))


def _limits(name: str) -> dict:
    path = PKG / "limits" / f"{name}.json"
    return load_json(path) if path.exists() else {}


def metric_reader(name: str):
    """The `read(run)` of `metrics/<name>.py`, else of the file of the
    quantity before the first dot (`metrics/idle_share.py` serves
    `idle_share.bounce`)."""
    for stem in (name, name.split(".")[0]):
        path = PKG / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"wabench.metrics._{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name!r} under "
                            f"{PKG / 'metrics'}")
