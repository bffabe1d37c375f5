"""Run one cell of BENCHMARK.json once on this machine's card:

    python3 -m wabench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (the seeded inputs, the graph, staging, the warm-up requests that
build every kernel and capture every CUDA graph this traffic uses), then
a window of requests back to back for `--seconds` and through the end of
the one in flight, then the output check against the plain reference on
a seeded sample of the window's results.  The last line of standard
output is one JSON object: `correct`, `attempted`, `failed`, `metrics`
(the cell's end-to-end metrics; with `--trace 1` its per-layer ones from
a profiled window), `device`, with `--trace 1` `breakdown`, and last
`checks`, each compared number beside its limit (also the last lines of
standard error).  Exits 2 without a result where there is no CUDA card
or fewer than the cell asks for, and 3 where JAX or the JAX package was
loaded.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

from wabench.core import bench as _bench  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


# The host threads of the cell's deployment are its traffic's
# `host_threads`: a bounce server gives each render worker one; null
# leaves the math libraries their own count, as a batch pipeline that has
# the host to itself runs them.  The libraries size their thread pools
# when they load: set the count before numpy and torch load, in a run only
if __name__ == "__main__":
    _entries = {w["name"]: w for w in _bench.benchmark()["workloads"]}
    _w = _entries.get(parse().workload)
    _n = _w and _bench.load_json(
        _bench.PKG / "traffic" / f"{_w['traffic']}.json")["host_threads"]
    if _n:
        for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                     "OPENBLAS_NUM_THREADS"):
            os.environ[_var] = str(_n)

from wabench.core import device as _device  # noqa: E402
from wabench.core import guard as _guard  # noqa: E402
from wabench.core import trace as _trace  # noqa: E402
from wabench.core import traffic as _traffic  # noqa: E402

# kernel caches inside the checkout, at a fixed path
CACHE = _bench.ROOT / ".wabench_cache"


def _sync(torch, device):
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def execute(cell, seed, seconds, trace, device="cuda", t0=None):
    """Set up, warm up and run the window of a cell on `device`, then drop
    the program's state.  Returns (run, the driver ready to check, the
    card's record or None off the card, the forbidden modules loaded)."""
    import torch

    import webaudio_tpu_torch as wt

    t0 = _T0 if t0 is None else t0
    run = _traffic.Run(cell)
    spans = _trace.Spans(bool(trace))
    drv = _traffic.driver(cell, wt, device, seed, spans, run)
    drv.setup()
    drv.warm()
    _sync(torch, device)
    run.setup_s = time.perf_counter() - t0
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if str(device).startswith("cuda"):
            acts.append(ProfilerActivity.CUDA)
        span = min(seconds, float(cell.traffic["trace_seconds"]))
        with _trace.wrapped(cell.traffic.get("wrap", ()), spans), \
                profile(activities=acts) as prof:
            _traffic.window(drv, run, span, spans)
            _sync(torch, device)
        run.trace = _trace.from_profiler(prof)
    else:
        _traffic.window(drv, run, seconds, spans)
        _sync(torch, device)
    dev = (_device.record(torch, cell.chips)
           if str(device).startswith("cuda") else None)
    forbidden = _guard.forbidden_loaded()
    drv.close()
    gc.collect()
    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()
    return run, drv, dev, forbidden


def judge(cell, run, drv):
    """The compared numbers beside their limits, and `correct`."""
    got = drv.check()
    checks = {k: {"value": v, "limit": cell.limits[k]}
              for k, v in got.items()}
    failed = sum(1 for r in run.requests if not r.ok)
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())
    return correct, checks


def metrics(cell, run, trace):
    out = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = _bench.metric_reader(m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def result(cell, run, dev, correct, checks, trace):
    res = {"correct": bool(correct), "attempted": len(run.requests),
           "failed": sum(1 for r in run.requests if not r.ok),
           "metrics": metrics(cell, run, trace), "device": dev}
    if trace:
        res["device"] = dict(dev or {}, busy_s=run.trace.busy_s(),
                             window_s=run.trace.window_s)
        res["breakdown"] = _trace.breakdown(run.trace)
    res["checks"] = checks
    return res


def main(argv=None) -> int:
    args = parse(argv)
    CACHE.mkdir(exist_ok=True)
    os.environ.setdefault("CUDA_CACHE_PATH", str(CACHE / "nv"))
    cell = _bench.cell(args.workload)
    import torch

    if cell.traffic["host_threads"]:
        torch.set_num_threads(cell.traffic["host_threads"])
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"wabench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run, drv, dev, forbidden = execute(cell, args.seed, args.seconds,
                                       args.trace)
    if forbidden:
        print(f"wabench: the run loaded {', '.join(forbidden)}",
              file=sys.stderr)
        return 3
    correct, checks = judge(cell, run, drv)
    res = result(cell, run, dev, correct, checks, args.trace)
    res["card"] = _device.power_limit()
    lat = [(r.t1 - r.t0) * 1e3 for r in run.requests]
    res["latency_ms"] = {"n": len(lat), "min": min(lat),
                         "quartiles": statistics.quantiles(lat, n=4)
                         if len(lat) > 1 else lat, "max": max(lat),
                         "window_s": run.window_s}
    res["checks"] = res.pop("checks")
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
