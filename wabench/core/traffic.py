"""The window, the record of a run, and the drivers found by name.

A traffic file (`traffic/<mix>.json`) names its `driver`, the request
loop of `drivers/<driver>.py`, and holds the loop's parameters.  A
driver calls only the configuration's hooks (`configs/<config>.py`),
which every configuration has alike, so any driver runs any
configuration.

Every driver is a closed loop with one caller: a request is issued when
the previous one has returned, and its latency runs from its issue until
its result is on the host.  Each request draws its inputs from the seed;
what shapes the plan (lengths, rates, sizes) stays fixed.  After the
window each driver compares a sample of its results, drawn from the seed
and with the last request in it, with the plain reference (`check`).
"""

from __future__ import annotations

import importlib
import time
import traceback
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Request:
    t0: float
    t1: float
    audio_s: float       # audio seconds of one graph
    graphs: int          # graphs rendered
    ok: bool


@dataclass
class Run:
    """What one run of a cell recorded, for the metric readers."""
    cell: object
    requests: list = field(default_factory=list)
    window_s: float = 0.0
    setup_s: float = 0.0
    trace: object = None


class Sample:
    """A seeded reservoir of `k` results, and the last result apart."""

    def __init__(self, k, rng):
        self.k, self.rng, self.seen = k, rng, 0
        self.kept, self.last = [], None

    def offer(self, item):
        if self.last is not None:
            self._reservoir(self.last)
        self.last = item

    def _reservoir(self, item):
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append(item)
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.k:
                self.kept[j] = item

    def items(self):
        return self.kept + ([self.last] if self.last is not None else [])


def silent_or_bad(x) -> bool:
    x = np.asarray(x)
    if x.dtype.kind == "f" and not np.isfinite(x).all():
        return True
    return not x.any()


class Driver:
    """What every driver shares: the cell's files, the port, and three
    independent streams of the seed (set-up data, requests, sample)."""

    def __init__(self, cell, wt, device, seed, spans, run):
        self.cell, self.wt, self.device = cell, wt, device
        self.cfg, self.tr = cell.cfg, cell.traffic
        self.mod = cell.config_module
        self.spans, self.run = spans, run
        self.data_rng, self.req_rng, pick_rng = [
            np.random.default_rng([int(seed), i]) for i in (1, 2, 3)]
        self.sample = Sample(int(self.tr["check_sample"]), pick_rng)
        self.fs = float(self.cfg["sample_rate"])
        self.frames = int(round(self.tr["render_seconds"] * self.fs))

    def setup(self):
        self.inputs = self.mod.inputs(self.cfg, self.data_rng)

    def draw(self, n):
        """n instances' settings, drawn over the traffic's `vary`."""
        return self.mod.settings(self.cfg, self.inputs,
                                 self.tr.get("vary", {}), self.req_rng, n)

    def warm(self):
        for k in range(int(self.tr["warm_requests"])):
            self.request(-1 - k, keep=False)

    def close(self):
        """Drop the program's state before the reference runs."""


def driver(cell, wt, device, seed, spans, run) -> Driver:
    """The driver that the cell's traffic names, `drivers/<driver>.py`."""
    kind = cell.traffic["driver"]
    try:
        mod = importlib.import_module(f"wabench.drivers.{kind}")
    except ModuleNotFoundError as e:
        raise ValueError(f"traffic {cell.entry['traffic']!r}: no driver "
                         f"{kind!r} under wabench/drivers") from e
    return mod.Driver(cell, wt, device, seed, spans, run)


def window(drv, run, seconds, spans):
    """Requests back to back for `seconds`, then through the end of the
    one in flight; a request that raises counts as failed."""
    t_start = time.perf_counter()
    end = t_start + seconds
    k = 0
    with spans("window"):
        while time.perf_counter() < end:
            t0 = time.perf_counter()
            try:
                req = drv.request(k)
            except Exception:       # a failed request, recorded as such
                traceback.print_exc()
                req = Request(t0, time.perf_counter(), 0.0, 0, False)
            run.requests.append(req)
            k += 1
    run.window_s = run.requests[-1].t1 - t_start
    return run
