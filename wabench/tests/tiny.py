"""Cells cut to sizes the CPU renders in seconds, for the tests: the same
files, graphs, drivers and reference, smaller.  Each configuration's and
each traffic mix's file holds its own cut under the key "tiny"."""

from __future__ import annotations

from wabench.core import bench

CELLS = [w["name"] for w in bench.benchmark()["workloads"]]


def shrink(c):
    c.cfg.update(c.cfg["tiny"])
    c.traffic.update(c.traffic["tiny"])
    return c


def cell(name):
    return shrink(bench.cell(name))


def pairing(config, traffic, vary=None):
    """A cell of any configuration with any traffic mix, as a later entry
    of BENCHMARK.json would make it, at the tiny size; `vary` replaces the
    mix's."""
    c = shrink(bench.make({"name": f"{config}.{traffic}", "config": config,
                           "traffic": traffic, "chips": 1},
                          bench.benchmark()))
    if vary is not None:
        c.traffic["vary"] = vary
    return c


def execute(c, seconds=0.5, seed=12345, trace=0):
    """(run, driver) of a tiny cell's run on the CPU, ready to check."""
    from wabench import run as runner

    r, drv, _, forbidden = runner.execute(c, seed, seconds, trace,
                                          device="cpu")
    assert not forbidden, forbidden
    return r, drv


def run(name, seconds=0.5, seed=12345, trace=0):
    """(correct, checks, run) of a tiny cell's run on the CPU."""
    from wabench import run as runner

    c = cell(name)
    r, drv = execute(c, seconds, seed, trace)
    correct, checks = runner.judge(c, r, drv)
    return correct, checks, r
