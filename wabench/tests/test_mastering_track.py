"""The `mastering.bounce` cell (config 5 on one whole song, the `track`
traffic) at a size the CPU renders: it resolves, runs and is correct; its
controls and a planted fault are not; its two readers read what they
should and nothing where the program has not what they read.

The runs take the card's detector (`WEBAUDIO_DETECTOR=seq`, its plain
version on the CPU).  The CPU's default, the JAX package's chunked
fixed point, solves 128-sample chunks in f32 and reads up to ~3.5e-4 x
peak on these tracks, as far off as the oversampler at tfloat32; the card
never runs it."""

import numpy as np
import pytest
import torch

from wabench import control
from wabench import run as runner
from wabench.core import bench, trace, traffic
from wabench.core.bench import metric_reader
from wabench.tests import tiny

CELL = "mastering.bounce"
NEW = ("detector_ns.track", "resources_ms.track")


@pytest.fixture
def card_detector(monkeypatch):
    monkeypatch.setenv("WEBAUDIO_DETECTOR", "seq")


def _two_blocks(monkeypatch):
    """The tiny track's 188 quanta walked in two blocks of 94, as the
    song's 90,000 are in two of 45,000."""
    from webaudio_tpu_torch.graph import compiler

    monkeypatch.setattr(compiler, "_budget_quanta", lambda nodes: 64)


def _detector_not_carried(monkeypatch):
    """Each block's detector starts from y = 0, not from the last block's
    y: the carry across the block boundary lost."""
    from webaudio_tpu_torch.nodes import dynamics_compressor as dc

    detector = dc._detector

    def broken(y0, x, at, rt, const_taus=None):
        return detector(torch.zeros_like(y0), x, at, rt, const_taus)
    monkeypatch.setattr(dc, "_detector", broken)


def test_cell_resolves_to_its_files():
    c = bench.cell(CELL)
    assert c.entry["config"] == "mastering_track" and c.chips == 1
    assert c.traffic["driver"] == "track" and c.traffic["host_threads"] == 1
    assert c.cfg["reduced"] == [] and c.cfg["instance_seconds"] == \
        c.traffic["render_seconds"] == 240.0
    assert {m["name"] for m in c.end_to_end} == {"setup_s", "render_rtf"}
    assert {m["name"] for m in c.per_layer} == set(NEW)
    assert c.limits == {"max_rel_err": 1e-4}


def test_tiny_cell_is_correct_in_two_blocks(card_detector, monkeypatch):
    _two_blocks(monkeypatch)
    c = tiny.cell(CELL)
    run, drv = tiny.execute(c, seconds=0.5, seed=2**31 + 24)
    correct, checks = runner.judge(c, run, drv)
    assert correct, checks
    assert run.requests and all(r.ok for r in run.requests)
    assert checks["max_rel_err"]["value"] < 3e-5
    assert all(item["out"].dtype == np.float32
               for item in drv.sample.items())


def test_controls_fail_where_the_program_passes(card_detector):
    c = tiny.cell(CELL)
    got = control.readings(c, 90210, 0.3, device="cpu",
                           further=["float32,fir=tfloat32"])
    assert got["failed"] == 0 and got["control_precision"] == "tfloat32"
    limit = c.limits["max_rel_err"]
    assert got["program"]["max_rel_err"] <= limit
    assert got["control"]["max_rel_err"] > limit
    assert got["further"]["float32,fir=tfloat32"]["max_rel_err"] > limit


def test_detector_not_carried_across_blocks_is_not_correct(card_detector,
                                                           monkeypatch):
    _two_blocks(monkeypatch)
    correct, checks, _ = tiny.run(CELL, seconds=0.3)
    assert correct, checks
    _detector_not_carried(monkeypatch)
    correct, checks, _ = tiny.run(CELL, seconds=0.3)
    assert not correct, checks


def _run(spans=(), device=(), cell=None):
    return traffic.Run(cell, trace=trace.Trace(
        window_s=1.0, spans=list(spans), device=list(device)))


def test_readers_on_hand_made_traces():
    c = bench.cell(CELL)
    frames = 11_520_000
    spans = [("request", 0.0, 0.5), ("request", 0.5, 1.0),
             (".render.resources", 0.1, 0.3),
             ("webaudio.render.resources", 0.6, 0.7),
             (".render.stage", 0.05, 0.35)]
    device = [("void (anonymous namespace)::detector_tiles<false, true>(...)",
               0.1, 0.2), ("detector_tiles", 0.6, 0.62),
              ("curve_lookup_global", 0.2, 0.3)]
    run = _run(spans, device, c)
    assert metric_reader("resources_ms.track")(run) == pytest.approx(150.0)
    assert metric_reader("detector_ns.track")(run) == \
        pytest.approx(1e9 * 0.12 / (2 * frames))


@pytest.mark.parametrize("name", NEW)
def test_readers_without_what_they_read(name):
    """No trace or no request: None.  Requests, but neither the span nor
    a detector kernel (the parent's program has no `render.resources`):
    None, and no exception."""
    read = metric_reader(name)
    c = bench.cell(CELL)
    assert read(traffic.Run(c)) is None
    assert read(_run([(".render.resources", 0.0, 0.1)],
                     [("detector_tiles", 0.0, 0.1)], c)) is None
    assert read(_run([("request", 0.0, 1.0), (".render.stage", 0.0, 0.5)],
                     [("curve_lookup_global", 0.0, 0.1)], c)) is None


def test_traced_tiny_run_reads_the_resources_span(card_detector):
    """On the CPU the port's spans are there and no kernel is: the span's
    reader reads, the detector's reads nothing."""
    c = tiny.cell(CELL)
    run, _ = tiny.execute(c, seconds=0.5, trace=1)
    assert run.trace.span_count("request") >= 1
    assert metric_reader("resources_ms.track")(run) > 0.0
    assert metric_reader("detector_ns.track")(run) is None
