"""The `reverb.session` cell at a CPU size (`tiny` in its traffic file: a
0.5 s render in 2,048-frame steps, a save every 2 and the checkpoint at
frame 8,192 pinned): its run is correct against the reference, renders
past its end by a restart from the pinned checkpoint, and checks a step
at or past the pinned frame; each fault planted where the port would
produce it comes out not correct, and so does the control.  Its three
readers of the port's session spans, on hand-made traces and in a traced
run."""

import pytest
import torch

from wabench import control
from wabench import run as runner
from wabench.core import bench, traffic, trace
from wabench.core.bench import metric_reader
from wabench.tests import tiny

CELL = "reverb.session"
SEED = 2**33 + 5
NEW = ("step_host_ms.session", "step_fetch_ms.session", "save_ms.session")


def _run(seconds=1.0, seed=SEED, check_sample=None):
    c = tiny.cell(CELL)
    if check_sample is not None:
        c.traffic["check_sample"] = check_sample
    r, drv = tiny.execute(c, seconds, seed)
    correct, checks = runner.judge(c, r, drv)
    return correct, checks, r, drv


def test_tiny_session_is_correct_through_a_restart():
    correct, checks, run, drv = _run(seconds=2.0)
    assert correct, checks
    assert checks["resume_max_rel_err"]["value"] == 0.0
    assert drv.restarts >= 1 and drv.pinned_step is not None
    assert drv.pinned_step["frame"] >= drv.pin_frame
    assert any(it is drv.pinned_step for it in drv._items())
    assert drv.sample.items()[-1]["frame"] + drv.step_frames <= drv.frames
    assert all(r.audio_s == drv.step_frames / drv.fs for r in run.requests)


def _ring_zeroed(monkeypatch):
    from webaudio_tpu_torch import checkpoint

    restore = checkpoint.RenderSession.restore

    def broken(self, path):
        restore(self, path)
        for st in self._states.values():
            if isinstance(st, dict) and "ring" in st:
                st["ring"] = torch.zeros_like(st["ring"])
    monkeypatch.setattr(checkpoint.RenderSession, "restore", broken)


def _last_sample_misread(monkeypatch):
    """The wrap's tolerance at 2^26 samples of a playhead that grows with
    the render (one sample), planted at the CPU size."""
    from webaudio_tpu_torch.nodes import buffer_source as bs

    def broken(pos, ls, le, loop_len):
        wrapped = ls + bs._floor_mod(pos - ls, loop_len)
        return torch.where(le - wrapped <= 1.0, torch.full_like(wrapped, ls),
                           wrapped)
    monkeypatch.setattr(bs, "_loop_wrap", broken)


@pytest.mark.parametrize("fault", [_ring_zeroed, _last_sample_misread])
def test_fault_is_not_correct(fault, monkeypatch):
    """At this size the convolver's 0.1 s tail carries a misread sample
    through 40% of the 0.25 s loop (the cell's 2 s tail, through all of
    its 2 s loop), so the check samples each of the render's 10 steps."""
    fault(monkeypatch)
    correct, checks, _, _ = _run(seconds=0.5, check_sample=16)
    assert not correct, checks


def test_control_is_not_correct():
    c = tiny.cell(CELL)
    got = control.readings(c, SEED, 0.5, device="cpu")
    limits = c.limits
    assert got["program"]["max_rel_err"] <= limits["max_rel_err"]
    assert got["control"]["max_rel_err"] > limits["max_rel_err"]


def _hand_made(spans):
    return traffic.Run(None, trace=trace.Trace(window_s=1.0, spans=spans))


def test_readers_on_hand_made_traces():
    run = _hand_made([
        ("request", 0.0, 0.5), ("request", 0.5, 1.0),
        (".session.rows", 0.0, 0.01), ("webaudio.session.advance", 0.1, 0.13),
        (".session.fetch", 0.2, 0.22), (".session.save", 0.9, 0.95),
        (".session.walk", 0.3, 0.4)])
    want = {"step_host_ms": 20.0, "step_fetch_ms": 10.0, "save_ms": 25.0}
    for stem, v in want.items():
        assert metric_reader(stem + ".session")(run) == pytest.approx(v)


@pytest.mark.parametrize("name", NEW)
def test_readers_without_their_spans(name):
    """The parent's program records none of these spans: None."""
    read = metric_reader(name)
    assert read(traffic.Run(None)) is None
    assert read(_hand_made([("request", 0.0, 1.0), (".pin", 0, 1)])) is None


def test_new_entries_resolve():
    entries = {m["name"]: m for m in bench.benchmark()["per_layer"]}
    cell = bench.cell(CELL)
    assert {m["name"] for m in cell.per_layer} == set(NEW)
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "render_rtf"}
    for name in NEW:
        m = entries[name]
        assert m["source"] == "program_span" and m["workloads"] == [CELL]
        assert m["moves"] == "render_rtf"


def test_traced_tiny_run_reads_every_new_metric():
    c = tiny.cell(CELL)
    run, _ = tiny.execute(c, seconds=0.5, trace=1)
    assert run.trace.span_count("request") >= 1
    for name in NEW:
        assert metric_reader(name)(run) > 0.0, name
