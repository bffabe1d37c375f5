"""The readers of the port's own spans (`core/program.py` and the metrics
that read it): which names they match, what they read from hand-made
traces, and a value from each in traced runs of both cells on the CPU."""

import pytest

from wabench.core import bench, program, trace, traffic
from wabench.core.bench import metric_reader
from wabench.tests import tiny

NEW = {"override_ms.augment": "mastering.augment",
       "pin_ms.augment": "mastering.augment",
       "rebuilds.augment": "mastering.augment",
       "render_stage_ms.bounce": "reverb.bounce",
       "fetch_ms.bounce": "reverb.bounce",
       "pin_ms.bounce": "reverb.bounce"}


def _run(spans, window_s=1.0):
    return traffic.Run(None, trace=trace.Trace(window_s=window_s,
                                               spans=spans))


def test_a_port_span_matches_in_both_forms_and_nothing_else():
    t = trace.Trace(window_s=1.0, spans=[
        (".pin", 0.0, 0.1), ("webaudio.pin", 0.2, 0.4),
        ("pin", 0.0, 1.0), ("wabench.pin", 0.0, 1.0), (".pinned", 0.0, 1.0),
        ("webaudio.pin.x", 0.0, 1.0), ("xpin", 0.0, 1.0),
        (".build", 0.5, 0.6)])
    assert program.count(t, "pin") == 2
    assert program.total(t, "pin") == pytest.approx(0.3)
    assert program.count(t, "pin", "build") == 3
    assert program.count(t, "capture") == 0


def test_readers_on_hand_made_traces():
    spans = [("request", 0.0, 0.5), ("request", 0.5, 1.0),
             ("updates", 0.0, 0.3),
             (".batch.override_param", 0.0, 0.1),
             ("webaudio.batch.override_buffer", 0.1, 0.15),
             (".pin", 0.3, 0.32), (".render.stage", 0.5, 0.56),
             (".render.fetch", 0.9, 0.91), (".capture", 0.4, 0.45),
             ("webaudio.build", 0.6, 0.7), ("build", 0.6, 0.8)]
    run = _run(spans)
    want = {"override_ms": 75.0, "pin_ms": 10.0, "rebuilds": 1.0,
            "render_stage_ms": 30.0, "fetch_ms": 5.0}
    for stem, v in want.items():
        assert metric_reader(stem + ".x")(run) == pytest.approx(v), stem


@pytest.mark.parametrize("name", sorted(NEW))
def test_readers_without_their_spans(name):
    """No request span: None from every reader.  Requests but none of the
    port's spans (the parent's program): None, and 0 rebuilds."""
    read = metric_reader(name)
    assert read(traffic.Run(None)) is None
    assert read(_run([(".pin", 0.0, 0.1)])) is None
    got = read(_run([("request", 0.0, 1.0), ("build", 0.0, 0.5)]))
    assert got == (0.0 if name.startswith("rebuilds") else None)


def test_new_entries_resolve():
    entries = {m["name"]: m for m in bench.benchmark()["per_layer"]}
    for name, cell in NEW.items():
        m = entries[name]
        assert m["source"] == "program_span" and m["workloads"] == [cell]
        assert name in {x["name"] for x in bench.cell(cell).per_layer}
        assert callable(metric_reader(name))


@pytest.mark.parametrize("cell", sorted(set(NEW.values())))
def test_traced_tiny_runs_read_every_new_metric(cell):
    c = tiny.cell(cell)
    run, _ = tiny.execute(c, seconds=0.5, trace=1)
    assert run.trace.span_count("request") >= 1
    for name in (n for n, w in NEW.items() if w == cell):
        v = metric_reader(name)(run)
        assert v is not None, name
        if name.startswith("rebuilds"):
            assert v == 0.0
        else:
            assert v > 0.0, name
