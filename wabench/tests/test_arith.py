"""The harness's arithmetic on hand-made inputs: interval unions and idle
gaps, the roofline of the resampler, the rates and the tail."""

import pytest

from wabench.core import trace, traffic
from wabench.core.bench import metric_reader
from wabench.core.peaks import bound_s


def test_union_merges_overlaps_and_clips():
    got = trace.union([(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6),
                       (-1.0, 0.2), (9.0, 11.0)], 0.0, 10.0)
    assert got == [(0.0, 2.0), (3.0, 4.0), (9.0, 10.0)]


def test_busy_counts_overlapping_streams_once():
    t = trace.Trace(window_s=10.0, device=[("a", 0.0, 2.0), ("b", 1.0, 3.0),
                                           ("c", 5.0, 6.0)])
    assert t.busy_s() == pytest.approx(4.0)
    assert metric_reader("idle_share.x")(traffic.Run(None, trace=t)) == \
        pytest.approx(60.0)


def test_host_segments_pick_the_innermost_open_span():
    spans = [("window", 0, 12), ("request", 0, 5), ("updates", 1, 2),
             ("request", 5, 10)]
    assert trace.host_segments(spans, 12.0) == [
        (0.0, 1.0, "request"), (1.0, 2.0, "updates"), (2.0, 10.0, "request"),
        (10.0, 12.0, "untraced host")]


def test_breakdown_sums_gaps_by_host_span():
    t = trace.Trace(window_s=10.0,
                    device=[("k1", 1.0, 2.0), ("k2", 4.0, 5.0),
                            ("k1", 5.0, 6.0)],
                    spans=[("request", 0.0, 10.0), ("plan", 2.0, 4.0)])
    b = trace.breakdown(t)
    assert b["device_ops"] == [["k1", 2.0], ["k2", 1.0]]
    gaps = {n.split(" ")[0]: v for n, v in b["idle_gaps"]}
    assert gaps == {"request": pytest.approx(5.0), "plan": pytest.approx(2.0)}
    t.spans.append(("resample", 6.5, 9.0))
    gaps = {n.split(" ")[0]: v for n, v in trace.breakdown(t)["idle_gaps"]}
    assert gaps == {"request": pytest.approx(2.5), "plan": pytest.approx(2.0),
                    "resample": pytest.approx(2.5)}


def _cell(instances, channels, rate, seconds):
    return type("C", (), {"cfg": {"channels": channels, "sample_rate": rate},
                          "traffic": {"instances": instances,
                                      "render_seconds": seconds}})()


def test_resampler_work_and_share():
    rr = metric_reader("resampler_roofline.augment")
    mod = __import__("wabench.metrics.resampler_roofline",
                     fromlist=["work"])
    ops, nbytes = mod.work(_cell(1, 1, 10.0, 1.0))
    assert (ops, nbytes) == (10 * 4 * 193, 10 * 40)
    big = _cell(1024, 2, 48000.0, 2.0)
    ops, nbytes = mod.work(big)
    least, what = bound_s(ops, nbytes)
    assert what == "bytes" and least == pytest.approx(7.86432e9 / 3.35e12)
    t = trace.Trace(window_s=1.0, spans=[("request", 0.0, 1.0)],
                    device=[("cudnn::cnn::conv2d_grouped_direct_kernel<x>",
                             0.0, 10 * least), ("other", 0.0, 1.0)])
    run = traffic.Run(big, trace=t)
    assert rr(run) == pytest.approx(10.0)


def test_resampler_kernels_by_name():
    mod = __import__("wabench.metrics.resampler_roofline",
                     fromlist=["is_resampler"])
    for name in ("cudnn::cnn::conv2d_grouped_direct_kernel<double>",
                 "sm90_xmma_fprop_implicit_gemm_f32f32", "polyphase_up",
                 "resample_down_kernel"):
        assert mod.is_resampler(name), name
    for name in ("void at::native::convert_kernel", "detector_tiles",
                 "curve_lookup_rows", "regular_fft_factor"):
        assert not mod.is_resampler(name), name


def test_rates():
    reqs = [traffic.Request(i * 0.1, i * 0.1 + 0.1, 2.0, 4, True)
            for i in range(20)]
    run = traffic.Run(None, requests=reqs, window_s=2.0)
    assert metric_reader("augment_rate")(run) == pytest.approx(80.0)
    assert metric_reader("render_rtf")(run) == pytest.approx(20.0)
    reqs[4] = traffic.Request(0.4, 0.5, 2.0, 4, False)
    assert metric_reader("augment_rate")(run) == pytest.approx(76.0)
    assert metric_reader("render_rtf")(run) == pytest.approx(19.0)
