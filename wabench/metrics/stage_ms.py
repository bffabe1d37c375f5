"""Host milliseconds a request spends staging the batch: the span around
the harness's `updates` (overrides, and for new audio the port's
resample) plus the port's `GraphBatch._stage` (the uploads), which the
traced run wraps."""


def read(run):
    t = run.trace
    n = t.span_count("request") if t is not None else 0
    total = t.span_total("updates", "GraphBatch._stage") if n else 0.0
    return 1e3 * total / n if total > 0 else None
