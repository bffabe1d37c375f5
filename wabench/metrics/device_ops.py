"""Device operations (kernels, copies, fills) of the traced window per
request, by the profiler's device trace."""


def read(run):
    t = run.trace
    n = t.span_count("request") if t is not None else 0
    return len(t.device) / n if n and t.device else None
