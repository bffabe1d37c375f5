"""Host milliseconds a request spends planning: the span around
`graph/compiler.py::compile_graph` (source fusion inside it), which the
traced run wraps."""


def read(run):
    t = run.trace
    n = t.span_count("request") if t is not None else 0
    if not n or not t.span_count("compile_graph"):
        return None
    return 1e3 * t.span_total("compile_graph") / n
