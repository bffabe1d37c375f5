"""The port's own spans in a traced run's trace.

The port records its host work as `torch.profiler` ranges named
`webaudio.<name>` (`webaudio_tpu_torch/diagnostics.py::SPANS`), in the
same profiler session as the benchmark's spans.  `trace.from_profiler`
cuts `len("wabench.")` characters from every user annotation, so a port
span reaches the trace as `.<name>`; a parse that cut only the
benchmark's own prefix would leave `webaudio.<name>`.  Both forms are
matched here, and nothing else.
"""

from __future__ import annotations

PORT_PREFIX = "webaudio."


def forms(name: str) -> tuple:
    """The names the port's span `name` may carry in a trace."""
    return ("." + name, PORT_PREFIX + name)


def total(trace, *names) -> float:
    """Seconds the port's spans of `names` took, summed."""
    return trace.span_total(*(f for n in names for f in forms(n)))


def count(trace, *names) -> int:
    """How many of the port's spans of `names` the trace holds."""
    return sum(trace.span_count(f) for n in names for f in forms(n))


def requests(run) -> int:
    """The benchmark's `request` spans of the run's trace (0 untraced)."""
    return run.trace.span_count("request") if run.trace is not None else 0


def ms_per_request(run, *names):
    """Milliseconds a request in the port's spans of `names`, or None where
    the trace holds no request or none of these spans."""
    n = requests(run)
    if not n or not count(run.trace, *names):
        return None
    return 1e3 * total(run.trace, *names) / n
