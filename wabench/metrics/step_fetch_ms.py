"""Host milliseconds a session step spends copying its output to the host:
the port's `session.fetch` spans, the wait for the walk included."""

from wabench.core import program


def read(run):
    return program.ms_per_request(run, "session.fetch")
