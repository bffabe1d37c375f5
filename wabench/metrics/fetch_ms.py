"""Host milliseconds a request spends copying its render to the host: the
port's `render.fetch` spans, the wait for the walk's tail included."""

from wabench.core import program


def read(run):
    return program.ms_per_request(run, "render.fetch")
