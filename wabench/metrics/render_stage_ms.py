"""Host milliseconds a request spends staging a fresh offline render: the
port's `render.stage` spans (states, the dense rows and the resources
uploaded before the walk)."""

from wabench.core import program


def read(run):
    return program.ms_per_request(run, "render.stage")
