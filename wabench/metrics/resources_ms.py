"""Host milliseconds a request spends staging its plan's resources on the
device: the port's `render.resources` spans (inside `render.stage`, where
`render_args` sends the source's buffer and the shaper's curve, once a
plan).  None where the program records no such span."""

from wabench.core import program


def read(run):
    return program.ms_per_request(run, "render.resources")
