"""Host milliseconds a session step spends saving checkpoints, spread over
every step of the window (a save every `save_every` steps): the port's
`session.save` spans."""

from wabench.core import program


def read(run):
    return program.ms_per_request(run, "session.save")
