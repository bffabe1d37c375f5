"""Host milliseconds a session step spends compiling and uploading its
dense rows and advancing the live timelines: the port's `session.rows`
and `session.advance` spans."""

from wabench.core import program


def read(run):
    return program.ms_per_request(run, "session.rows", "session.advance")
