"""Rows and resource leaves a request sends to the device: the port's
`batch.upload` spans, one a send of `GraphBatch._stage`.  None where the
trace holds none (a port that does not record them)."""

from wabench.core import program


def read(run):
    n = program.requests(run)
    sends = program.count(run.trace, "batch.upload") if n else 0
    return sends / n if sends else None
