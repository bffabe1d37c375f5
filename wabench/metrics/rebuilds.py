"""CUDA graphs captured and kernels or host libraries compiled a request:
the port's `capture` and `build` spans.  0 where the window replays what
the warm-up captured and built; None without request spans."""

from wabench.core import program


def read(run):
    n = program.requests(run)
    if not n:
        return None
    return program.count(run.trace, "capture", "build") / n
