"""Host milliseconds a request spends allocating the port's host staging
buffers (page-locked on the card): its `pin` spans, in `convert.upload`,
`convert.upload_into` and a batch's fetch."""

from wabench.core import program


def read(run):
    return program.ms_per_request(run, "pin")
