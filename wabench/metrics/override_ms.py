"""Host milliseconds a request spends in the port's batch overrides: its
`batch.override_param` (the row copy into the batch's row array) and
`batch.override_buffer` (per-instance resources) spans, apart from the
caller's own work in the harness's `updates`."""

from wabench.core import program


def read(run):
    return program.ms_per_request(run, "batch.override_param",
                                  "batch.override_buffer")
