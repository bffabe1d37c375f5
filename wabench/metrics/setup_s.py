"""Set-up: from the start of the process to the start of the window
(imports, pools, contexts, staging, warm-up and captures); host clock."""


def read(run):
    return run.setup_s
