"""One reader a metric: `read(run)` returns the metric's value, or None
where the run holds nothing to read it from (the harness then leaves the
metric out).  `<quantity>.py` serves every `<quantity>.<suffix>`."""
