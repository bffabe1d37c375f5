"""Request loops, one a file: a traffic file's `driver` names one, and
`drivers/<driver>.py` holds its `Driver` (a `core.traffic.Driver`).  A
driver calls only the hooks that every configuration has alike
(`configs/__init__.py`), so it runs any configuration."""
