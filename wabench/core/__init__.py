"""The benchmark's shared core: the cell's files found by name
(`bench`), the window, the run record and the drivers' lookup
(`traffic`), the traced run's spans and device trace (`trace`), the
card's record and peaks (`device`, `peaks`), and the module guard
(`guard`)."""
