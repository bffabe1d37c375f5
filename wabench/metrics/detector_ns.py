"""Device nanoseconds a frame of the compressor's level detector: the
device time of the detector's kernels in the traced window's requests,
over the frames those requests rendered.

The kernels are found by name: any whose name holds "detector" (the port's
`csrc/detector.cu` runs as `detector_tiles`).  A time, not a share, so a
detector that runs in parallel along the song reads lower and has no
ceiling to pass.  The floors on an H100 at 1.98 GHz: 6.06 ns a frame at
12 cycles a step (three dependent operations of 4), 7.76 ns at the
step's measured 15.36 cycles.  None where no detector kernel ran."""

import re

KERNEL_NAMES = re.compile(r"detector", re.I)


def is_detector(name: str) -> bool:
    return KERNEL_NAMES.search(name) is not None


def read(run):
    t = run.trace
    n = t.span_count("request") if t is not None else 0
    busy = t.device_time(is_detector) if n else 0.0
    if busy <= 0:
        return None
    cfg, tr = run.cell.cfg, run.cell.traffic
    frames = round(cfg["sample_rate"] * tr["render_seconds"])
    return 1e9 * busy / (n * frames)
