"""The 4x oversampler's share of its roofline in a batch of the mastering
chain: the least time the card could take for the direct polyphase FIR
that the output needs, over the device time of the resampler's kernels.

Work per dense input sample and channel: up, 4 outputs from the 193
taps' nonzero phases (193 multiply-adds in all, 2 operations each);
down, 193 multiply-adds for the one output kept.  Bytes: each pass reads
its input and writes its output once, 4 bytes a sample (up: 1 in, 4
out; down: 4 in, 1 out).  The bound is the larger of the operations at
67 TFLOP/s (f32, and f64 on the tensor cores alike) and the bytes at
3.35 TB/s.

The resampler's kernels are found by name in the trace of the captured
walk, where no span tells them apart.  The resampler is the only
convolution in that graph: `ops/resample.py` runs `conv1d` in float64,
which cuDNN ran on an H100 (torch 2.11, CUDA 12.8) as
`cudnn::cnn::conv2d_grouped_direct_kernel<..., double, ...>`, up and
down alike; any other convolution kernel of cuDNN or CUTLASS
("conv", "fprop", but not "convert") matches too, and so does a kernel
written for the resampler that says so in its name ("resampl",
"polyphase")."""

import re

from wabench.core.peaks import bound_s

TAPS = 193
FACTOR = 4
KERNEL_NAMES = re.compile(r"conv(?!ert)|fprop|resampl|polyphase", re.I)


def is_resampler(name: str) -> bool:
    return KERNEL_NAMES.search(name) is not None


def work(cell):
    """(operations, bytes) of one batch of the cell's traffic."""
    cfg, tr = cell.cfg, cell.traffic
    dense = (tr["instances"] * cfg["channels"]
             * round(cfg["sample_rate"] * tr["render_seconds"]))
    ops = dense * (2 * TAPS + 2 * TAPS)
    nbytes = dense * 4 * ((1 + FACTOR) + (FACTOR + 1))
    return ops, nbytes


def read(run):
    t = run.trace
    n = t.span_count("request") if t is not None else 0
    busy = t.device_time(is_resampler) if n else 0.0
    if busy <= 0:
        return None
    ops, nbytes = work(run.cell)
    least, _ = bound_s(ops, nbytes)
    return 100.0 * least * n / busy
