"""BASELINE config 5 on one whole song a request: the graph, settings,
staging and preparation of `mastering.py`, on seeded synthetic songs as
long as the render, and the plain PyTorch reference of
`reference/mastering_track.py`, which holds a 4-minute song where the
NumPy one does not.  `mastering_track.json`'s `instance_seconds` is the
render's length, so `prepare` fits each track to the whole render and
the looping source plays it once.
"""

from __future__ import annotations

import numpy as np

from wabench.configs.mastering import (build, buffer_frames,  # noqa: F401
                                       curve, fit, prepare, settings, stage)
from wabench.reference import mastering_track as _ref
from wabench.reference.resample import resample as _resample


def _partials(f, amp, phase, n, fs, width=4096):
    """sum_k amp_k sin(2 pi (f_k t + phase_k)) over n frames at fs: each
    block of `width` frames is the first block's phasors turned to the
    block's start, so one product of matrices makes the whole sum."""
    nb = -(-n // width)
    first = np.exp(2j * np.pi * np.outer(f, np.arange(width) / fs))
    turn = np.exp(2j * np.pi * (np.outer(np.arange(nb) * width / fs, f)
                                + phase))
    return ((turn * amp) @ first).imag.reshape(-1)[:n]


def _track(cfg, rng, n, fs):
    """One stereo track of n frames at fs, float32: each channel 3-6
    partials of log-uniform frequency under the beat envelope and the
    section gains, plus noise."""
    period = 60.0 / rng.uniform(*cfg["bpm"])
    decay = rng.uniform(*cfg["beat_decay_s"])
    env = np.exp(np.mod(np.arange(n) / fs, period) * (-1.0 / decay))
    start = 0
    while start < n:
        stop = start + int(rng.uniform(*cfg["section_s"]) * fs)
        env[start:stop] *= rng.uniform(*cfg["section_gain"])
        start = stop
    lo, hi = cfg["partials"]
    out = np.empty((cfg["channels"], n), np.float32)
    for ch in range(cfg["channels"]):
        k = int(rng.integers(lo, hi + 1))
        f = np.exp(rng.uniform(*np.log(cfg["partial_hz"]), k))
        amp = rng.uniform(0.3, 1.0, k)
        out[ch] = _partials(f, amp / amp.sum(), rng.uniform(0.0, 1.0, k),
                            n, fs) * env
        out[ch] += cfg["noise"] * rng.standard_normal(n, dtype=np.float32)
    return out


def inputs(cfg, rng):
    """The pool of `clip_pool` tracks at the render's rate, each
    `instance_seconds` long; the seed picks the signals."""
    fs = cfg["sample_rate"]
    n = buffer_frames(cfg)
    return {"clips": [(_track(cfg, rng, n, fs), fs)
                      for _ in range(cfg["clip_pool"])]}


def reference(cfg, inputs, clips, settings, frames, precision="float64"):
    """Each track fitted here as `prepare` feeds the port (its rate is the
    context's: no resample), looped over the render, through the plain
    PyTorch reference one at a time."""
    fs, L = cfg["sample_rate"], buffer_frames(cfg)
    idx = np.arange(frames) % L
    out = []
    for i, (c, r) in enumerate(clips):
        x = fit(_resample(c, r, fs), L)[:, idx]
        out.append(_ref.render(
            x, curve(cfg, settings["drive"][i]).astype(np.float64),
            settings["threshold"][i], settings["ratio"][i], fs, precision,
            knee=cfg["knee_db"], attack=cfg["attack_s"],
            release=cfg["release_s"]))
    return np.stack(out)
