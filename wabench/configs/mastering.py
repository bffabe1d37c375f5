"""BASELINE config 5, the mastering chain, built through the port's public
API: a looping AudioBufferSourceNode -> WaveShaperNode (4x) ->
DynamicsCompressorNode -> AnalyserNode -> destination.  Settings: the
curve's drive (tanh(drive x)), the compressor's threshold and ratio.
"""

from __future__ import annotations

import numpy as np

from wabench.reference import mastering as _ref
from wabench.reference.resample import resample as _resample

DEFAULTS = {"drive": "curve_drive", "threshold": "threshold_db",
            "ratio": "ratio"}


def buffer_frames(cfg) -> int:
    return int(round(cfg["sample_rate"] * cfg["instance_seconds"]))


def curve(cfg, drive) -> np.ndarray:
    """tanh(drive x) over x in [-1, 1] at the curve's points, float32."""
    x = np.linspace(-1.0, 1.0, cfg["curve_points"])
    return np.tanh(float(drive) * x).astype(np.float32)


def inputs(cfg, rng):
    """The corpus at its native rates.  The i-th of a fixed list has rate
    clip_rates[i % 3] and the i-th length of a grid over the spread, so
    every seed makes the same sizes; the seed picks their order and the
    signals."""
    count, rates = cfg["clip_pool"], cfg["clip_rates"]
    lo, hi = cfg["clip_length_spread"]
    spread = np.linspace(lo, hi, count)
    clips = []
    for i in rng.permutation(count):
        rate = rates[i % len(rates)]
        n = int(rate * cfg["instance_seconds"] * spread[i])
        t = np.arange(n) / rate
        f = rng.uniform(80.0, 2000.0, (cfg["channels"], 1))
        x = (rng.uniform(0.3, 1.2) * np.sin(2 * np.pi * f * t)
             + 0.05 * rng.standard_normal((cfg["channels"], n)))
        clips.append((x.astype(np.float32), rate))
    return {"clips": clips}


def settings(cfg, inputs, vary, rng, n):
    """Uniform over [lo, hi] for each setting `vary` names."""
    out = {k: np.full(n, float(cfg[key])) for k, key in DEFAULTS.items()}
    for name, (lo, hi) in vary.items():
        if name not in out:
            raise ValueError(f"mastering has no setting {name!r}")
        out[name] = rng.uniform(lo, hi, n)
    return out


def fit(x, length) -> np.ndarray:
    """Cut or pad with silence to `length` frames."""
    out = np.zeros((x.shape[0], length), x.dtype)
    m = min(length, x.shape[1])
    out[:, :m] = x[:, :m]
    return out


def prepare(wt, cfg, clip, rate):
    """Resampled by the port's AudioBuffer.resample, cut or padded to the
    instance's length."""
    buf = wt.AudioBuffer.from_array(clip, rate)
    buf.resample(cfg["sample_rate"])
    return fit(buf.to_array(), buffer_frames(cfg))


def build(wt, cfg, inputs, device, frames, audio, one, batch):
    """With `batch` the compressor's threshold and ratio carry automation,
    so that the plan gives them dense rows a batch can override."""
    fs = cfg["sample_rate"]
    ctx = wt.OfflineAudioContext(cfg["channels"], frames, fs, device=device)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = wt.AudioBuffer.from_array(audio, fs)
    src.start()
    shaper = ctx.create_wave_shaper(oversample=cfg["oversample"],
                                    curve=curve(cfg, one["drive"]))
    comp = ctx.create_dynamics_compressor(
        threshold=float(one["threshold"]), ratio=float(one["ratio"]),
        knee=cfg["knee_db"], attack=cfg["attack_s"],
        release=cfg["release_s"])
    if batch:
        for p, v in ((comp.threshold, one["threshold"]),
                     (comp.ratio, one["ratio"])):
            p.set_value_at_time(float(v), 0.0)
            p.set_value_at_time(float(v) + 1.0, frames / fs / 2)
    an = ctx.create_analyser(fft_size=cfg["analyser_fft_size"])
    src.connect(shaper)
    shaper.connect(comp)
    comp.connect(an)
    an.connect(ctx.destination)
    return ctx, {"source": src, "shaper": shaper, "compressor": comp,
                 "analyser": an}


def stage(gb, nodes, cfg, settings, scratch):
    """A curve each through the shaper's curve table, threshold and ratio
    as dense rows, written into `scratch` arrays that every request
    reuses."""
    n, T = gb.batch, gb.total_frames
    gb.override_buffer(nodes["shaper"],
                       np.stack([curve(cfg, d) for d in settings["drive"]]),
                       key="curve")
    for name in ("threshold", "ratio"):
        if name not in scratch:
            scratch[name] = np.empty((n, T), np.float32)
        rows = scratch[name]
        rows[:] = np.asarray(settings[name], np.float32)[:, None]
        gb.override_param(nodes["compressor"], name, rows)


def reference(cfg, inputs, clips, settings, frames, precision="float64"):
    """Each clip resampled and fitted here as `prepare` feeds the port,
    looped over the render."""
    fs, L = cfg["sample_rate"], buffer_frames(cfg)
    x = np.stack([fit(_resample(c, r, fs), L) for c, r in clips])
    x = x[..., np.arange(frames) % L]
    curves = np.stack([curve(cfg, d) for d in settings["drive"]]
                      ).astype(np.float64)
    return _ref.render(x, curves, settings["threshold"], settings["ratio"],
                       fs, precision, knee=cfg["knee_db"],
                       attack=cfg["attack_s"], release=cfg["release_s"])
