"""BASELINE config 3, the convolution reverb with a feedback delay, built
through the port's public API: a looping AudioBufferSourceNode into a
normalized ConvolverNode and into a DelayNode of 0.31 s whose output
feeds back through a GainNode of 0.4; the convolver and the gain into
the destination.  Settings: which impulse response of the pool ("ir");
a batch shares the one it was built with.
"""

from __future__ import annotations

import numpy as np

from wabench.reference import reverb as _ref
from wabench.reference.resample import resample as _resample


def inputs(cfg, rng):
    """Dry clips at the context's rate and impulse responses, float32."""
    fs, C = cfg["sample_rate"], cfg["channels"]
    n = int(round(cfg["dry_seconds"] * fs))
    P = cfg["dry_pool"]
    t = np.arange(n) / fs
    f = rng.uniform(80.0, 2000.0, (P, C, 1))
    trem = 1.0 + 0.5 * np.sin(2 * np.pi * rng.uniform(0.2, 3.0, (P, 1, 1))
                              * t)
    dry = rng.uniform(0.2, 0.9, (P, 1, 1)) * trem * np.sin(2 * np.pi * f * t)
    dry += 0.03 * rng.standard_normal((P, C, n))
    m = int(round(cfg["ir_seconds"] * fs))
    lo, hi = cfg["ir_decays_s"]
    decays = rng.permutation(np.linspace(lo, hi, cfg["ir_pool"]))
    irs = (rng.standard_normal((cfg["ir_pool"], C, m))
           * np.exp(-np.arange(m) / fs / decays[:, None, None]))
    return {"clips": [(d, fs) for d in dry.astype(np.float32)],
            "irs": irs.astype(np.float32)}


def settings(cfg, inputs, vary, rng, n):
    """"ir": "pool" in `vary` draws each instance's from the pool; else
    the pool's first."""
    out = {"ir": np.zeros(n, np.int64)}
    for name, how in vary.items():
        if name != "ir" or how != "pool":
            raise ValueError(f"reverb cannot vary {name!r} by {how!r}")
        out["ir"] = rng.integers(0, len(inputs["irs"]), n)
    return out


def prepare(wt, cfg, clip, rate):
    """Resampled by the port's AudioBuffer.resample, whole."""
    buf = wt.AudioBuffer.from_array(clip, rate)
    buf.resample(cfg["sample_rate"])
    return buf.to_array()


def build(wt, cfg, inputs, device, frames, audio, one, batch):
    fs = cfg["sample_rate"]
    ctx = wt.OfflineAudioContext(cfg["channels"], frames, fs, device=device)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = wt.AudioBuffer.from_array(audio, fs)
    src.start()
    verb = ctx.create_convolver(
        disable_normalization=not cfg["normalize"])
    verb.set_buffer(wt.AudioBuffer.from_array(
        inputs["irs"][int(one["ir"])], fs))
    src.connect(verb)
    verb.connect(ctx.destination)
    d = ctx.create_delay(max_delay_time=cfg["max_delay_s"])
    d.delay_time.value = cfg["delay_s"]
    fb = ctx.create_gain(gain=cfg["feedback"])
    src.connect(d)
    d.connect(fb)
    fb.connect(d)
    fb.connect(ctx.destination)
    return ctx, {"source": src, "convolver": verb, "delay": d, "gain": fb,
                 "ir": int(one["ir"])}


def stage(gb, nodes, cfg, settings, scratch):
    if np.any(np.asarray(settings["ir"]) != nodes["ir"]):
        raise ValueError("a batch of the reverb shares the impulse "
                         "response it was built with")


def reference(cfg, inputs, clips, settings, frames, precision="float64"):
    fs = cfg["sample_rate"]
    return np.stack([
        _ref.render(_resample(c, r, fs), inputs["irs"][int(i)], fs,
                    cfg["delay_s"], cfg["feedback"], 0, frames, precision)
        for (c, r), i in zip(clips, settings["ir"])])
