"""`bounce`: a fresh OfflineAudioContext a request, `render_seconds`
long, on a clip drawn from the pool with settings drawn over the
traffic's `vary`, rendered by `start_rendering_sync()`; its result is
the rendered buffer on the host.  The check compares the sampled
requests' whole outputs with the reference by the widest gap over the
reference's peak."""

from __future__ import annotations

import time

import numpy as np

from wabench.core import traffic


class Driver(traffic.Driver):

    def request(self, k, keep=True):
        clips = self.inputs["clips"]
        c = int(self.req_rng.integers(0, len(clips)))
        s = self.draw(1)
        t0 = time.perf_counter()
        with self.spans("request"):
            with self.spans("build"):
                audio = self.mod.prepare(self.wt, self.cfg, *clips[c])
                ctx, _ = self.mod.build(
                    self.wt, self.cfg, self.inputs, self.device, self.frames,
                    audio, {n: v[0] for n, v in s.items()}, batch=False)
            with self.spans("render"):
                out = ctx.start_rendering_sync().to_array()
        t1 = time.perf_counter()
        ok = out.shape == (self.cfg["channels"], self.frames) and \
            not traffic.silent_or_bad(out)
        if keep:
            self.sample.offer({"clip": c, "settings": s,
                               "out": np.array(out, copy=True)})
        return traffic.Request(t0, t1, self.tr["render_seconds"], 1, ok)

    def _reference(self, item, precision="float64"):
        return self.mod.reference(self.cfg, self.inputs,
                                  [self.inputs["clips"][item["clip"]]],
                                  item["settings"], self.frames,
                                  precision)[0]

    def substitute(self, precision):
        """Put the reference at `precision` in the port's place."""
        for item in self.sample.items():
            item["out"] = self._reference(item, precision).astype(np.float32)

    def check(self):
        worst = 0.0
        for item in self.sample.items():
            want = self._reference(item)
            peak = float(np.abs(want).max())
            worst = max(worst, float(np.abs(item["out"] - want).max())
                        / max(peak, 1e-30))
        return {"max_rel_err": worst}
