"""`track`: the `bounce` driver for renders whose output is too large to
copy a request: a whole song is 2 x 11,520,000 float32 samples (92 MB),
whose copy took 36-47 ms of a ~750 ms request on the card's host.  It
keeps the array `to_array()` returned, which nothing else holds once the
request's context is gone, where `bounce` keeps a copy.  The check is the
bounce's, with the reference given the cores the process may run on: it
runs after the window, whose one thread is the deployment's, and a song
takes ~11 s of one thread."""

from __future__ import annotations

import os
import time

import torch

from wabench.core import traffic
from wabench.drivers import bounce


class Driver(bounce.Driver):

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
            self.sample.offer({"clip": c, "settings": s, "out": out})
        return traffic.Request(t0, t1, self.tr["render_seconds"], 1, ok)

    def _reference(self, item, precision="float64"):
        threads = torch.get_num_threads()
        torch.set_num_threads(len(os.sched_getaffinity(0)))
        try:
            return super()._reference(item, precision)
        finally:
            torch.set_num_threads(threads)
