"""`batch`: a GraphBatch of the configuration's graph, `instances` of
them, instance i on clip i mod the pool's size, staged once at set-up.
A request draws every instance's settings over the traffic's `vary`,
stages them through the configuration's `stage` and bounces the batch
by `render_stream(1, updates, fetch="i16")`; its result is the batch's
int16 codes on the host.  The check compares a seeded sample of
instances of the sampled requests with the reference, bounced by the
same Philox dither."""

from __future__ import annotations

import time

import numpy as np

from wabench.core import traffic
from wabench.reference import philox


class Driver(traffic.Driver):

    def setup(self):
        super().setup()
        cfg, wt = self.cfg, self.wt
        self.N = int(self.tr["instances"])
        clips = self.inputs["clips"]
        self.clip_ids = np.arange(self.N) % len(clips)
        audio = np.stack([self.mod.prepare(wt, cfg, *clips[j])
                          for j in self.clip_ids])
        base = self.mod.settings(cfg, self.inputs, {}, self.data_rng, 1)
        ctx, self.nodes = self.mod.build(
            wt, cfg, self.inputs, self.device, self.frames, audio[0],
            {k: v[0] for k, v in base.items()}, batch=True)
        self.gb = wt.GraphBatch(ctx, batch=self.N)
        self.gb.override_buffer(self.nodes["source"], audio)
        self.scratch = {}

    def warm(self):
        """One whole request, then re-renders of the staged batch: the
        walk marks its block at the second and captures at the third, as
        every request of the window replays it."""
        self.request(-1, keep=False)
        for _ in range(int(self.tr["warm_requests"]) - 1):
            next(iter(self.gb.render_stream(1, None, fetch="i16")))

    def request(self, k, keep=True):
        s = self.draw(self.N)

        def updates(gb, _):
            with self.spans("updates"):
                self.mod.stage(gb, self.nodes, self.cfg, s, self.scratch)

        t0 = time.perf_counter()
        with self.spans("request"):
            codes = next(iter(self.gb.render_stream(1, updates,
                                                    fetch="i16")))
        t1 = time.perf_counter()
        ok = (codes.shape[:2] == (self.N, self.cfg["channels"])
              and codes.shape[2] >= self.frames and codes.dtype == np.int16
              and not traffic.silent_or_bad(codes[:, :, ::101]))
        if keep:
            ids = np.sort(self.sample.rng.choice(
                self.N, int(self.tr["check_per_request"]), replace=False))
            self.sample.offer({
                "ids": ids, "codes": codes[ids, :, :self.frames].copy(),
                "padded": codes.shape[2],
                "settings": {n: v[ids] for n, v in s.items()}})
        return traffic.Request(t0, t1, self.tr["render_seconds"], self.N, ok)

    def close(self):
        del self.gb, self.nodes

    def substitute(self, precision):
        """Put the reference at `precision` in the port's place: the
        control, bounced by the same dither."""
        items = self.sample.items()
        for item, codes in zip(items, self._reference_codes(items,
                                                            precision)):
            item["codes"] = codes

    def _reference_codes(self, items, precision="float64"):
        """Each item's instances rendered by the reference in one call and
        bounced by the dither at each instance's place in the batch."""
        clips = [self.inputs["clips"][self.clip_ids[i]]
                 for item in items for i in item["ids"]]
        settings = {n: np.concatenate([item["settings"][n]
                                       for item in items])
                    for n in items[0]["settings"]}
        out = iter(self.mod.reference(self.cfg, self.inputs, clips, settings,
                                      self.frames, precision))
        codes = []
        for item in items:
            per = self.cfg["channels"] * item["padded"]
            codes.append(np.stack([philox.dither_i16(next(out), 0,
                                                     int(i) * per)
                                   for i in item["ids"]]))
        return codes

    def check(self):
        worst = 0
        items = self.sample.items()
        for item, want in zip(items, self._reference_codes(items)):
            diff = np.abs(item["codes"].astype(np.int64)
                          - want.astype(np.int64))
            worst = max(worst, int(diff.max()))
        return {"max_code_diff": worst}
