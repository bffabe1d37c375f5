"""`session`: one long render stepped by a RenderSession, as a preemptible
render worker runs it.  Set-up draws a dry clip and an impulse response
from the pools once and builds an OfflineAudioContext of
`render_seconds` on them, and a RenderSession over it
(`quanta_per_block`).  A request is one `step(step_frames)` and, where
the render's cursor then sits on a multiple of `save_every` steps, a
`save()` into a temporary directory, which keeps the newest two
checkpoints and the first at or past frame `pin_frame`.  Where the next
step would pass the context's end, the request first restores a fresh
context and session from that pinned checkpoint and renders on from
there (a restart).  Warm-up: one step, a save, a restore into a fresh
context and session, which renders from then on, and `warm_requests`
steps of it, so that the plan, captures and builds the window uses are
made before it.

After the window (`close`), the newest checkpoint followed by
`resume_steps` steps of the render (kept until a newer one is) is
restored into a fresh context and session, which renders those steps
again.  The check compares a seeded
sample of the window's steps, with the last one and the first at or
past `pin_frame` in it, with the reference's render of the same frames
from frame 0 (`reference/reverb.py::render(..., start, frames)`, which
renders any window with the feedback history it needs) by the widest
gap over the reference's peak (`max_rel_err`), and the resumed steps
with the render's own (`resume_max_rel_err`, the same measure)."""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time

import numpy as np

from wabench.core import traffic
from wabench.reference import reverb as _ref
from wabench.reference.resample import resample as _resample


def _rel(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


class Driver(traffic.Driver):

    def setup(self):
        super().setup()
        tr = self.tr
        self.step_frames = int(tr["step_frames"])
        self.qpb = int(tr["quanta_per_block"])
        self.save_frames = int(tr["save_every"]) * self.step_frames
        self.pin_frame = int(tr["pin_frame"])
        self.resume_steps = int(tr["resume_steps"])
        if self.pin_frame + self.save_frames + self.step_frames > self.frames:
            raise ValueError("the render ends before a checkpoint at or "
                             "past pin_frame")
        if int(tr["warm_requests"]) < self.resume_steps:
            raise ValueError("the warm-up's checkpoint needs resume_steps "
                             "steps after it")
        clips = self.inputs["clips"]
        self.clip = int(self.req_rng.integers(0, len(clips)))
        self.settings = {n: v[0] for n, v in self.draw(1).items()}
        self.audio = self.mod.prepare(self.wt, self.cfg, *clips[self.clip])
        self.dir = tempfile.mkdtemp(prefix="wabench-session-")
        self.saves = 0
        self.last_save = {}
        # the newest checkpoints: [path, frame, the render's steps after it]
        self.recent = []
        self.complete = None        # the newest with resume_steps after it
        self.pinned = None          # the first checkpoint at or past pin
        self.pinned_step = None     # the first step at or past pin
        self.restarts = 0
        self.window_steps = 0
        self.furthest = 0
        self.resumed = None
        self.session = self._fresh()

    def _fresh(self, path=None):
        """A fresh context and session of the render, restored from the
        checkpoint at `path` where one is given."""
        ctx, _ = self.mod.build(self.wt, self.cfg, self.inputs, self.device,
                                self.frames, self.audio, self.settings,
                                batch=False)
        s = self.wt.RenderSession(ctx, quanta_per_block=self.qpb)
        if path is not None:
            s.restore(path)
        return s

    def _save(self):
        path = os.path.join(self.dir, f"ck{self.saves}.npz")
        self.saves += 1
        self.session.save(path)
        # the port's counters (a port without them reports none)
        self.last_save = getattr(self.session, "stats", {})
        frame = self.session.frame
        if self.pinned is None and frame >= self.pin_frame:
            self.pinned = path
        self.recent.append([path, frame, []])
        for old in self.recent[:-2]:
            self._drop(old)
        del self.recent[:-2]

    def _drop(self, entry):
        """Remove a checkpoint that is neither pinned nor kept."""
        kept = [e[0] for e in self.recent[-2:]] + [self.pinned] + \
            [self.complete[0] if self.complete else None]
        if entry[0] not in kept:
            os.remove(entry[0])

    def _step(self):
        """One step of the render: (its first frame, its output), each
        kept checkpoint's steps after it extended."""
        frame = self.session.frame
        out = self.session.step(self.step_frames)
        for entry in self.recent:
            _, at, after = entry
            if len(after) < self.resume_steps and \
                    frame == at + len(after) * self.step_frames:
                after.append(out)
                if len(after) == self.resume_steps:
                    old, self.complete = self.complete, entry
                    if old is not None:
                        self._drop(old)
        if self.session.frame % self.save_frames == 0:
            self._save()
        return frame, out

    def warm(self):
        self.session.step(self.step_frames)
        self._save()
        path = self.recent[-1][0]
        self.session = None
        self.session = self._fresh(path)
        for k in range(int(self.tr["warm_requests"])):
            self.request(-1 - k, keep=False)

    def request(self, k, keep=True):
        t0 = time.perf_counter()
        with self.spans("request"):
            if self.session.frame + self.step_frames > self.frames:
                with self.spans("restart"):
                    self.session = None
                    self.session = self._fresh(self.pinned)
                self.restarts += 1
            frame, out = self._step()
        t1 = time.perf_counter()
        ok = out.shape == (self.cfg["channels"], self.step_frames) and \
            not traffic.silent_or_bad(out)
        if keep:
            self.window_steps += 1
            self.furthest = max(self.furthest, frame + self.step_frames)
            item = {"frame": frame, "out": out}
            self.sample.offer(item)
            if self.pinned_step is None and frame >= self.pin_frame:
                self.pinned_step = item
        return traffic.Request(t0, t1, self.step_frames / self.fs, 1, ok)

    def close(self):
        """Render again, in a fresh context and session, the steps after
        the newest checkpoint that has them; then drop the program's
        state and the checkpoints."""
        stats = self.last_save
        self.session = None
        # the warm-up's checkpoint has them where no later one does
        entry = self.complete
        s = self._fresh(entry[0])
        self.resumed = (entry, [s.step(self.step_frames)
                                for _ in range(self.resume_steps)])
        del s
        shutil.rmtree(self.dir, ignore_errors=True)
        print(f"wabench.session: {self.window_steps} steps in the window, "
              f"to frame {self.furthest} of {self.frames}; "
              f"{self.restarts} restarts; {self.saves} saves, the last "
              f"{stats.get('save_bytes')} bytes in "
              f"{stats.get('save_leaves')} leaves; resumed at frame "
              f"{entry[1]}", file=sys.stderr)

    def _items(self):
        items = self.sample.items()
        if self.pinned_step is not None and \
                all(it is not self.pinned_step for it in items):
            items.append(self.pinned_step)
        return items

    def _reference(self, frame, precision="float64"):
        cfg, fs = self.cfg, self.fs
        clip, rate = self.inputs["clips"][self.clip]
        return _ref.render(_resample(clip, rate, fs),
                           self.inputs["irs"][int(self.settings["ir"])], fs,
                           cfg["delay_s"], cfg["feedback"], frame,
                           self.step_frames, precision)

    def substitute(self, precision):
        """Put the reference at `precision` in the place of the render's
        own steps: the sampled ones and those the resumed steps are
        compared with."""
        for item in self._items():
            item["out"] = self._reference(item["frame"], precision).astype(
                np.float32)
        (_, at, after), _ = self.resumed
        after[:] = [self._reference(at + i * self.step_frames,
                                    precision).astype(np.float32)
                    for i in range(len(after))]

    def check(self):
        worst = max(_rel(item["out"], self._reference(item["frame"]))
                    for item in self._items())
        (_, _, after), again = self.resumed
        resume = max(_rel(g, w) for g, w in zip(again, after))
        return {"max_rel_err": worst, "resume_max_rel_err": resume}
