"""Instances x audio seconds completed per wall second over the window,
every sound request counted; host clock."""


def read(run):
    audio = sum(r.audio_s * r.graphs for r in run.requests if r.ok)
    return audio / run.window_s if run.window_s > 0 and audio > 0 else None
