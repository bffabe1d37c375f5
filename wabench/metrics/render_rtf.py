"""Audio seconds of one graph rendered per wall second, over every request
of the window that returned sound audio and the window's whole length;
host clock."""


def read(run):
    audio = sum(r.audio_s for r in run.requests if r.ok)
    return audio / run.window_s if run.window_s > 0 and audio > 0 else None
