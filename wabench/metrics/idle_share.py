"""The share of the traced window in which no operation ran on the card:
1 - (the union of the device's busy intervals) / the window; a union, so
operations overlapping on two streams count once."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
