"""Seconds of audio delivered, over the seconds from the window's start
to the last delivery: all the work of the window over all its time."""


def read(run):
    ok = run.ok
    if not ok:
        return None
    return sum(r["duration_s"] for r in ok) / (max(r["done"] for r in ok) - run.w0)
