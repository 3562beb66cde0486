"""The share of the traced sub-window in which no operation ran on the
card (%), from torch.profiler's device events; nothing in a stretch that
lost its kernel records."""

from harness import measure


def read(run):
    t = measure.device_trace(run)
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (t["window_s"] - t["busy_s"]) / t["window_s"]
