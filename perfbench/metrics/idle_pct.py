"""The share of the traced sub-window in which no operation ran on the
card (%), from torch.profiler's device events."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (t["window_s"] - t["busy_s"]) / t["window_s"]
