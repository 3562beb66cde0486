"""Median of the port's `dit.step` spans over the window (ms): what the
host spends enqueueing one sampler step."""

from harness import spans


def read(run):
    got = spans.program_spans(run)
    if not got:
        return None
    steps = [1e3 * (s["end"] - s["start"]) for s in got
             if s["name"] == "dit.step"]
    return spans.median(steps)
