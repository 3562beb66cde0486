"""Median latency of every request completed in the window (s): from when
it was due (open loop) or sent (closed loop) until the client held it."""

from harness import measure


def read(run):
    return measure.percentile(measure.latencies(run), 50)
