"""90th percentile of the same latencies as latency_p50_s, over all
requests of the window (s)."""

from harness import measure


def read(run):
    return measure.percentile(measure.latencies(run), 90)
