"""The whole step's share of the card's dense bf16 peak (%): the analytic
FLOPs of every song completed in the window (condition encoder, cross K/V,
DiT trajectory, VAE decode; harness/counts.py) over the songs' summed
service time, a fused render counted once, times the published peak."""

from harness import counts, measure


def read(run):
    peak = counts.peak(run.card)
    service = measure.service_s(run)
    if peak is None or not run.ok or service <= 0:
        return None
    flops = sum(measure.song_flops(run, r) for r in run.ok)
    return 100.0 * flops / (service * peak["bf16_flops"])
