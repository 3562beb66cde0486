"""Median over the completed songs of the handler's diffusion_time_cost
(condition encoder, cross K/V, 8 DiT steps), a fused render's shared over
its songs (s)."""

from harness import measure


def read(run):
    return measure.per_song(run, "diffusion_time_cost")
