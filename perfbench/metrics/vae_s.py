"""Median over the completed songs of the handler's vae_decode_time_cost
(tiled decode and the int16 transfer to the host), a fused render's shared
over its songs (s)."""

from harness import measure


def read(run):
    return measure.per_song(run, "vae_decode_time_cost")
