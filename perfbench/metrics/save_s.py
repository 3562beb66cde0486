"""Median over the completed songs of the handler's audio_conversion_time
(the save: FLAC encode and write, on the host), a fused render's shared
over its songs (s)."""

from harness import measure


def read(run):
    return measure.per_song(run, "audio_conversion_time")
