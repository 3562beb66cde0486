"""Median over the window's songs of the port's host stage spans around
the device work (render.prepare, render.text, render.dispatch,
render.fetch, render.postprocess and the facade's entry), summed for each
request, a fused render's shared over its songs (s)."""

from harness import spans


def read(run):
    got = spans.program_spans(run)
    return spans.median(spans.per_song_host_stages(got)) if got else None
