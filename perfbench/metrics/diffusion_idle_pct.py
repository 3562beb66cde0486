"""The traced stretch's idle time inside the port's `diffusion` spans, over
those spans' time in the stretch (%): how long the card waits for the
host while the sampler runs."""

from harness import spans


def read(run):
    got, traced = spans.program_spans(run), spans.stretch_and_gaps(run)
    if not got or traced is None:
        return None
    idle, inside, _http = spans.diffusion_idle(*traced, got)
    return 100.0 * idle / inside if inside > 0 else None
