"""K1 (flash-attention forward, csrc/flash_attention.cu) in the traced
sub-window: the summed roofline bound of its launches, each at the shape
it was called with (harness/counts.k1_ops_bytes), over their summed device
time by kernel name (%)."""

from harness import roofline


def read(run):
    return roofline.share(run, "k1")
