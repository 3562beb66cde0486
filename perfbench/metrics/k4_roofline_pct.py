"""K4 (fused snake + conv residual stack, csrc/snake_conv.cu) in the
traced sub-window: the summed roofline bound of its calls, each at its
shape (harness/counts.k4_ops_bytes), over their kernels' summed device
time (%)."""

from harness import roofline


def read(run):
    return roofline.share(run, "k4")
