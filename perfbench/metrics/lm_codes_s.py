"""Median over the window's calls of the port's `lm.codes` span under each
`plan` span (s): the codes loop of all the call's rows, duration x 5
steps, until the codes are on the host."""

from harness import plan_spans


def read(run):
    return plan_spans.median_per_plan(run, "lm.codes")
