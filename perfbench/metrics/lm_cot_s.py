"""Median over the window's calls of the port's `lm.cot` span under each
`plan` span (s): the CoT loop of all the call's rows, from the first
sampled token until every row is done and its tokens are on the host."""

from harness import plan_spans


def read(run):
    return plan_spans.median_per_plan(run, "lm.cot")
