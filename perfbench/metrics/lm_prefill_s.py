"""Median over the window's calls of the port's `lm.prefill` spans under
each `plan` span, summed a call (s): phase 1's prompts, then phase 2's
past the prefix phase 1 left in the cache (a traced prefill waits for its
logits, so each span holds its device work)."""

from harness import plan_spans


def read(run):
    return plan_spans.median_per_plan(run, "lm.prefill")
