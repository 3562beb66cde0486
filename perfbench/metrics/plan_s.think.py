"""Median of the facade's `plan` spans over the window (s): the planner's
whole share of a thinking call, CoT and codes of every song. (Named for
the whole metric: a reader of `plan_s` alone may serve other cells.)"""

from harness import spans


def read(run):
    got = spans.program_spans(run)
    if not got:
        return None
    return spans.median([s["end"] - s["start"] for s in got
                         if s["name"] == "plan"])
