"""Median over the window's `lm.codes` spans of the span over its steps
(ms): one decode step of the codes phase, sampling included, at the
call's rows."""

from harness import spans


def read(run):
    got = spans.program_spans(run)
    if not got:
        return None
    return spans.median([1e3 * (s["end"] - s["start"]) / s["attrs"]["steps"]
                         for s in got if s["name"] == "lm.codes"
                         and s["attrs"].get("steps")])
