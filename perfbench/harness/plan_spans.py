"""The planner's spans over a run's window (the port's `lm.*` spans inside
each facade call's `plan` span), for the `.think` readers. A run whose
program has no such span reads nothing."""

from __future__ import annotations

from typing import List, Optional

from harness import spans


def per_plan(run, name: str) -> Optional[List[float]]:
    """Seconds of the `name` spans under each `plan` span, summed a plan;
    None where the window holds no `name` span."""
    got = spans.program_spans(run)
    if not got or not any(s["name"] == name for s in got):
        return None
    by_id = {s["id"]: s for s in got}
    totals = {s["id"]: 0.0 for s in got if s["name"] == "plan"}
    for s in got:
        if s["name"] != name:
            continue
        p = by_id.get(s["parent"])
        while p is not None and p["name"] != "plan":
            p = by_id.get(p["parent"])
        if p is not None:
            totals[p["id"]] += s["end"] - s["start"]
    return list(totals.values()) or None


def median_per_plan(run, name: str) -> Optional[float]:
    return spans.median(per_plan(run, name) or [])
