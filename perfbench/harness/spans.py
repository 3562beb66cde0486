"""The port's own spans over a run's window, and the traced stretch's idle
gaps put down to them.

The port records its spans itself (`acestep_torch.utils.trace`) on the
same `time.monotonic()` clock that `harness/trace.py` maps the device
trace onto. A traced run turns its tracer on over the window and holds
the spans as `program_spans` (the tracer's drained records: name,
start, end, id, parent, requests, thread, attrs), and the traced
stretch as `trace["stretch"]` (its start and end) with its idle
intervals as `trace["gaps"]`; a reader finds nothing to read in a run
without them, in one whose ring dropped spans, or (for the idle) in a
stretch that lost its kernel records.
"""

from __future__ import annotations

import bisect
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

from harness import measure

# the handler's host stages around the device work, and the facade's
# per-song result entry
HOST_STAGES = ("render.prepare", "render.text", "render.dispatch",
               "render.fetch", "render.postprocess", "entry")

Interval = Tuple[float, float]


def program_spans(run) -> Optional[List[dict]]:
    """The run's program spans; None without them, and where the port's
    ring dropped any (a reading over part of the window)."""
    if run.spans_dropped:
        return None
    return run.program_spans or None


def stretch_and_gaps(run) -> Optional[Tuple[Interval, List[Interval]]]:
    """The traced stretch and its idle intervals, where the device trace
    can be read (`measure.device_trace`)."""
    t = measure.device_trace(run)
    if t is None:
        return None
    return tuple(t["stretch"]), [tuple(g) for g in t["gaps"]]


def merge(intervals) -> List[Interval]:
    """Sorted, disjoint union of `intervals`."""
    out: List[list] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def intersect(a: Sequence[Interval], b: Sequence[Interval]) -> List[Interval]:
    """The intersection of two sorted, disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def total(intervals) -> float:
    return sum(e - s for s, e in intervals)


def named(spans: List[dict], pred) -> List[Interval]:
    return merge((s["start"], s["end"]) for s in spans if pred(s["name"]))


def per_song_host_stages(spans: List[dict]) -> List[float]:
    """Seconds of host stages a song: each `request` span's summed
    HOST_STAGES descendants over its songs (its `entry` spans; a fused
    render's shared over its songs), once for each song."""
    by_id = {s["id"]: s for s in spans}

    def request_of(s):
        while s is not None and s["name"] != "request":
            s = by_id.get(s["parent"])
        return None if s is None else s["id"]

    totals: Dict[int, float] = {}
    songs: Dict[int, int] = {}
    for s in spans:
        if s["name"] not in HOST_STAGES:
            continue
        rid = request_of(s)
        if rid is None:
            continue
        totals[rid] = totals.get(rid, 0.0) + (s["end"] - s["start"])
        if s["name"] == "entry":
            songs[rid] = songs.get(rid, 0) + 1
    out = []
    for rid, seconds in totals.items():
        n = songs.get(rid, 0)
        out += [seconds / n] * n
    return out


def rendering_threads(spans: List[dict]) -> set:
    return {s["thread"] for s in spans if s["name"] == "render"}


def split_idle(stretch: Interval, gaps: Sequence[Interval],
               spans: List[dict], threads: set) -> Dict[str, float]:
    """Idle seconds of the stretch by the innermost span of `threads` open
    over each piece of a gap, the gaps cut at those spans' starts and
    ends ("none" where no span is open). Spans of one thread nest, so the
    innermost open span is the one that began last (of two that began
    together, the one opened later: ids count up as spans open)."""
    lo, hi = stretch
    own = [s for s in spans if s["thread"] in threads
           and s["start"] < hi and s["end"] > lo]
    points = sorted({p for s in own for p in (s["start"], s["end"])})
    labels = []
    for a, b in zip(points, points[1:]):
        mid = (a + b) / 2
        open_ = [s for s in own if s["start"] <= mid < s["end"]]
        labels.append(max(open_, key=lambda s: (s["start"], s["id"]))["name"]
                      if open_ else "none")
    out: Dict[str, float] = {}
    for g0, g1 in gaps:
        cuts = [g0] + points[bisect.bisect_right(points, g0):
                             bisect.bisect_left(points, g1)] + [g1]
        for a, b in zip(cuts, cuts[1:]):
            i = bisect.bisect_right(points, (a + b) / 2) - 1
            label = labels[i] if 0 <= i < len(labels) else "none"
            out[label] = out.get(label, 0.0) + (b - a)
    return out


def diffusion_idle(stretch: Interval, gaps: Sequence[Interval],
                   spans: List[dict]) -> Tuple[float, float, float]:
    """(idle seconds inside `diffusion` spans, those spans' seconds, idle
    seconds inside them while a `serve.http` span was open), within the
    traced stretch."""
    diff = intersect(named(spans, lambda n: n == "diffusion"), [stretch])
    idle = intersect(merge(gaps), diff)
    http = named(spans, lambda n: n == "serve.http")
    return total(idle), total(diff), total(intersect(idle, http))


def launched_inside(events, names: Sequence[str],
                    intervals: List[Interval]) -> Optional[float]:
    """The share (%) of the traced kernels of `names` whose launch (the
    host time of the runtime call) lies inside `intervals`."""
    starts = [s for s, _e in intervals]
    launches = [e[3] for e in events
                if e[3] is not None and any(k in e[0] for k in names)]
    if not launches:
        return None
    inside = 0
    for t in launches:
        i = bisect.bisect_right(starts, t) - 1
        inside += i >= 0 and t <= intervals[i][1]
    return 100.0 * inside / len(launches)


def median(values: List[float]) -> Optional[float]:
    return statistics.median(values) if values else None
