"""A finished run as the metric readers see it, and the arithmetic they
share. Every time is a `time.monotonic()` reading or a duration."""

from __future__ import annotations

import dataclasses
import math
import statistics
from types import ModuleType
from typing import Dict, List, Optional


@dataclasses.dataclass
class Run:
    conf: dict
    w0: float                           # the window's start
    records: List[dict]                 # one a request, see drivers._record
    setup_s: float
    memory_peak_bytes: int
    card: str
    coalesced: Optional[int] = None     # jobs the server fused, in the window
    trace: Optional[dict] = None        # trace.Tracer.summary()
    system: Optional[ModuleType] = None     # the configuration's system
    # traced runs: the port's own spans over the window (as its tracer
    # drains them), how many of them its ring dropped, and the change in
    # each of its counters over the window (program.PortTrace)
    program_spans: Optional[List[dict]] = None
    spans_dropped: int = 0
    counters: Optional[Dict[str, int]] = None

    @property
    def ok(self) -> List[dict]:
        return [r for r in self.records if r["ok"]]


def device_trace(run: Run) -> Optional[dict]:
    """The traced stretch's summary, where its device events can be read:
    None in an untraced run and in a stretch that lost the kernel records
    of more than `trace.Tracer.MAX_UNMATCHED` of its launches."""
    t = run.trace
    return t if t and t.get("complete") else None


def percentile(values: List[float], q: float) -> Optional[float]:
    """The q-th percentile by linear interpolation between order
    statistics; None without values."""
    if not values:
        return None
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def latencies(run: Run) -> List[float]:
    return [r["done"] - r["start"] for r in run.ok]


def per_song(run: Run, key: str) -> Optional[float]:
    """Median over the completed songs of a stage's time cost, a fused
    render's shared over its songs."""
    vals = [r["time_costs"][key] / max(1, r["coalesced"]) for r in run.ok
            if key in r["time_costs"]]
    return statistics.median(vals) if vals else None


def song_flops(run: Run, rec: dict) -> float:
    """The analytic FLOPs of one completed request, as its system counts
    them."""
    return run.system.request_flops(run.conf, rec)


def service_s(run: Run) -> float:
    """The summed service time of the completed songs' renders, a fused
    render counted once."""
    seen: Dict[tuple, float] = {}
    for r in run.ok:
        tc = r["time_costs"]
        key = (tc.get("total_time_cost"), tc.get("diffusion_time_cost"),
               tc.get("vae_decode_time_cost"))
        seen[key] = tc.get("total_time_cost", 0.0)
    return sum(seen.values())

