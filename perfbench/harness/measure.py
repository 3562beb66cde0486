"""A finished run as the metric readers see it, and the arithmetic they
share. Every time is a `time.monotonic()` reading or a duration."""

from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Dict, List, Optional

from harness import counts
from reference import text as ref_text


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

    @property
    def ok(self) -> List[dict]:
        return [r for r in self.records if r["ok"]]


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
    """The analytic FLOPs of one completed song (counts.request_flops at
    the song's own prompt buckets and frames)."""
    dit = run.conf["dit"]
    text = ref_text.caption_prompt(rec["caption"], rec["duration_s"])
    lyric = ref_text.lyric_prompt(rec["lyrics"], rec["language"])
    return counts.request_flops(
        dit, run.conf["vae"], frames=int(rec["duration_s"] * 25),
        steps=rec["steps"],
        text_len=ref_text.padded_len(len(text.encode()), ref_text.TEXT_MAX_LEN),
        lyric_len=ref_text.padded_len(len(lyric.encode()),
                                      ref_text.LYRIC_MAX_LEN),
        refer_frames=dit["timbre_fix_frame"])


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

