"""The traced sub-window of a `--trace 1` run: torch.profiler (CUPTI) over
a stretch of the measured window fixed by the traffic mix, reduced to
device busy time, idle gaps named by the benchmark's host spans, device
time by kernel name, and the K1 / K4 kernels paired with the shapes their
launchers were called with: the profiler links each kernel to the runtime
call that launched it, and the launch goes to the last call the launcher
logged before it.

Profiler timestamps are wall-clock nanoseconds; a marker kernel launched
at a known host `time.monotonic()` maps them onto the monotonic clock
that every span, request time and logged call uses.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from harness import program

K1_NAMES = ("flash_fwd_kernel",)
K4_NAMES = ("snake_conv_small_kernel", "snake_unit_kernel")
SPAN_ORDER = ("save", "vae", "diffusion", "plan")   # innermost first


class Tracer:
    """Profiles [w0 + a, w0 + b]. `run` blocks until b and is called from
    the main thread: CUPTI's client is registered there, and a profiler
    started from another thread records nothing. A stretch whose trace
    lacks the device events of more than 1% of the launches it recorded
    (CUPTI drops kernel records now and then, once all of them) is traced
    again over the next stretch of the same length, while one fits in the
    window's `seconds`; a last stretch that still lacks them is marked
    not `complete` in the summary, and nothing is read from its device
    events."""

    MAX_UNMATCHED = 0.01

    def __init__(self, rec: program.Recorder, device, a: float, b: float,
                 seconds: float = float("inf")):
        self.rec, self.device, self.a, self.b = rec, device, a, b
        self.seconds = seconds
        self.t_start = self.t_stop = None
        self.launches = None
        self.events: List[tuple] = []
        self.error: Optional[str] = None
        self.kinds: Dict[str, int] = {}     # profiler events by device
        self.unmatched: List[tuple] = []    # (launches, without a kernel)

    @staticmethod
    def _profile():
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def prepare(self) -> None:
        """Start and stop the profiler once during set-up: CUPTI's first
        start takes seconds, which would eat the traced stretch."""
        prof = self._profile()
        prof.start()
        torch.ones(1, device=self.device).add_(1)
        program.synchronize(self.device)
        prof.stop()

    def run(self, w0: float) -> None:
        span = self.b - self.a
        a = self.a
        try:
            while True:
                self._trace(w0 + a, span)
                n, lost = self.unmatched[-1]
                a += span + 1.0
                if lost <= self.MAX_UNMATCHED * n or a + span > self.seconds:
                    break
                self.events, self.kinds = [], {}
                self.rec.k1_calls.clear()
                self.rec.k4_calls.clear()
        except Exception as e:  # reported with the run; no metric is read
            self.error = repr(e)
            self.rec.logging_kernels = False

    def _trace(self, start: float, span: float) -> None:
        time.sleep(max(0.0, start - time.monotonic()))
        before = program.set_kernel_logging(self.rec, True)
        prof = self._profile()
        prof.start()
        try:
            # a kernel launched at a known host time: its launch, as the
            # profiler stamps it, maps the profiler's clock onto ours
            mark = time.monotonic()
            torch.cuda._sleep(1)
            self.t_start = mark
            time.sleep(span)
            program.synchronize(self.device)
            self.t_stop = time.monotonic()
        finally:
            prof.stop()
        after = program.set_kernel_logging(self.rec, False)
        self.launches = {k: after[k] - before[k] for k in after}
        self._collect(prof, mark)

    def _collect(self, prof, mark: float) -> None:
        """Device events as (name, start, end, host time of the launch) on
        the monotonic clock. The profiler links each kernel to its launch
        by a correlation id; the marker kernel's launch gives the offset
        between the profiler's clock and the host's."""
        evs = prof.profiler.kineto_results.events()
        cuda = torch.autograd.DeviceType.CUDA
        launches = {}
        for e in evs:
            kind = str(e.device_type())
            self.kinds[kind] = self.kinds.get(kind, 0) + 1
            if e.device_type() != cuda and "Launch" in e.name():
                launches[e.correlation_id()] = e.start_ns() * 1e-9
        kernels = {e.correlation_id() for e in evs if e.device_type() == cuda}
        self.unmatched.append((len(launches),
                               sum(1 for c in launches if c not in kernels)))
        spin = next((launches.get(e.correlation_id()) for e in evs
                     if e.device_type() == cuda and "spin_kernel" in e.name()),
                    None)
        offset = mark - spin if spin else time.monotonic() - time.time()
        for e in evs:
            if e.device_type() != cuda:
                continue
            t0 = e.start_ns() * 1e-9 + offset
            launch = launches.get(e.correlation_id())
            self.events.append((e.name(), t0, t0 + e.duration_ns() * 1e-9,
                                None if launch is None else launch + offset))
        self.events.sort(key=lambda x: x[1])

    # -------------------------------------------------------- reduction

    def summary(self) -> Optional[dict]:
        """busy_s, window_s, device time by kernel name, the stretch
        (start, end) and its idle intervals (`gaps`), idle seconds by the
        host span open during each gap, the K1 / K4 calls paired with their
        kernels, and whether the stretch kept the kernels of all but
        MAX_UNMATCHED of its launches (`complete`; `lost`: its launches
        without a kernel, of all its launches); None when the trace holds
        no device operation."""
        if self.error or not self.events or self.t_start is None:
            return None
        lo, hi = self.t_start, self.t_stop
        merged = []
        for _name, s, e, _launch in self.events:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        busy = sum(e - s for s, e in merged)
        gaps, cursor = [], lo
        for s, e in merged:
            if s > cursor:
                gaps.append((cursor, s))
            cursor = max(cursor, e)
        if hi > cursor:
            gaps.append((cursor, hi))
        by_name: Dict[str, float] = {}
        for name, s, e, _launch in self.events:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
        idle: Dict[str, float] = {}
        for s, e in gaps:
            label = self.open_span((s + e) / 2)
            idle[label] = idle.get(label, 0.0) + (e - s)
        n, lost = self.unmatched[-1] if self.unmatched else (0, 0)
        return {"busy_s": busy, "window_s": hi - lo, "by_name": by_name,
                "stretch": (lo, hi), "gaps": gaps,
                "complete": lost <= self.MAX_UNMATCHED * n,
                "lost": (lost, n),
                "idle_by_span": idle, "launches": self.launches,
                "k1": self.matched(K1_NAMES, self.rec.k1_calls, lambda s: 1),
                "k4": self.matched(K4_NAMES, self.rec.k4_calls,
                                   lambda s: 1 if s[2] <= 64 else 3)}

    def open_span(self, t: float) -> str:
        open_ = {name for name, s, e, _tid in self.rec.spans if s <= t <= e}
        return next((n for n in SPAN_ORDER if n in open_), "none")

    def matched(self, names, calls, per_call) -> dict:
        """Each traced kernel of `names` given to the logged call that
        launched it (the last call logged before its launch); the calls
        whose `per_call(shape)` kernels were all traced, with their summed
        device time: {"pairs": [(shape, seconds)], "calls", "kernels"}."""
        import bisect

        times = [t for t, _shape in calls]
        got: Dict[int, list] = {}
        kernels = 0
        for name, s, e, launch in self.events:
            if not any(k in name for k in names):
                continue
            kernels += 1
            i = bisect.bisect_right(times, launch) - 1 if launch else -1
            if i >= 0:
                got.setdefault(i, []).append(e - s)
        pairs = [(calls[i][1], sum(d)) for i, d in sorted(got.items())
                 if len(d) == per_call(calls[i][1])]
        return {"pairs": pairs, "calls": len(calls), "kernels": kernels}
