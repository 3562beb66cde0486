"""The port's span tracer and counters.

A span is one stage of the program's work on one thread: its name, its
start and end on `time.monotonic()` (the clock a device trace is mapped
onto), its own id, the id of the span open on the same thread when it
began (a `contextvars` stack, so nesting follows the thread), the request
ids it belongs to (its parent's unless given), the thread, and a few
attributes. While tracing is on, every span that closes goes to one ring
of the last `RING_SIZE` records; off, a span measures its own duration
(what `end()` returns, which the handler's `time_costs` read) and records
nothing.

`enable()`, `disable()` and `drain()` control the tracer. The environment
variable `ACESTEP_TRACE=<path>` turns it on at import and writes the ring
as Chrome trace-event JSON to <path> at exit (open it in Perfetto or
chrome://tracing). `ACESTEP_DEBUG=1` prints every span that closes as
`[debug] name: x ms` on stderr; `ACESTEP_DEBUG_<SUBSYSTEM>=1` those whose
name starts with that subsystem (`dit.step` belongs to `dit`). The debug
switches are read from the environment as each span opens.

Counters (`counters`, `stage_seconds`) are always on; the REST server's
/metrics exports them.
"""

from __future__ import annotations

import atexit
import collections
import contextvars
import functools
import itertools
import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence

RING_SIZE = 65536

_ring: "collections.deque" = collections.deque(maxlen=RING_SIZE)
_enabled = False
_ids = itertools.count(1)
_request_ids = itertools.count(1)
_current: "contextvars.ContextVar[Optional[Span]]" = contextvars.ContextVar(
    "acestep_trace_span", default=None)

# always-on counters, exported by /metrics as acestep_<name>_total
counters: Dict[str, int] = dict.fromkeys(
    ("renders", "songs", "dit_steps", "dit_graph_captures",
     "dit_graph_replays", "vae_plan_retries", "serve_group_fallbacks"), 0)
# seconds by the handler's top-level render stage (spans opened with
# stage=True), exported as acestep_stage_seconds_total{stage=...}
stage_seconds: Dict[str, float] = {}
_count_lock = threading.Lock()


def debug_enabled(subsystem: str = "") -> bool:
    """The debug switch of `subsystem`, read from the environment now."""
    if os.environ.get("ACESTEP_DEBUG"):
        return True
    if subsystem:
        return bool(os.environ.get(f"ACESTEP_DEBUG_{subsystem.upper()}"))
    return False


class Span:
    """One stage on one thread: `with Span(name) as sp:` or
    `sp = begin(name)` ... `sp.end()`. `end()` returns the seconds the
    span lasted, traced or not. `stage=True` adds them to
    `stage_seconds[name]`. Its debug switch is its `subsystem`'s, by
    default the first word of its name."""

    __slots__ = ("name", "requests", "attrs", "stage", "subsystem", "t0",
                 "t1", "id", "parent", "_prev", "_record", "_print")

    def __init__(self, name: str, requests: Optional[Sequence[str]] = None,
                 stage: bool = False, **attrs):
        self.name = name
        self.requests = requests
        self.attrs = attrs
        self.stage = stage
        self.subsystem = name.split(".", 1)[0]
        self.t0 = self.t1 = None
        self.id = self.parent = self._prev = None
        self._record = self._print = False

    def start(self, t0: Optional[float] = None) -> "Span":
        """Open the span, at `t0` when given (a monotonic reading)."""
        self._record = _enabled
        self._print = debug_enabled(self.subsystem)
        if self._record:
            prev = self._prev = _current.get()
            self.id = next(_ids)
            if prev is not None:
                self.parent = prev.id
                if self.requests is None:
                    self.requests = prev.requests
            _current.set(self)
        self.t0 = time.monotonic() if t0 is None else t0
        return self

    def end(self) -> float:
        self.t1 = time.monotonic()
        seconds = self.t1 - self.t0
        if self._record:
            # the thread's open span is this one's parent again, whatever
            # spans inside it were left open by an exception
            _current.set(self._prev)
            _ring.append((self.name, self.t0, self.t1, self.id, self.parent,
                          tuple(self.requests or ()), threading.get_ident(),
                          self.attrs))
        if self.stage:
            with _count_lock:
                stage_seconds[self.name] = (stage_seconds.get(self.name, 0.0)
                                            + seconds)
        if self._print:
            print(f"[debug] {self.name}: {seconds * 1000:.1f} ms",
                  file=sys.stderr, flush=True)
        return seconds

    @property
    def recording(self) -> bool:
        return self._record

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.end()
        return False


span = Span


def begin(name: str, requests: Optional[Sequence[str]] = None,
          stage: bool = False, t0: Optional[float] = None, **attrs) -> Span:
    """A started span (closed by its `end()`)."""
    return Span(name, requests, stage, **attrs).start(t0)


def record(name: str, t0: float, t1: float, requests: Sequence[str] = (),
           thread: Optional[int] = None, **attrs) -> None:
    """A span whose ends were stamped elsewhere (a job's wait in a queue,
    begun on one thread and ended on another): no parent, on `thread`
    (the one it began on; by default this one)."""
    if _enabled:
        _ring.append((name, t0, t1, next(_ids), None, tuple(requests),
                      threading.get_ident() if thread is None else thread,
                      attrs))


def scoped(fn):
    """`fn` leaves its thread's open span as it found it, even when it
    raises with spans of its own still open."""
    @functools.wraps(fn)
    def wrapper(*a, **kw):
        prev = _current.get()
        try:
            return fn(*a, **kw)
        finally:
            _current.set(prev)
    return wrapper


def new_request_id() -> str:
    return f"req-{next(_request_ids)}"


def count(name: str, n: int = 1) -> None:
    with _count_lock:
        counters[name] += n


def enabled() -> bool:
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def drain() -> List[dict]:
    """Take every record out of the ring, oldest first, each a dict of
    name, start, end, id, parent, requests, thread and attrs."""
    out = []
    while True:
        try:
            name, t0, t1, sid, parent, reqs, tid, attrs = _ring.popleft()
        except IndexError:
            return out
        out.append({"name": name, "start": t0, "end": t1, "id": sid,
                    "parent": parent, "requests": list(reqs), "thread": tid,
                    "attrs": dict(attrs)})


def write_chrome(path: str) -> None:
    """Drain the ring into `path` as Chrome trace-event JSON: one complete
    ("X") event a span, in microseconds of the monotonic clock."""
    pid = os.getpid()
    events = [{"name": s["name"], "ph": "X", "ts": s["start"] * 1e6,
               "dur": (s["end"] - s["start"]) * 1e6, "pid": pid,
               "tid": s["thread"],
               "args": dict(s["attrs"], id=s["id"], parent=s["parent"],
                            requests=s["requests"])} for s in drain()]
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f,
                  default=str)


if os.environ.get("ACESTEP_TRACE"):
    enable()
    atexit.register(write_chrome, os.environ["ACESTEP_TRACE"])
