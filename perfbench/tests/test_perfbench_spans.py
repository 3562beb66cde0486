"""The readers of the port's own spans (`harness/spans.py`, the metrics
`host_stages_s`, `dit_step_host_ms` and `diffusion_idle_pct`) on
synthetic runs: a gap cut at span boundaries and put down to the
innermost span, a fused render's host stages shared over its songs, and
nothing read from a run that drained no program spans or whose ring
dropped some; and the traced path of `run.py`, which turns the port's
tracer on over the window of a `--trace 1` run only."""

import pytest
import torch
from conftest import tiny_spec

import run as run_py
from harness import measure, spans
from harness.spec import reader
from harness.trace import K1_NAMES


def _span(sid, name, start, end, parent=None, thread=1, requests=("r",)):
    return {"id": sid, "name": name, "start": start, "end": end,
            "parent": parent, "thread": thread, "requests": list(requests),
            "attrs": {}}


def _run(program_spans=None, stretch=None, gaps=None):
    run = measure.Run(conf={}, w0=0.0, records=[], setup_s=1.0,
                      memory_peak_bytes=0, card="cpu",
                      trace=None if stretch is None else
                      {"busy_s": 1.0, "window_s": stretch[1] - stretch[0],
                       "stretch": stretch, "gaps": gaps, "complete": True})
    if program_spans is not None:
        run.program_spans = program_spans
    return run


def _read(name, run):
    return reader(name).read(run)


# a solo render (request 1, one song) and a fused render of two songs
# (request 20) on thread 1; a poll on thread 2
SPANS = [
    _span(1, "request", 0.0, 10.0),
    _span(2, "render", 0.0, 9.0, 1),
    _span(3, "render.prepare", 0.0, 0.5, 2),
    _span(4, "diffusion", 1.0, 5.0, 2),
    _span(5, "dit.step", 1.0, 2.0, 4),
    _span(6, "dit.step", 2.0, 3.0, 4),
    _span(7, "vae", 5.0, 8.0, 2),
    _span(8, "render.postprocess", 8.0, 8.5, 2),
    _span(9, "entry", 9.0, 9.25, 1),
    _span(20, "request", 12.0, 20.0, requests=("a", "b")),
    _span(21, "render", 12.0, 19.0, 20, requests=("a", "b")),
    _span(22, "render.text", 12.0, 13.0, 21, requests=("a", "b")),
    _span(23, "dit.step", 13.0, 13.5, 21, requests=("a", "b")),
    _span(24, "entry", 19.0, 19.5, 20, requests=("a", "b")),
    _span(25, "entry", 19.5, 20.0, 20, requests=("a", "b")),
    _span(30, "serve.http", 2.5, 3.5, thread=2),
]


def test_host_stages_shared_over_a_fused_renders_songs():
    got = spans.per_song_host_stages(SPANS)
    # solo: prepare 0.5 + postprocess 0.5 + entry 0.25; fused: text 1.0 +
    # two entries 0.5 each, over its two songs
    assert sorted(got) == pytest.approx([1.0, 1.0, 1.25])
    assert _read("host_stages_s.serve", _run(SPANS)) == pytest.approx(1.0)


def test_dit_step_host_ms_is_the_median_step():
    assert _read("dit_step_host_ms.long", _run(SPANS)) == pytest.approx(1000.0)


@pytest.mark.parametrize("gap,want", [
    ((0.25, 3.0), {"render.prepare": 0.25, "render": 0.5,
                   "dit.step": 2.0}),                 # cut at four bounds
    ((8.25, 11.0), {"render.postprocess": 0.25, "render": 0.5,
                    "request": 0.75, "entry": 0.25, "none": 1.0}),
    ((4.5, 4.75), {"diffusion": 0.25}),               # inside one span
])
def test_a_gap_is_cut_at_span_boundaries(gap, want):
    got = spans.split_idle((0.0, 21.0), [gap], SPANS,
                           spans.rendering_threads(SPANS))
    assert got == pytest.approx(want)


def test_spans_of_other_threads_name_no_idle():
    got = spans.split_idle((0.0, 21.0), [(2.5, 3.5)], SPANS, {2})
    assert got == pytest.approx({"serve.http": 1.0})
    got = spans.split_idle((0.0, 21.0), [(2.5, 3.5)], SPANS, {1})
    assert got == pytest.approx({"dit.step": 0.5, "diffusion": 0.5})


def test_diffusion_idle_within_the_stretch():
    gaps = [(0.5, 1.5), (2.0, 3.0), (4.0, 6.0)]
    run = _run(SPANS, stretch=(2.0, 21.0), gaps=gaps)
    idle, inside, http = spans.diffusion_idle((2.0, 21.0), gaps, SPANS)
    # diffusion [1, 5] clipped to [2, 5]; idle in it [2, 3] and [4, 5]
    assert (idle, inside, http) == pytest.approx((2.0, 3.0, 0.5))
    assert _read("diffusion_idle_pct.serve", run) == pytest.approx(
        100 * 2 / 3)


def _dropped():
    run = _run(SPANS, stretch=(0.0, 21.0), gaps=[(0.5, 1.5)])
    run.spans_dropped = 3
    return run


@pytest.mark.parametrize("run", [
    _run(),                                   # no program spans drained
    _run([]),                                 # drained, none recorded
    _run(None, stretch=(0.0, 1.0), gaps=[(0.0, 1.0)]),
    _dropped(),                               # the ring dropped spans
], ids=["absent", "empty", "traced-without-spans", "ring-dropped"])
def test_nothing_read_without_program_spans(run):
    for name in ("host_stages_s.serve", "dit_step_host_ms.long",
                 "diffusion_idle_pct.long"):
        assert _read(name, run) is None, name


def test_diffusion_idle_needs_the_traced_stretch():
    assert _read("diffusion_idle_pct.serve", _run(SPANS)) is None
    assert _read("host_stages_s.serve", _run(SPANS)) is not None


EVENTS = [("flash_fwd_kernel", 1.0, 1.5, 0.9),
          ("flash_fwd_kernel", 2.0, 2.2, 1.95),
          ("snake_unit_kernel", 3.0, 4.0, 2.9),
          ("flash_fwd_kernel", 5.0, 5.5, None)]
GAPS = [(0.0, 1.0), (1.5, 2.0), (2.2, 3.0), (4.0, 5.0), (5.5, 6.0)]


def _assert_gaps(got):
    assert len(got) == len(GAPS)
    for g, w in zip(got, GAPS):
        assert g == pytest.approx(w, abs=1e-12)


def test_gaps_from_the_summary_and_kernels_launched_inside():
    from harness.program import Recorder
    from harness.trace import Tracer

    tr = Tracer(Recorder(), "cpu", 0.0, 6.0)
    tr.t_start, tr.t_stop, tr.events = 0.0, 6.0, EVENTS
    out = tr.summary()
    assert out["stretch"] == (0.0, 6.0) and out["complete"] is True
    _assert_gaps(out["gaps"])
    assert out["idle_by_span"] == {"none": pytest.approx(3.8)}
    # launched at 0.9 (outside) and 1.95 (inside [1, 3]); no launch time:
    # not counted
    assert spans.launched_inside(EVENTS, K1_NAMES, [(1.0, 3.0)]) == 50.0
    assert spans.launched_inside(EVENTS, ("absent",), [(1.0, 3.0)]) is None


@pytest.mark.parametrize("trace", [True, False], ids=["traced", "untraced"])
def test_the_traced_runs_tracer_in_the_harnesss_place(trace, monkeypatch):
    """run.py's own path, a tiny REST run on the CPU: with `--trace 1` the
    port's tracer is on over the window alone, its spans and the change in
    its counters are the run's, and the span readers read them; with
    `--trace 0` the tracer stays off and nothing of it is read."""
    from acestep_torch.utils import trace as ptrace
    from harness import drivers

    seen = []
    window = drivers.Rest.window

    def spy(self, *a, **kw):
        seen.append(ptrace.enabled())
        out = window(self, *a, **kw)
        seen.append(ptrace.enabled())
        return out

    monkeypatch.setattr(drivers.Rest, "window", spy)
    spec = tiny_spec("turbo-rest-30s")
    run, metrics, checks = run_py.execute(spec, 2**31 + 4321, 3.0, trace,
                                          torch.device("cpu"))
    assert run_py.verdict(checks, spec.limits)[0] is True, checks
    assert seen == [trace, trace] and not ptrace.enabled()
    if not trace:
        assert run.program_spans is None and run.counters is None
        return
    names = {s["name"] for s in run.program_spans}
    assert {"request", "render", "diffusion", "dit.step", "vae",
            "serve.http"} <= names
    assert all(s["start"] >= run.w0 - 0.2 for s in run.program_spans)
    assert run.spans_dropped == 0
    steps = sum(r["steps"] for r in run.ok if r["coalesced"] <= 1)
    assert run.counters["dit_steps"] >= steps > 0
    assert run.counters["songs"] >= len(run.ok)
    assert metrics["host_stages_s.serve"]["value"] > 0
    assert metrics["dit_step_host_ms.serve"]["value"] > 0
    assert metrics["dit_graph_hit_pct.serve"]["value"] == 0.0  # eager CPU
    # no device trace on the CPU: nothing read from it
    assert run.trace is None and "diffusion_idle_pct.serve" not in metrics


@pytest.mark.parametrize("spans_made,dropped", [(3, 0), (4, 0), (10, 6)])
def test_the_port_ring_counts_what_it_dropped(spans_made, dropped,
                                             monkeypatch):
    """PortTrace over a ring of 4: every span opened between `open()` and
    `close()` is drained or counted as dropped, and the counters' change
    over the window is the run's."""
    import collections

    from acestep_torch.utils import trace as ptrace
    from harness.program import PortTrace

    monkeypatch.setattr(ptrace, "_ring", collections.deque(maxlen=4))
    monkeypatch.setattr(ptrace, "RING_SIZE", 4)
    ptrace.begin("before").end()            # tracer off: not recorded
    port = PortTrace()
    port.open()
    for i in range(spans_made):
        with ptrace.span(f"s{i}"):
            ptrace.count("dit_steps")
    got, lost, counters = port.close()
    assert not ptrace.enabled()
    assert [s["name"] for s in got] == [f"s{i}" for i in range(spans_made)
                                        ][-4:]
    assert lost == dropped and counters["dit_steps"] == spans_made
    assert counters["renders"] == 0
