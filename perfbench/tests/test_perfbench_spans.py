"""The readers of the port's own spans (`harness/spans.py`, the metrics
`host_stages_s`, `dit_step_host_ms` and `diffusion_idle_pct`) on
synthetic runs: a gap cut at span boundaries and put down to the
innermost span, a fused render's host stages shared over its songs, and
nothing read from a run that drained no program spans."""

import pytest

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
                       "stretch": stretch, "gaps": gaps})
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


@pytest.mark.parametrize("run", [
    _run(),                                   # no program spans drained
    _run([]),                                 # drained, none recorded
    _run(None, stretch=(0.0, 1.0), gaps=[(0.0, 1.0)]),
], ids=["absent", "empty", "traced-without-spans"])
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
    _assert_gaps(spans.gaps_of(tr, tr.summary))
    assert "open_span" not in vars(tr)      # the tracer is left as it was
    assert tr.summary()["idle_by_span"] == {"none": pytest.approx(3.8)}
    # launched at 0.9 (outside) and 1.95 (inside [1, 3]); no launch time:
    # not counted
    assert spans.launched_inside(EVENTS, K1_NAMES, [(1.0, 3.0)]) == 50.0
    assert spans.launched_inside(EVENTS, ("absent",), [(1.0, 3.0)]) is None


def test_the_traced_runs_tracer_in_the_harnesss_place(monkeypatch):
    """traced_spans.py puts its Tracer where run.py looks it up; its
    summary adds the stretch and the gaps and keeps the harness's own."""
    import traced_spans
    from harness import trace as htrace
    from harness.program import Recorder

    cls = traced_spans.span_tracer()
    monkeypatch.setattr(htrace, "Tracer", cls)
    tr = htrace.Tracer(Recorder(), "cpu", 0.0, 6.0)
    tr.t_start, tr.t_stop, tr.events = 0.0, 6.0, EVENTS
    out = tr.summary()
    assert out["stretch"] == (0.0, 6.0)
    _assert_gaps(out["gaps"])
    assert out["idle_by_span"] == {"none": pytest.approx(3.8)}
    assert cls.last is tr
