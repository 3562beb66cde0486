"""The port's span tracer (`acestep_torch/utils/trace.py`) over a tiny real
handler on the CPU: off it records nothing and the handler's `time_costs`
keep their keys; on, a facade render and a fused REST group give the
named span tree, each `time_costs` entry equal to its span's duration;
the ring stays bounded, the Chrome export loads, and /metrics exports the
always-on counters.
"""

import http.client
import json
import threading
import time
from http.server import ThreadingHTTPServer

import pytest
import torch

import acestep_torch.pipeline.handler as thandler
from acestep_torch import inference
from acestep_torch.config import DiTConfig, VAEConfig
from acestep_torch.models import dit_graphs
from acestep_torch.serving import server as tserver
from acestep_torch.utils import trace
from torch_graph_helpers import replay_eagerly

# the handler's time_costs keys, as a render without a planner gives them
HANDLER_COSTS = {"prepare_time_cost", "text_encode_time_cost",
                 "dispatch_prep_time_cost", "diffusion_time_cost",
                 "vae_decode_time_cost", "latent_fetch_time_cost",
                 "postprocess_time_cost", "audio_conversion_time",
                 "total_time_cost", "dit_total_time_cost"}
# the handler's time_costs keys read from one span each
SPAN_OF = {"prepare_time_cost": "render.prepare",
           "text_encode_time_cost": "render.text",
           "dispatch_prep_time_cost": "render.dispatch",
           "diffusion_time_cost": "diffusion",
           "vae_decode_time_cost": "vae",
           "latent_fetch_time_cost": "render.fetch",
           "postprocess_time_cost": "render.postprocess",
           "total_time_cost": "render"}
STAGES = ("render.prepare", "render.text", "render.dispatch", "diffusion",
          "vae", "render.fetch", "render.postprocess", "save")
STEPS = 8


@pytest.fixture(scope="module")
def handler():
    h = thandler.AceStepHandler(
        DiTConfig.tiny(fsq_dim=64), VAEConfig.tiny(decoder_input_channels=64),
        dtype=torch.float32, device="cpu", frame_bucket=8, min_frames=8,
        refer_frames=8)
    h.initialize_service(seed=0)
    return h


@pytest.fixture
def tracing():
    """The tracer on, with an empty ring; off and empty afterwards."""
    trace.drain()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.drain()


def _render(handler, out_dir, batch=2, seed=3):
    params = inference.GenerationParams(caption="a tiny song",
                                        lyrics="[inst]", duration=2.0,
                                        seed=seed, inference_steps=STEPS)
    config = inference.GenerationConfig(batch_size=batch,
                                        use_random_seed=False,
                                        audio_format="wav",
                                        output_dir=str(out_dir))
    res = inference.generate_music(handler, None, params, config)
    assert res.success, res.error
    return res


def _children(spans, parent):
    return [s for s in spans if s["parent"] == parent["id"]]


def _one(spans, name):
    got = [s for s in spans if s["name"] == name]
    assert len(got) == 1, (name, len(got))
    return got[0]


def test_off_records_nothing_and_keeps_the_keys(handler, tmp_path):
    trace.drain()
    assert not trace.enabled()
    res = handler.generate_music(["x"], ["[inst]"], audio_duration=2.0,
                                 batch_size=1, seeds=[1], infer_steps=STEPS,
                                 save_dir=str(tmp_path))
    assert set(res.time_costs) == HANDLER_COSTS
    facade = _render(handler, tmp_path)
    assert set(facade.extra_outputs["time_costs"]) == HANDLER_COSTS
    assert trace.drain() == []


def test_facade_render_gives_the_span_tree(handler, tmp_path, tracing):
    res = _render(handler, tmp_path, batch=2)
    spans = trace.drain()
    request = _one(spans, "request")
    assert request["parent"] is None and len(request["requests"]) == 1
    assert all(s["requests"] == request["requests"] for s in spans)
    render = _one(spans, "render")
    assert render["parent"] == request["id"]
    assert render["attrs"] == {"batch": 2, "frames": 50, "format": "wav"}
    top = [s["name"] for s in _children(spans, render)]
    assert [n for n in top if n != "save"] == list(STAGES[:-1])
    assert top.count("save") == 2
    diffusion = _one(spans, "diffusion")
    inner = [s["name"] for s in _children(spans, diffusion)]
    assert inner == ["dit.condition"] + ["dit.step"] * STEPS + \
        ["diffusion.sync"]
    vae = _one(spans, "vae")
    assert {s["name"] for s in _children(spans, vae)} == {"vae.decode",
                                                          "vae.transfer"}
    for save in (s for s in spans if s["name"] == "save"):
        assert [c["name"] for c in _children(spans, save)] == \
            ["save.encode", "save.write"]
    entries = [s for s in spans if s["name"] == "entry"]
    assert len(entries) == 2 and all(e["parent"] == request["id"]
                                     for e in entries)
    for s in spans:
        assert s["start"] <= s["end"]
        if s["parent"] is not None:
            p = next(q for q in spans if q["id"] == s["parent"])
            assert p["start"] <= s["start"] and s["end"] <= p["end"]

    # each time_costs entry is its span's duration
    costs = res.extra_outputs["time_costs"]
    dur = {s["name"]: s["end"] - s["start"] for s in spans}
    for key, name in SPAN_OF.items():
        if key != "total_time_cost":      # the facade's, below
            assert costs[key] == pytest.approx(dur[name], abs=1e-9), key
    saves = [s for s in spans if s["name"] == "save"]
    assert costs["audio_conversion_time"] == pytest.approx(
        sum(s["end"] - s["start"] for s in saves), abs=1e-9)
    assert saves[1]["start"] == saves[0]["end"]
    # the facade's total: from the request's start to the handler's return
    assert render["end"] - request["start"] <= costs["total_time_cost"] \
        <= min(e["start"] for e in entries) - request["start"]


def test_handler_time_costs_are_span_durations(handler, tmp_path, tracing):
    res = handler.generate_music(["x"], ["[inst]"], audio_duration=2.0,
                                 batch_size=1, seeds=[5], infer_steps=STEPS,
                                 save_dir=str(tmp_path))
    spans = trace.drain()
    dur = {s["name"]: s["end"] - s["start"] for s in spans}
    for key, name in SPAN_OF.items():
        assert res.time_costs[key] == pytest.approx(dur[name], abs=1e-9), key
    assert _one(spans, "render")["requests"] == []


def test_counters_and_stage_seconds_rise_untraced(handler, tmp_path):
    before = dict(trace.counters)
    stages = dict(trace.stage_seconds)
    _render(handler, tmp_path, batch=2)
    assert trace.counters["renders"] == before["renders"] + 1
    assert trace.counters["songs"] == before["songs"] + 2
    assert trace.counters["dit_steps"] == before["dit_steps"] + STEPS
    for name in STAGES:
        assert trace.stage_seconds[name] > stages.get(name, 0.0), name


def test_debug_switch_prints_the_stage_spans(handler, tmp_path, monkeypatch,
                                             capsys):
    monkeypatch.setenv("ACESTEP_DEBUG_DIT", "1")
    _render(handler, tmp_path, batch=1)
    err = capsys.readouterr().err
    assert err.count("[debug] dit.step: ") == STEPS
    assert err.count("[debug] dit.condition: ") == 1
    assert "[debug] vae" not in err and "[debug] render" not in err
    assert trace.drain() == []


def test_threads_never_share_a_parent(tracing):
    barrier = threading.Barrier(2)

    def work(i):
        with trace.span("outer", [f"t{i}"]):
            barrier.wait(timeout=10)
            for _ in range(50):
                with trace.span("inner"):
                    pass
            barrier.wait(timeout=10)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
        assert not th.is_alive()
    spans = trace.drain()
    outer = {s["id"]: s for s in spans if s["name"] == "outer"}
    assert len(outer) == 2 and all(s["parent"] is None
                                   for s in outer.values())
    inner = [s for s in spans if s["name"] == "inner"]
    assert len(inner) == 100
    for s in inner:
        parent = outer[s["parent"]]
        assert parent["thread"] == s["thread"]
        assert s["requests"] == parent["requests"]


def test_ring_holds_at_most_its_bound(tracing):
    for _ in range(trace.RING_SIZE + 10):
        with trace.span("x"):
            pass
    spans = trace.drain()
    assert len(spans) == trace.RING_SIZE
    assert trace.drain() == []


def test_chrome_export_loads(tmp_path, tracing):
    with trace.span("outer", ["r1"], batch=3):
        with trace.span("inner"):
            pass
    trace.record("queued", 1.0, 2.0, ["r2"])
    path = tmp_path / "trace.json"
    trace.write_chrome(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert sorted(e["name"] for e in events) == ["inner", "outer", "queued"]
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)
    inner = next(e for e in events if e["name"] == "inner")
    outer = next(e for e in events if e["name"] == "outer")
    assert inner["args"]["parent"] == outer["args"]["id"]
    assert outer["args"]["batch"] == 3 and inner["args"]["requests"] == ["r1"]


# ---------------------------------------------------------------------------
# the REST server
# ---------------------------------------------------------------------------


class _Server:
    def __init__(self, handler, root):
        self.state = tserver.AppState({"tiny": handler}, None,
                                      output_dir=str(root / "out"))
        bound = type("BoundHandler", (tserver._Handler,),
                     {"state": self.state})
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), bound)
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever,
                         kwargs={"poll_interval": 0.05}, daemon=True).start()

    def call(self, method, route, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=60)
        try:
            conn.request(method, route,
                         body=None if body is None else json.dumps(body),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    def release(self, seed):
        status, raw = self.call("POST", "/release_task", {
            "prompt": f"song {seed}", "lyrics": "[inst]",
            "audio_duration": 2.0, "inference_steps": STEPS, "seed": seed,
            "use_random_seed": False, "thinking": False,
            "audio_format": "wav"})
        assert status == 200
        return json.loads(raw)["data"]["task_id"]

    def wait(self, ids, timeout=120):
        end = time.monotonic() + timeout
        while time.monotonic() < end:
            _s, raw = self.call("POST", "/query_result",
                                {"task_id_list": ids})
            got = json.loads(raw)["data"]
            if all(g["status"] != 0 for g in got):
                assert all(g["status"] == 1 for g in got), got
                return
            time.sleep(0.05)
        raise AssertionError("jobs did not finish")

    def close(self):
        self.state.shutdown()
        self.httpd.shutdown()
        self.httpd.server_close()
        for th in self.state._workers:
            th.join(timeout=30)


@pytest.fixture
def server(handler, tmp_path):
    srv = _Server(handler, tmp_path)
    yield srv
    srv.close()


def test_fused_group_spans(server, tracing):
    """Two jobs queued before the worker starts render as one fused group:
    a serve.queue span each, one serve.render listing both, and the
    group's request, render and finish under it."""
    ids = [server.release(seed) for seed in (11, 12)]
    server.state.start_workers()
    server.wait(ids)
    spans = trace.drain()
    queued = sorted((s for s in spans if s["name"] == "serve.queue"),
                    key=lambda s: s["start"])
    assert [s["requests"] for s in queued] == [[i] for i in ids]
    assert all(s["start"] <= s["end"] for s in queued)
    group = _one(spans, "serve.render")
    assert group["requests"] == ids and group["attrs"]["jobs"] == 2
    # the head's wait ends at its claim, the drained job's inside the group
    assert queued[0]["end"] <= group["start"] <= queued[1]["end"] \
        <= group["end"]
    assert {s["name"] for s in _children(spans, group)} == {"request",
                                                            "serve.finish"}
    request = _one(spans, "request")
    assert request["requests"] == ids and request["attrs"]["songs"] == 2
    assert _one(spans, "render")["parent"] == request["id"]
    on_worker = [s for s in spans if s["name"] in
                 ("request", "render", "dit.step", "save", "entry")]
    assert all(s["requests"] == ids and s["thread"] == group["thread"]
               for s in on_worker)
    http = [s for s in spans if s["name"] == "serve.http"]
    assert {s["attrs"]["route"] for s in http} >= {"/release_task",
                                                   "/query_result"}
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        if s["parent"] is not None:
            assert by_id[s["parent"]]["thread"] == s["thread"]


def _metrics(server):
    status, raw = server.call("GET", "/metrics")
    assert status == 200
    out = {}
    for line in raw.decode().splitlines():
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            out[name] = float(value)
    return out


def test_metrics_export_the_counters(server, handler, tmp_path, monkeypatch):
    """The counters on /metrics; the VAE's plan steps down its ladder once
    when the first decode runs out of memory."""
    before = _metrics(server)
    for name in ("renders", "songs", "dit_steps", "vae_plan_retries",
                 "serve_group_fallbacks", "coalesced_jobs"):
        assert f"acestep_{name}_total" in before, name
    real = thandler.tiled_decode
    calls = []

    def oom_once(*a, **kw):
        calls.append(kw.get("parallel_windows"))
        if len(calls) == 1:
            raise RuntimeError("CUDA out of memory (planted)")
        return real(*a, **kw)

    monkeypatch.setattr(thandler, "tiled_decode", oom_once)
    _render(handler, tmp_path, batch=1)
    after = _metrics(server)
    assert len(calls) == 2 and calls[1] < calls[0]
    assert after["acestep_vae_plan_retries_total"] == \
        before["acestep_vae_plan_retries_total"] + 1
    assert after["acestep_renders_total"] == before["acestep_renders_total"] + 1
    assert after["acestep_dit_steps_total"] == \
        before["acestep_dit_steps_total"] + STEPS
    for stage in STAGES:
        assert after[f'acestep_stage_seconds_total{{stage="{stage}"}}'] > 0


def test_graph_counters_and_capture_span(server, handler, tmp_path,
                                         monkeypatch, tracing):
    """With the decoder's graph path engaged (each graph replayed by
    running its segment again: there is no card here), a render of a shape
    not seen captures in its first `dit.step`, under a `dit.capture` span,
    and replays the other steps; /metrics exports both counters."""
    replay_eagerly(monkeypatch)
    dit_graphs._graphs.pop(handler.model.decoder, None)
    before = _metrics(server)
    _render(handler, tmp_path, batch=3)
    after = _metrics(server)
    spans = trace.drain()
    capture = _one(spans, "dit.capture")
    step = next(s for s in spans if s["id"] == capture["parent"])
    assert step["name"] == "dit.step" and step["attrs"] == {"step": 0}
    # the render's 50 frames padded to the handler's bucket of 8
    assert capture["attrs"] == {"rows": 3, "frames": 56}
    assert step["start"] <= capture["start"] <= capture["end"] <= step["end"]
    grew = {name: after[f"acestep_{name}_total"]
            - before[f"acestep_{name}_total"]
            for name in ("dit_steps", "dit_graph_captures",
                         "dit_graph_replays")}
    assert grew == {"dit_steps": STEPS, "dit_graph_captures": 1,
                    "dit_graph_replays": STEPS - 1}


def test_failed_group_counts_a_fallback(server, monkeypatch):
    """A fused render that fails as a unit is re-run job by job, and
    acestep_serve_group_fallbacks_total counts it."""
    before = trace.counters["serve_group_fallbacks"]

    def failing(dit, llm, jobs):
        return [inference.GenerationResult(audios=[], success=False,
                                           error="planted")
                for _ in jobs]

    monkeypatch.setattr(tserver.inference, "generate_music_group", failing)
    ids = [server.release(seed) for seed in (21, 22)]
    server.state.start_workers()
    server.wait(ids)
    assert trace.counters["serve_group_fallbacks"] == before + 1
