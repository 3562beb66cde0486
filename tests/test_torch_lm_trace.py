"""The planner's spans and counters (`llm/generator.py`, `llm/handler.py`,
`utils/trace.py`) over a tiny seeded planner and DiT on the CPU: a
thinking facade call at batch 2 with `allow_lm_batch` opens `lm.prefill`,
`lm.cot`, `lm.fsm` and `lm.codes` under its `plan` span, with their rows,
tokens and steps; with the decode step's graph path engaged (each graph
replayed by running its step again: there is no card here) the counters
move by the plan's steps, captures, replays and tokens; /metrics exports
them; a facade call with thinking off opens none and moves none.
"""

import http.client
import threading
import types
from http.server import ThreadingHTTPServer

import pytest
import torch

import acestep_torch.pipeline.handler as thandler
from acestep_torch import inference
from acestep_torch.config import DiTConfig, VAEConfig
from acestep_torch.llm import generator as tgen
from acestep_torch.llm.handler import LLMHandler
from acestep_torch.serving import server as tserver
from acestep_torch.utils import trace

LM_SPANS = ("lm.prefill", "lm.cot", "lm.fsm", "lm.codes", "lm.capture")
LM_COUNTERS = ("lm_decode_steps", "lm_graph_captures", "lm_graph_replays",
               "lm_cot_tokens", "lm_code_tokens")
DURATION = 2.0
# the CoT's duration field clamps to the schema's floor of 10 s: 50 codes
N_CODES = 50


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def handler():
    h = thandler.AceStepHandler(
        DiTConfig.tiny(fsq_dim=64), VAEConfig.tiny(decoder_input_channels=64),
        dtype=torch.float32, device="cpu", frame_bucket=8, min_frames=8,
        refer_frames=8)
    h.initialize_service(seed=0)
    return h


@pytest.fixture(scope="module")
def llm():
    lm = LLMHandler(dtype=torch.float32, device="cpu")
    lm.initialize(num_fallback_codes=32, max_duration=60, seed=1)
    return lm


@pytest.fixture
def tracing():
    trace.drain()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.drain()


@pytest.fixture
def graphs(llm, monkeypatch):
    """The engine's graph path on the CPU: a capture runs its step once
    and a replay runs it again into the static output."""
    def capture(body, dev):
        out = body()
        return types.SimpleNamespace(replay=lambda: out.copy_(body())), out

    monkeypatch.setattr(tgen._GraphStep, "_capture", staticmethod(capture))
    monkeypatch.setattr(llm.engine, "cuda_graphs", True)
    monkeypatch.setattr(llm.engine, "_graphs", {})
    monkeypatch.setattr(llm.engine, "_arena", [])
    monkeypatch.setattr(llm.engine, "_roles", {})
    monkeypatch.setattr(llm.engine, "_cross_prefix", None)


def _think(handler, llm, out_dir, thinking=True, **params):
    p = inference.GenerationParams(caption="a tiny song", lyrics="la la",
                                   duration=DURATION, seed=5,
                                   inference_steps=2, thinking=thinking,
                                   **params)
    c = inference.GenerationConfig(batch_size=2, allow_lm_batch=True,
                                   use_random_seed=False, audio_format="wav",
                                   output_dir=str(out_dir))
    res = inference.generate_music(handler, llm, p, c)
    assert res.success, res.error
    return res


def _ancestors(spans, s):
    by_id = {x["id"]: x for x in spans}
    out = []
    while s["parent"] is not None:
        s = by_id[s["parent"]]
        out.append(s["name"])
    return out


def test_planner_spans_nest_under_plan(handler, llm, tmp_path, tracing):
    _think(handler, llm, tmp_path)
    spans = trace.drain()
    got = {n: [s for s in spans if s["name"] == n] for n in LM_SPANS}
    assert len(got["lm.prefill"]) == 2           # CoT, then codes
    assert len(got["lm.cot"]) == len(got["lm.codes"]) == 1
    assert len(got["lm.fsm"]) == 1
    for name in LM_SPANS:
        for s in got[name]:
            assert "plan" in _ancestors(spans, s), name
    cot, codes = got["lm.cot"][0], got["lm.codes"][0]
    # two songs, each a conditional and an unconditional row
    assert cot["attrs"]["rows"] == codes["attrs"]["rows"] == 4
    assert cot["attrs"]["songs"] == codes["attrs"]["songs"] == 2
    assert 0 < cot["attrs"]["tokens"] <= 2 * cot["attrs"]["steps"]
    assert codes["attrs"]["steps"] == N_CODES
    assert codes["attrs"]["window"] == 32 and codes["attrs"]["kv_tokens"] > 0
    for p in got["lm.prefill"]:
        assert p["attrs"]["rows"] == 4 and p["attrs"]["tokens"] > 0
    # phase 2 extends phase 1's prompts: its prefix comes from the cache
    assert got["lm.prefill"][1]["attrs"]["reused"] > 0
    fsm = got["lm.fsm"][0]
    assert fsm["attrs"] == {"rows": 2, "tokens": cot["attrs"]["tokens"]}
    assert cot["end"] <= fsm["start"] <= fsm["end"] <= codes["start"]


def test_counters_move_by_the_plan(handler, llm, tmp_path, graphs, tracing):
    before = {k: trace.counters[k] for k in LM_COUNTERS}
    res = _think(handler, llm, tmp_path)
    grew = {k: trace.counters[k] - before[k] for k in LM_COUNTERS}
    spans = trace.drain()
    cot = next(s for s in spans if s["name"] == "lm.cot")
    captures = [s for s in spans if s["name"] == "lm.capture"]
    n_codes = N_CODES
    steps = cot["attrs"]["steps"] + n_codes
    assert grew == {"lm_decode_steps": steps,
                    "lm_graph_captures": len(captures),
                    "lm_graph_replays": steps,
                    "lm_cot_tokens": cot["attrs"]["tokens"],
                    "lm_code_tokens": 2 * n_codes}
    # one capture for the CoT's view, one a rung of the codes' ladder
    assert len(captures) >= 2
    assert all(c["attrs"]["rows"] == 4 for c in captures)
    assert [len(c.split("|>")) - 1 for c in
            res.extra_outputs["audio_codes"]] == [n_codes, n_codes]
    # the last CoT's cache is held for the next request's prefix, so the
    # next CoT takes a second buffer (and captures its graph); from then
    # on the two alternate and the same shapes capture nothing
    _think(handler, llm, tmp_path)
    before = dict(trace.counters)
    _think(handler, llm, tmp_path)
    assert trace.counters["lm_graph_captures"] == before["lm_graph_captures"]
    assert trace.counters["lm_graph_replays"] > before["lm_graph_replays"]


def test_metrics_export_the_planner_counters(handler, llm, tmp_path):
    state = tserver.AppState({"tiny": handler}, llm,
                             output_dir=str(tmp_path / "out"))
    bound = type("BoundHandler", (tserver._Handler,), {"state": state})
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), bound)
    threading.Thread(target=httpd.serve_forever,
                     kwargs={"poll_interval": 0.05}, daemon=True).start()

    def metrics():
        conn = http.client.HTTPConnection("127.0.0.1",
                                          httpd.server_address[1], timeout=60)
        try:
            conn.request("GET", "/metrics")
            resp = conn.getresponse()
            assert resp.status == 200
            raw = resp.read().decode()
        finally:
            conn.close()
        return {line.rsplit(" ", 1)[0]: float(line.rsplit(" ", 1)[1])
                for line in raw.splitlines()
                if line and not line.startswith("#")}

    try:
        before = metrics()
        _think(handler, llm, tmp_path)
        after = metrics()
    finally:
        state.shutdown()
        httpd.shutdown()
        httpd.server_close()
    for name in LM_COUNTERS:
        key = f"acestep_{name}_total"
        assert key in before, name
    assert after["acestep_lm_code_tokens_total"] == \
        before["acestep_lm_code_tokens_total"] + 2 * N_CODES
    assert after["acestep_lm_decode_steps_total"] > \
        before["acestep_lm_decode_steps_total"]


@pytest.mark.parametrize("planner", ["none", "cot_off"])
def test_no_thinking_opens_no_planner_span(handler, llm, tmp_path, tracing,
                                           planner):
    """thinking=False as the REST and long cells run it (no planner), and
    with a planner attached but every CoT knob off: no `lm.*` span, no
    planner counter moves."""
    before = {k: trace.counters[k] for k in LM_COUNTERS}
    if planner == "none":
        _think(handler, None, tmp_path, thinking=False)
    else:
        _think(handler, llm, tmp_path, thinking=False, use_cot_metas=False,
               use_cot_caption=False, use_cot_language=False)
    spans = trace.drain()
    assert not [s for s in spans if s["name"].startswith("lm.")]
    assert not [s for s in spans if s["name"] == "plan"]
    assert {k: trace.counters[k] for k in LM_COUNTERS} == before
