"""The port's REST server against the JAX package's, on the CPU.

One scripted HTTP session runs against each server, each over the same
deterministic fake DiT handler (written to that package's
`GenerationResult`); the envelopes must be equal once task ids,
timestamps, timings and absolute paths are replaced by markers (and the
/health service name, which names the package). Request mapping
(`request_to_params`) and the coalescing key are equal on both sides over
generated request bodies, the coalescing queue behaves the same, and every
/v1/dataset/* route answers as the JAX server's does. Exact equality
throughout: nothing here computes in floating point.
"""

import base64
import http.client
import io
import json
import os
import random
import re
import threading
import time
import wave

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import acestep_tpu.pipeline.handler as jhandler
import acestep_tpu.serving.server as jserver
import acestep_tpu.utils.audio as jaudio
import acestep_torch.pipeline.handler as thandler
import acestep_torch.serving.server as tserver
import acestep_torch.utils.audio as taudio
from acestep_tpu.serving.schemas import GenerateMusicRequest as JReq
from acestep_torch.serving.schemas import GenerateMusicRequest as TReq
from torch_parity import port_safe_root  # noqa: F401

SIDES = {
    "jax": (jserver, jhandler.GenerationResult, jaudio.save_wav, JReq),
    "torch": (tserver, thandler.GenerationResult, taudio.save_wav, TReq),
}
MODEL = "acestep-v15-turbo"


class FakeDiTHandler:
    """The handler surface the server uses: writes a silent 0.1 s wav per
    song, named by call count, and records each call. `gate`, when set,
    holds each render until released (the cancel part of the session)."""

    def __init__(self, output_dir, result_cls, save_wav):
        self.output_dir = output_dir
        self.result_cls = result_cls
        self.save_wav = save_wav
        self.calls = []
        self.src_contents = []
        self.gate = None

    def generate_music(self, **kwargs):
        if self.gate is not None:
            self.gate.wait(timeout=30)
        self.calls.append(kwargs)
        src = kwargs.get("src_audio")
        if isinstance(src, str) and os.path.exists(src):
            with open(src, "rb") as f:
                self.src_contents.append(f.read())
        batch = kwargs.get("batch_size", 1)
        sr = 48000
        audio = np.zeros((sr // 10, 2), np.float32)
        paths = []
        for i in range(batch):
            path = os.path.join(kwargs.get("save_dir") or self.output_dir,
                                f"fake_{len(self.calls)}_{i}.wav")
            self.save_wav(path, audio, sr)
            paths.append(path)
        seeds = kwargs.get("seeds")
        seeds = list(seeds) if isinstance(seeds, list) else (
            [int(seeds)] * batch if seeds is not None else list(range(batch)))
        return self.result_cls(
            audios=[audio] * batch,
            pred_latents=np.zeros((batch, 25, 64), np.float32),
            seeds=seeds[:batch],
            time_costs={"diffusion_time_cost": 0.01},
            sample_rate=sr, audio_paths=paths,
            extra={"frames": 25, "task": kwargs.get("task", "text2music")})


class Server:
    """One package's server on 127.0.0.1 over `handler` (by default a
    `FakeDiTHandler`); `state_kw` goes to its `AppState`."""

    def __init__(self, side, root, api_key=None, workers=1, handler=None,
                 **state_kw):
        mod, result_cls, save_wav, _ = SIDES[side]
        self.root = root
        self.out_dir = os.path.join(root, "outputs")
        os.makedirs(self.out_dir, exist_ok=True)
        self.handler = handler or FakeDiTHandler(self.out_dir, result_cls,
                                                 save_wav)
        self.state = mod.AppState({MODEL: self.handler}, None,
                                  output_dir=self.out_dir,
                                  persist_dir=os.path.join(root, "persist"),
                                  api_key=api_key, worker_count=workers,
                                  **state_kw)
        self.server = mod.create_server(self.state, "127.0.0.1", 0)
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()
        self.port = self.server.server_address[1]

    def close(self):
        if getattr(self.handler, "gate", None) is not None:
            self.handler.gate.set()
        self.state.shutdown()
        self.server.shutdown()
        self.server.server_close()

    def request(self, method, route, body=None, headers=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=30)
        hdrs = dict(headers or {})
        if isinstance(body, (dict, list)):
            body = json.dumps(body)
            hdrs.setdefault("Content-Type", "application/json")
        conn.request(method, route, body, hdrs)
        resp = conn.getresponse()
        raw = resp.read()
        ctype = resp.getheader("Content-Type") or ""
        conn.close()
        if "json" in ctype:
            return resp.status, json.loads(raw.decode())
        return resp.status, raw

    def post(self, route, body, headers=None):
        return self.request("POST", route, body, headers)

    def get(self, route, headers=None):
        return self.request("GET", route, None, headers)

    def wait(self, task_id, timeout=30.0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            _, out = self.post("/query_result", {"task_id_list": [task_id]})
            entry = out["data"][0]
            if entry["status"] != 0:
                return entry
            time.sleep(0.02)
        raise TimeoutError(task_id)


@pytest.fixture()
def servers(tmp_path):
    made = {side: Server(side, str(tmp_path / side)) for side in SIDES}
    yield made
    for s in made.values():
        s.close()


# ---------------------------------------------------------------------------
# normalisation: ids, times and paths become markers
# ---------------------------------------------------------------------------

_TIME_KEYS = {"timestamp", "create_time", "run_start_time", "created_at",
              "started_at", "finished_at", "avg_job_seconds",
              "generation_info", "loaded_at"}


class Norm:
    def __init__(self, out_dir, task_ids):
        self.out_dir = out_dir
        self.task_ids = task_ids

    def __call__(self, x, key=None):
        if key in _TIME_KEYS or (key or "").endswith("time_cost"):
            return "<t>"
        if key == "service":
            return "<service>"
        if key == "devices":           # JAX's devices, or the torch device
            return "<devices>"
        if isinstance(x, dict):
            return {k: self(v, k) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [self(v) for v in x]
        if isinstance(x, str):
            if key == "result" and x.startswith("["):
                return self(json.loads(x))
            for i, tid in enumerate(self.task_ids):
                x = x.replace(tid, f"<task{i}>")
            return x.replace(self.out_dir, "<out>")
        return x


def _wav_bytes():
    buf = io.BytesIO()
    with wave.open(buf, "wb") as f:
        f.setnchannels(2)
        f.setsampwidth(2)
        f.setframerate(48000)
        f.writeframes(b"\x00\x00" * 2 * 4800)
    return buf.getvalue()


def _multipart(fields, files):
    boundary = "----acestepboundary123"
    out = b""
    for name, value in fields.items():
        out += (f"--{boundary}\r\nContent-Disposition: form-data; "
                f'name="{name}"\r\n\r\n{value}\r\n').encode()
    for name, (filename, data) in files.items():
        out += (f"--{boundary}\r\nContent-Disposition: form-data; "
                f'name="{name}"; filename="{filename}"\r\n'
                "Content-Type: application/octet-stream\r\n\r\n").encode()
        out += data + b"\r\n"
    out += f"--{boundary}--\r\n".encode()
    return out, {"Content-Type": f"multipart/form-data; boundary={boundary}",
                 "Content-Length": str(len(out))}


# the port's program counters (utils/trace.py), which the JAX server
# does not export
_PORT_COUNTERS = re.compile(
    r"acestep_(renders|songs|dit_steps|dit_graph_captures|"
    r"dit_graph_replays|vae_plan_retries|serve_group_fallbacks|"
    r"coalesced_jobs|stage_seconds)_total")


def _metrics_lines(raw):
    text = raw.decode() if isinstance(raw, bytes) else raw
    return [re.sub(r"^(acestep_(uptime_seconds|avg_job_seconds)) .*",
                   r"\1 <v>", line) for line in text.splitlines()
            if "hbm" not in line and not _PORT_COUNTERS.search(line)]


def session(srv):
    """The scripted session; returns (transcript, task ids)."""
    log, ids = [], []

    def rec(label, status, body):
        log.append((label, status, body))
        return body

    def job(label, body, headers=None):
        status, out = srv.post("/release_task", body, headers)
        rec(label + " release", status, out)
        tid = out["data"]["task_id"]
        ids.append(tid)
        return rec(label + " result", 200, srv.wait(tid))

    rec("health", *srv.get("/health"))
    rec("models", *srv.get("/v1/models"))
    rec("stats0", *srv.get("/v1/stats"))
    first = job("json", {"prompt": "an upbeat synthpop song",
                         "lyrics": "[Verse]\nhello world",
                         "audio_duration": 10, "batch_size": 2,
                         "thinking": False, "seed": 7,
                         "use_random_seed": False, "audio_format": "wav"})
    payload, headers = _multipart(
        {"prompt": "piano etude", "lyrics": "[inst]", "thinking": "false",
         "task_type": "repaint", "audio_format": "wav",
         "src_audio_path": "/should/be/overridden.wav"},
        {"src_audio": ("upload.wav", _wav_bytes())})
    job("multipart", payload, headers)
    job("base64", {"prompt": "cover it", "task_type": "cover",
                   "thinking": False, "audio_format": "wav",
                   "src_audio_b64": base64.b64encode(_wav_bytes()).decode(),
                   "upload_audio_format": "wav"})
    entries = json.loads(first["result"])
    status, raw = srv.get(f"/v1/audio?path={entries[0]['file']}")
    rec("audio", status, raw)
    rec("audio guard", *srv.get("/v1/audio?path=/etc/passwd"))
    status, raw = srv.get(f"/v1/audio?path={entries[0]['params_file']}")
    rec("sidecar", status, raw if isinstance(raw, dict) else
        json.loads(raw.decode()))
    rec("unknown model", *srv.post("/release_task", {
        "prompt": "x", "model": "no-such-model", "thinking": False}))
    rec("unknown task", *srv.post("/query_result",
                                  {"task_id_list": ["nope"]}))
    rec("unknown route", *srv.post("/no_such_route", {}))
    # cancel: one job holds the worker, the next is queued and canceled
    srv.handler.gate = threading.Event()
    body = {"prompt": "held", "thinking": False, "audio_format": "wav",
            "audio_duration": 5, "seed": 1, "use_random_seed": False}
    _, a = srv.post("/release_task", body)
    deadline = time.time() + 10
    while srv.state.job_queue.qsize() and time.time() < deadline:
        time.sleep(0.01)
    _, b = srv.post("/release_task", dict(body, audio_duration=6))
    ids += [a["data"]["task_id"], b["data"]["task_id"]]
    rec("cancel queued", *srv.post("/v1/cancel_task",
                                   {"task_id": ids[-1]}))
    rec("cancel running", *srv.post("/v1/cancel_task",
                                    {"task_id": ids[-2]}))
    rec("cancel unknown", *srv.post("/v1/cancel_task", {"task_id": "nope"}))
    srv.handler.gate.set()
    rec("held result", 200, srv.wait(ids[-2]))
    rec("canceled result", 200, srv.wait(ids[-1]))
    rec("cancel finished", *srv.post("/v1/cancel_task",
                                     {"task_id": ids[-2]}))
    rec("stats", *srv.get("/v1/stats"))
    status, raw = srv.get("/metrics")
    rec("metrics", status, _metrics_lines(raw))
    rec("calls", 0, [sorted(k for k, v in c.items() if v is not None)
                     for c in srv.handler.calls])
    return log, ids


def test_scripted_session_envelopes_equal(servers):
    got = {}
    for side, srv in servers.items():
        log, ids = session(srv)
        got[side] = Norm(srv.out_dir, ids)(log)
    assert got["torch"] == got["jax"]
    log = dict((label, (status, body))
               for label, status, body in got["torch"])
    # the session itself behaved (both sides equally broken would pass)
    assert log["json result"][1]["status"] == 1
    assert len(log["json result"][1]["result"]) == 2
    assert log["multipart result"][1]["status"] == 1
    assert log["audio"][0] == 200 and log["audio guard"][0] == 403
    assert log["sidecar"][1]["caption"] == "an upbeat synthpop song"
    assert log["unknown model"][0] == 400
    assert log["unknown route"][0] == 404
    assert log["cancel queued"][1]["data"]["status"] == "canceled"
    assert log["cancel running"][1]["data"]["status"] == "running"
    assert log["canceled result"][1]["status"] == 2
    assert log["cancel finished"][1]["data"]["status"] == "succeeded"
    assert 'acestep_jobs{status="succeeded"} 4' in log["metrics"][1]
    torch_srv = servers["torch"]
    assert torch_srv.handler.src_contents[0] == _wav_bytes()
    assert torch_srv.handler.calls[1]["src_audio"] != \
        "/should/be/overridden.wav"


@pytest.mark.parametrize("side", list(SIDES))
def test_api_key_auth(tmp_path, side):
    """GET and POST are gated alike on both servers (health stays open;
    GET also takes ?ai_token=)."""
    srv = Server(side, str(tmp_path), api_key="sekrit")
    try:
        seen = [srv.get("/v1/stats")[0],
                srv.get("/v1/stats?ai_token=sekrit")[0],
                srv.get("/v1/stats?ai_token=wrong")[0],
                srv.get("/v1/stats", {"Authorization": "Bearer sekrit"})[0],
                srv.get("/health")[0],
                srv.post("/release_task", {"prompt": "x"})[0],
                srv.post("/release_task", {"prompt": "x", "ai_token":
                                           "sekrit", "thinking": False})[0]]
    finally:
        srv.close()
    assert seen == [401, 200, 401, 200, 200, 401, 200]


# ---------------------------------------------------------------------------
# request mapping and the coalescing key
# ---------------------------------------------------------------------------

_BODY = st.fixed_dictionaries({}, optional={
    "prompt": st.sampled_from(["", "jazz", "lofi beat"]),
    "lyrics": st.sampled_from(["", "[inst]", "[verse]\nla"]),
    "thinking": st.booleans(),
    "task_type": st.sampled_from(["text2music", "cover", "repaint"]),
    "audio_duration": st.sampled_from([None, 0, 10, "30", 60.0, -1]),
    "duration": st.sampled_from([15, "20"]),
    "batch_size": st.sampled_from([None, 1, 2]),
    "seed": st.sampled_from([-1, 3, "12", "x"]),
    "use_random_seed": st.booleans(),
    "inference_steps": st.sampled_from([8, 16, "4"]),
    "steps": st.sampled_from([6]),
    "guidance_scale": st.sampled_from([7.0, "3.5"]),
    "shift": st.sampled_from([1.0, 3.0]),
    "timesteps": st.sampled_from([None, "", "0.9,0.5,0.1", "a,b"]),
    "infer_method": st.sampled_from(["ode", "sde"]),
    "want_lrc": st.booleans(),
    "audio_codes": st.sampled_from(["", "<|audio_code_3|>"]),
    "src_audio_path": st.sampled_from([None, "/tmp/x.wav"]),
    "reference_audio_path": st.sampled_from([None, "/tmp/r.wav"]),
    "model": st.sampled_from([None, "m1", "m2"]),
    "lm_model_path": st.sampled_from([None, "lm-a"]),
    "lm_backend": st.sampled_from(["jax", "vllm"]),
    "audio_format": st.sampled_from(["wav", "flac", "mp3"]),
    "format": st.sampled_from(["flac"]),
    "keyscale": st.sampled_from(["", "C major"]),
    "bpm": st.sampled_from([None, 120, "90"]),
    "repainting_end": st.sampled_from([None, 5.0]),
    "lm_top_k": st.sampled_from([None, 0, 40]),
    "lm_top_p": st.sampled_from([None, 0.5]),
    "track_classes": st.sampled_from([None, "vocals, drums"]),
    "use_adg": st.booleans(),
    "analysis_only": st.booleans(),
    "cfg_interval_start": st.sampled_from([0.0, "0.2"]),
})


@settings(max_examples=150, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(body=_BODY)
def test_request_mapping_and_coalesce_key_equal(body):
    jreq, treq = JReq.from_dict(body), TReq.from_dict(body)
    assert treq.to_dict() == jreq.to_dict()
    assert tserver.request_to_params(treq).to_dict() == \
        jserver.request_to_params(jreq).to_dict()
    assert tserver._coalesce_key(treq) == jserver._coalesce_key(jreq)


# ---------------------------------------------------------------------------
# the coalescing queue, driven without workers
# ---------------------------------------------------------------------------


def _queue_state(side, root):
    mod, result_cls, save_wav, req_cls = SIDES[side]
    out_dir = os.path.join(root, "out")
    os.makedirs(out_dir, exist_ok=True)
    handler = FakeDiTHandler(out_dir, result_cls, save_wav)
    state = mod.AppState({MODEL: handler}, None, output_dir=out_dir,
                         persist_dir=os.path.join(root, "persist"))
    return state, handler, req_cls


def _enqueue(state, req):
    rec = state.job_store.create()
    with state.pending_lock:
        state.pending_ids.append(rec.job_id)
    state.job_queue.put_nowait((rec.job_id, req))
    return rec.job_id


def _drain(state):
    head_id, head_req = state.job_queue.get()
    assert state._claim_job(head_id, head_req)
    return state._drain_compatible(head_id, head_req)


def _fused(side, root):
    state, handler, R = _queue_state(side, root)
    ids = [_enqueue(state, R(prompt=f"song {i}", lyrics="[inst]",
                             audio_duration=30.0, seed=i,
                             use_random_seed=False, thinking=False,
                             audio_format="wav"))
           for i in range(3)]
    group, leftovers = _drain(state)
    assert [jid for jid, _ in group] == ids and not leftovers
    state._run_job_group(group)
    call = handler.calls[0]
    recs = [state.job_store.get(j) for j in ids]
    return dict(calls=len(handler.calls), batch=call["batch_size"],
                captions=call["captions"], seeds=call["seeds"],
                random=call["use_random_seed"],
                status=[r.status for r in recs],
                coalesced=[r.result["extra_outputs"]["coalesced_jobs"]
                           for r in recs],
                songs=[len(r.result["audios"]) for r in recs],
                total=state.coalesced_jobs_total)


def _stop_at_incompatible(side, root):
    state, _, R = _queue_state(side, root)
    for prompt, dur in (("a", 30.0), ("b", 30.0), ("c", 60.0), ("d", 30.0)):
        _enqueue(state, R(prompt=prompt, audio_duration=dur, thinking=False))
    group, leftovers = _drain(state)
    return ([r.prompt for _, r in group], [r.prompt for _, r in leftovers],
            state.job_queue.qsize())


def _non_coalescable_head(side, root):
    state, _, R = _queue_state(side, root)
    _enqueue(state, R(prompt="t", audio_duration=30.0, thinking=True))
    _enqueue(state, R(prompt="p", audio_duration=30.0, thinking=False))
    head_id, head_req = state.job_queue.get()
    group, leftovers = state._drain_compatible(head_id, head_req)
    return len(group), len(leftovers), state.job_queue.qsize()


def _canceled(side, root):
    state, handler, R = _queue_state(side, root)
    ids = [_enqueue(state, R(prompt=p, audio_duration=30.0,
                             audio_format="wav")) for p in "abc"]
    state.cancel_task(ids[1])
    group, _ = _drain(state)
    state._run_job_group(group)
    return ([ids.index(j) for j, _ in group], handler.calls[0]["batch_size"],
            state.job_store.get(ids[1]).status)


@pytest.mark.parametrize("scenario", [_fused, _stop_at_incompatible,
                                      _non_coalescable_head, _canceled])
def test_coalescing_behaves_the_same(tmp_path, scenario):
    got = {side: scenario(side, str(tmp_path / side)) for side in SIDES}
    assert got["torch"] == got["jax"]
    if scenario is _fused:
        assert got["torch"]["batch"] == 3 and got["torch"]["total"] == 3
        assert got["torch"]["coalesced"] == [3, 3, 3]
    if scenario is _canceled:
        assert got["torch"] == ([0, 2], 2, "failed")


def test_coalesce_max_defaults_to_four(tmp_path, monkeypatch):
    monkeypatch.delenv("ACESTEP_COALESCE_MAX", raising=False)
    state, _, _ = _queue_state("torch", str(tmp_path))
    assert state.coalesce_max == 4


def test_result_payload_is_json(tmp_path):
    """The port's results carry audio arrays and latents for in-process
    callers; the job store keeps only JSON."""
    from acestep_torch import inference as tinf

    out_dir = str(tmp_path / "out")
    handler = FakeDiTHandler(out_dir, thandler.GenerationResult,
                             taudio.save_wav)
    res = tinf.generate_music(handler, None, tinf.GenerationParams(
        caption="x", duration=5.0, thinking=False, seed=2),
        tinf.GenerationConfig(batch_size=1, output_dir=out_dir,
                              audio_format="wav"))
    assert res.success and "audio" in res.audios[0]
    payload = tserver._result_payload(res)
    json.dumps(payload)
    assert "audio" not in payload["audios"][0]
    assert "pred_latents" not in payload["extra_outputs"]


# ---------------------------------------------------------------------------
# /v1/dataset/*: the same status and envelope as the JAX server
# ---------------------------------------------------------------------------

DATASET_ROUTES = [
    ("GET", "/v1/dataset/status"), ("GET", "/v1/dataset/samples"),
    ("GET", "/v1/dataset/sample/0"), ("GET", "/v1/dataset/auto_label_status"),
    ("GET", "/v1/dataset/auto_label_status/t1"),
    ("GET", "/v1/dataset/preprocess_status"),
    ("GET", "/v1/dataset/preprocess_status/t1"),
    ("POST", "/v1/dataset/build"), ("POST", "/v1/dataset/scan"),
    ("POST", "/v1/dataset/load"), ("POST", "/v1/dataset/save"),
    ("POST", "/v1/dataset/auto_label"),
    ("POST", "/v1/dataset/auto_label_async"),
    ("POST", "/v1/dataset/preprocess"),
    ("POST", "/v1/dataset/preprocess_async"),
    ("POST", "/v1/dataset/sample/0"), ("PUT", "/v1/dataset/sample/0"),
]


@pytest.fixture(scope="module")
def dataset_servers(tmp_path_factory):
    root = tmp_path_factory.mktemp("dataset")
    made = {side: Server(side, str(root / side)) for side in SIDES}
    yield made
    for srv in made.values():
        srv.close()


@pytest.mark.parametrize("method,route", DATASET_ROUTES)
def test_dataset_routes_answer_like_jax(dataset_servers, port_safe_root,
                                        method, route):
    """Each route on a server with no dataset session yet and a missing
    audio dir: the port's status code and envelope equal the JAX
    server's (timestamps aside). Both resolve user paths under the same
    safe root (the test's directory)."""
    answers = {}
    for side, srv in dataset_servers.items():
        status, out = srv.request(method, route, {"audio_dir": "x"})
        answers[side] = (status, {k: v for k, v in out.items()
                                  if k != "timestamp"})
    assert answers["torch"] == answers["jax"]
    status, out = answers["torch"]
    assert status != 501 and out["code"] == status
    assert set(out) == {"data", "code", "error", "extra"}


@pytest.mark.parametrize("env", [{}, {"ACESTEP_DEBUG_DIT": "1"},
                                 {"ACESTEP_DEBUG": "1"}])
def test_debug_timers_gated_like_jax(monkeypatch, capsys, env):
    """utils/debug.py, a copy: the same switches gate the same timers."""
    from acestep_tpu.utils import debug as jdebug
    from acestep_torch.utils import debug as tdebug

    monkeypatch.delenv("ACESTEP_DEBUG", raising=False)
    monkeypatch.delenv("ACESTEP_DEBUG_DIT", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seen = []
    for mod in (jdebug, tdebug):
        with mod.debug_timer("op", "dit") as t:
            pass
        seen.append((mod.debug_enabled("dit"), mod.debug_enabled("vae"),
                     t.elapsed is None, capsys.readouterr().err.count("op:")))
    assert seen[0] == seen[1]
    assert seen[1][0] == bool(env)


# ---------------------------------------------------------------------------
# the Studio's, the LoRA panel's and the training panel's routes, over real
# tiny handlers: each answers as the JAX server's does
# ---------------------------------------------------------------------------

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
TRAIN = {"rank": 2, "max_steps": 1, "batch_size": 1, "checkpoint_every": 0,
         "log_every": 1}
# status keys whose values differ between the packages by design: the two
# trainers draw their noise from different RNGs
_RUN_KEYS = ("loss", "events")


@pytest.fixture(scope="module")
def route_env(tmp_path_factory):
    """Both servers over tiny real handlers (the JAX handler's seeded
    weights carried across to the port's, as test_torch_tasks.py's `_pair`
    builds them) with the repo's examples; one shared root holds the
    preprocessed tensors, a PEFT-layout adapter and a checkpoint root."""
    import jax.numpy as jnp
    import torch
    from safetensors.numpy import save_file

    from acestep_torch.training.preprocess import preprocess_samples
    from torch_parity import np_tree, port_cfg, tiny_dit_cfg, tiny_vae_cfg

    root = tmp_path_factory.mktemp("routes")
    geom = dict(frame_bucket=8, min_frames=8, refer_frames=8)
    jh = jhandler.AceStepHandler(dit_config=tiny_dit_cfg(),
                                 vae_config=tiny_vae_cfg(),
                                 dtype=jnp.float32, **geom)
    jh.initialize_service(seed=0)
    th = thandler.AceStepHandler(port_cfg(tiny_dit_cfg()),
                                 port_cfg(tiny_vae_cfg()),
                                 dtype=torch.float32, device="cpu", **geom)
    th.initialize_service(params=np_tree(jh.params),
                          vae_params=np_tree(jh.vae_params))

    rng = np.random.default_rng(0)
    samples = []
    for i in range(2):
        path = str(root / f"s{i}.wav")
        taudio.save_wav(path, (0.1 * rng.standard_normal((8 * 40, 2)))
                        .astype(np.float32))
        samples.append({"audio_path": path, "caption": f"s{i}",
                        "lyrics": "[inst]"})
    tensors = str(root / "tensors")
    list(preprocess_samples(th, samples, tensors))    # both read these

    cfg = th.cfg
    adapter = {}
    for layer in range(cfg.num_hidden_layers):
        for proj in ("q_proj", "v_proj"):
            out = (cfg.num_attention_heads if proj == "q_proj"
                   else cfg.num_key_value_heads) * cfg.head_dim
            adapter[f"layers.{layer}.self_attn.{proj}.lora_A.weight"] = \
                rng.standard_normal((2, cfg.hidden_size)).astype(np.float32)
            adapter[f"layers.{layer}.self_attn.{proj}.lora_B.weight"] = \
                rng.standard_normal((out, 2)).astype(np.float32)
    save_file(adapter, str(root / "adapter_model.safetensors"))

    ckpts = root / "ckpts"
    for name, files in (("acestep-v15-turbo", {"config.json": "{}",
                                               "model.safetensors": ""}),
                        ("my-finetune", {"config.json": '{"model_version": '
                                         '"sft"}', "model.safetensors": ""}),
                        ("half-download", {"config.json": "{}"}),
                        ("peft-dump", {"adapter_config.json": "{}",
                                       "adapter_model.safetensors": ""})):
        (ckpts / name).mkdir(parents=True)
        for fname, text in files.items():
            (ckpts / name / fname).write_text(text)
    (root / "empty_logs").mkdir()

    made = {side: Server(side, str(root / side), handler=h,
                         examples_dir=EXAMPLES)
            for side, h in (("jax", jh), ("torch", th))}
    env = dict(root=str(root), tensors=tensors, ckpts=str(ckpts),
               adapter=str(root / "adapter_model.safetensors"),
               empty_logs=str(root / "empty_logs"))
    yield made, env
    for srv in made.values():
        srv.close()


@pytest.fixture()
def route_roots(route_env):
    """Both packages' safe roots at the shared root for one test."""
    from acestep_tpu.utils import path_safety as jpath
    from acestep_torch.utils import path_safety as tpath

    olds = jpath.get_safe_root(), tpath.get_safe_root()
    for mod in (jpath, tpath):
        mod.set_safe_root(route_env[1]["root"])
    yield
    jpath.set_safe_root(olds[0])
    tpath.set_safe_root(olds[1])


def _without_comments(html):
    return re.sub(r"<!--.*?-->", "", html, flags=re.S)


def _training_done(srv, timeout=120.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        _, st = srv.get("/v1/training/status")
        if st["data"]["status"] in ("completed", "failed", "stopped"):
            return st
        time.sleep(0.05)
    raise TimeoutError(st)


def _run_view(envelope):
    """A training status envelope with the RNG-dependent values masked;
    their presence is kept."""
    data = envelope["data"]
    return dict(envelope, data={k: ("<run>" if k in _RUN_KEYS else v)
                                for k, v in data.items()})


def _train(srv, env, route, name, **config):
    status, out = srv.post(route, {
        "dataset_dir": env["tensors"], "config": dict(
            TRAIN, output_dir=os.path.join(srv.root, name),
            adapter_name=name, **config)})
    return [(f"{name} start", status, out),
            (f"{name} done", 200, _run_view(_training_done(srv)))]


def _load(srv, env, name="panel"):
    return ("load", *srv.post("/v1/lora/load", {"lora_path": env["adapter"],
                                                "adapter_name": name}))


def case_studio(srv, env):
    log = []
    for route in ("/studio", "/"):
        status, page = srv.get(route)
        log.append((route, status, _without_comments(page.decode())))
    return log


def case_create_random_sample(srv, env):
    log = []
    for i, mode in enumerate(("custom_mode", "simple_mode", "custom_mode")):
        random.seed(i)        # the route picks an example at random
        log.append((mode, *srv.post("/create_random_sample",
                                    {"sample_mode": mode})))
    return log


def case_lrc_to_vtt(srv, env):
    lrc = ("[ar:someone]\n[00:01.00]first line\n[00:02.50]second line\n"
           "[00:03.10]quick\n[00:09.00]last words\n")
    log = []
    for d in ("12s", 20.0, "garbage", None):
        status, out = srv.post("/lrc_to_vtt", {"lrc": lrc, "duration": d})
        # the cues' own "timestamp" keys would be masked as times
        log += [(str(d), status, out),
                (f"{d} cues", status, json.dumps(out["data"]["cues"]))]
    return log


def case_lora_load(srv, env):
    return [_load(srv, env),
            ("load default name", *srv.post("/v1/lora/load", {
                "lora_path": env["adapter"]})),
            ("load missing", *srv.post("/v1/lora/load", {
                "lora_path": os.path.join(env["root"], "none.safetensors")})),
            ("load outside the root", *srv.post("/v1/lora/load", {
                "lora_path": "/etc/passwd"})),
            ("status", *srv.get("/v1/lora/status"))]


def case_lora_unload(srv, env):
    return [_load(srv, env),
            ("unload", *srv.post("/v1/lora/unload", {"adapter_name":
                                                     "panel"})),
            ("unload again", *srv.post("/v1/lora/unload",
                                       {"adapter_name": "panel"})),
            ("status", *srv.get("/v1/lora/status"))]


def case_lora_toggle(srv, env):
    return [_load(srv, env),
            ("off", *srv.post("/v1/lora/toggle", {"use_lora": False})),
            ("status off", *srv.get("/v1/lora/status")),
            ("on", *srv.post("/v1/lora/toggle", {"use_lora": True})),
            ("status on", *srv.get("/v1/lora/status"))]


def case_lora_scale(srv, env):
    return [_load(srv, env),
            ("scale", *srv.post("/v1/lora/scale", {"adapter_name": "panel",
                                                   "scale": 0.5})),
            ("status", *srv.get("/v1/lora/status")),
            ("scale active", *srv.post("/v1/lora/scale", {"scale": "2"})),
            ("scale unknown", *srv.post("/v1/lora/scale", {
                "adapter_name": "nope", "scale": 1.0}))]


def case_lora_status(srv, env):
    return [("empty", *srv.get("/v1/lora/status")), _load(srv, env),
            _load(srv, env, "second"),
            ("two", *srv.get("/v1/lora/status"))]


def _render(handler):
    res = handler.generate_music(captions=["reinit"], audio_duration=0.64,
                                 seeds=[5], normalize=False)
    return np.asarray(res.pred_latents), np.asarray(res.audios[0])


def case_reinitialize(srv, env):
    """Without a checkpoint dir and without allow_random_init the route
    refuses; with it, each re-init rebuilds the same seeded weights, so a
    render after the second re-init equals the render before it."""
    log = [("refused", *srv.post("/v1/reinitialize", {}))]
    renders = []
    for i in range(2):
        log.append((f"reinit {i}", *srv.post("/v1/reinitialize",
                                             {"allow_random_init": True})))
        renders.append(_render(srv.handler))
    for before, after in zip(*renders):
        np.testing.assert_array_equal(after, before)
    assert np.abs(renders[0][1]).max() > 0
    log.append(("lora after reinit", *srv.get("/v1/lora/status")))
    return log


def case_start_lora(srv, env):
    return _train(srv, env, "/v1/training/start_lora", "lora_run") + [
        ("lora", *srv.get("/v1/lora/status"))]


def case_start_lokr(srv, env):
    return _train(srv, env, "/v1/training/start_lokr", "lokr_run",
                  lokr_factor=4) + [("lora", *srv.get("/v1/lora/status"))]


def case_stop(srv, env):
    status, out = srv.post("/v1/training/start", {
        "dataset_dir": env["tensors"], "config": dict(
            TRAIN, max_steps=100000,
            output_dir=os.path.join(srv.root, "stopped_run"))})
    log = [("start", status, out),
           ("second start", *srv.post("/v1/training/start", {
               "dataset_dir": env["tensors"], "config": {}})),
           ("stop", *srv.post("/v1/training/stop", {}))]
    st = _training_done(srv)
    log.append(("stopped", 200, st["data"]["status"]))
    assert st["data"]["step"] < 100000
    return log + _train(srv, env, "/v1/training/start", "restarted")


def case_tensorboard_start(srv, env):
    return [("empty logdir", *srv.post("/v1/training/tensorboard/start",
                                       {"logdir": env["empty_logs"]})),
            ("outside the root", *srv.post("/v1/training/tensorboard/start",
                                           {"logdir": "/var/log"}))]


def case_tensorboard_stop(srv, env):
    return [("stop", *srv.post("/v1/training/tensorboard/stop", {}))]


def case_load_tensor_info(srv, env):
    return [("tensors", *srv.post("/v1/training/load_tensor_info",
                                  {"dataset_dir": env["tensors"]})),
            ("tensor_dir", *srv.post("/v1/training/load_tensor_info",
                                     {"tensor_dir": env["tensors"]})),
            ("missing", *srv.post("/v1/training/load_tensor_info", {
                "dataset_dir": os.path.join(env["root"], "nope")}))]


def case_export(srv, env):
    out = os.path.join(srv.root, "exported")
    return _train(srv, env, "/v1/training/start", "exported") + [
        ("export", *srv.post("/v1/training/export", {"output_dir": out})),
        ("export latest", *srv.post("/v1/training/export", {})),
        ("export missing", *srv.post("/v1/training/export", {
            "output_dir": os.path.join(env["root"], "no_run")}))]


def case_models_discover(srv, env):
    return [(q, *srv.get(f"/v1/models/discover?root={env['ckpts']}{q}"))
            for q in ("", "&q=turbo", "&q=zzz")] + [
        ("outside the root", *srv.get("/v1/models/discover?root=/etc"))]


ROUTE_CASES = {
    "/studio": case_studio,
    "/create_random_sample": case_create_random_sample,
    "/lrc_to_vtt": case_lrc_to_vtt,
    "/v1/lora/load": case_lora_load,
    "/v1/lora/unload": case_lora_unload,
    "/v1/lora/toggle": case_lora_toggle,
    "/v1/lora/scale": case_lora_scale,
    "/v1/lora/status": case_lora_status,
    "/v1/reinitialize": case_reinitialize,
    "/v1/training/start_lora": case_start_lora,
    "/v1/training/start_lokr": case_start_lokr,
    "/v1/training/stop": case_stop,
    "/v1/training/tensorboard/start": case_tensorboard_start,
    "/v1/training/tensorboard/stop": case_tensorboard_stop,
    "/v1/training/load_tensor_info": case_load_tensor_info,
    "/v1/training/export": case_export,
    "/v1/models/discover": case_models_discover,
}


# each case's statuses in order: a transcript equal on both sides must also
# be the session that was meant (both sides failing alike would pass)
ROUTE_STATUSES = {
    "/studio": [200, 200],
    "/create_random_sample": [200, 200, 200],
    "/lrc_to_vtt": [200] * 8,
    "/v1/lora/load": [200, 200, 500, 400, 200],
    "/v1/lora/unload": [200] * 4,
    "/v1/lora/toggle": [200] * 5,
    "/v1/lora/scale": [200, 200, 200, 200, 500],
    "/v1/lora/status": [200] * 4,
    "/v1/reinitialize": [400, 200, 200, 200],
    "/v1/training/start_lora": [200] * 3,
    "/v1/training/start_lokr": [200] * 3,
    "/v1/training/stop": [200, 409, 200, 200, 200, 200],
    "/v1/training/tensorboard/start": [503, 400],
    "/v1/training/tensorboard/stop": [200],
    "/v1/training/load_tensor_info": [200, 200, 404],
    "/v1/training/export": [200, 200, 200, 200, 404],
    "/v1/models/discover": [200, 200, 200, 400],
}


@pytest.mark.parametrize("route", list(ROUTE_CASES))
def test_routes_answer_like_jax(route_env, route_roots, route):
    """The same requests to both servers, each over its package's tiny
    handler: the transcripts (statuses and envelopes, ids, times, the
    device list and each side's own root masked) are equal, and the
    route did its work (no error where the case expects none)."""
    servers, env = route_env
    got = {}
    for side, srv in servers.items():
        try:
            got[side] = Norm(srv.root, [])(ROUTE_CASES[route](srv, env))
        finally:
            while srv.handler.lora.unload()["unloaded"]:
                pass
    assert got["torch"] == got["jax"]
    assert [status for _, status, _ in got["torch"]] == \
        ROUTE_STATUSES[route], got["torch"]


def test_per_request_lm_swap(tmp_path, monkeypatch):
    """`lm_model_path` selects a cached planner per checkpoint path, built
    with the server's device; unknown paths fall back to the default. The
    JAX package's cache-hit and in-use-eviction sequence
    (tests/test_serving.py::test_per_request_lm_swap), against the port's
    `AppState._select_llm`."""
    import acestep_torch.llm.handler as llm_mod
    from acestep_torch.utils import downloads

    out_dir = str(tmp_path / "outputs")
    os.makedirs(out_dir, exist_ok=True)
    default_llm = object()
    dit = FakeDiTHandler(out_dir, thandler.GenerationResult, taudio.save_wav)
    dit.device = "cpu"
    state = tserver.AppState({"m": dit}, default_llm, output_dir=out_dir,
                             persist_dir=str(tmp_path / "persist"))
    built = []

    class FakeLLM:
        def __init__(self, device=None, **kw):
            self.device = device

        def initialize(self, checkpoint_dir=None, **kw):
            built.append((checkpoint_dir, self.device))

    monkeypatch.setattr(llm_mod, "LLMHandler", FakeLLM)
    # no hub is contacted: a name that is not a directory resolves locally
    # or not at all
    monkeypatch.setattr(downloads, "_probe", lambda *a, **k: False)

    assert state._select_llm(None)[0] is default_llm
    assert state._select_llm("")[0] is default_llm
    assert state._select_llm("not-a-model-xyz")[0] is default_llm

    ckpt = {}
    for name in "abcd":
        ckpt[name] = str(tmp_path / f"lm-{name}")
        os.makedirs(ckpt[name])
    a1, rel_a1 = state._select_llm(ckpt["a"])
    a2, rel_a2 = state._select_llm(ckpt["a"])
    assert a1 is a2 and built == [(ckpt["a"], "cpu")]    # cache hit
    rel_a2()
    # a is still held by rel_a1: filling past the cap must not evict it
    state._select_llm(ckpt["b"])[1]()
    _, rel_c = state._select_llm(ckpt["c"])
    assert ckpt["a"] in state._llm_cache                 # in use: kept
    rel_a1()
    a3, _ = state._select_llm(ckpt["a"])
    assert a3 is a1                                      # still cached
    rel_c()
    # with nothing held, a fourth model evicts down to the cap
    state._select_llm(ckpt["d"])[1]()
    assert len(state._llm_cache) == state.max_cached_llms
    assert [b for b, _ in built] == [ckpt[n] for n in "abcd"]
