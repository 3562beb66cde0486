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
    def __init__(self, side, root, api_key=None, workers=1):
        mod, result_cls, save_wav, _ = SIDES[side]
        self.out_dir = os.path.join(root, "outputs")
        os.makedirs(self.out_dir, exist_ok=True)
        self.handler = FakeDiTHandler(self.out_dir, result_cls, save_wav)
        self.state = mod.AppState({MODEL: self.handler}, None,
                                  output_dir=self.out_dir,
                                  persist_dir=os.path.join(root, "persist"),
                                  api_key=api_key, worker_count=workers)
        self.server = mod.create_server(self.state, "127.0.0.1", 0)
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()
        self.port = self.server.server_address[1]

    def close(self):
        if self.handler.gate is not None:
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
              "generation_info"}


class Norm:
    def __init__(self, out_dir, task_ids):
        self.out_dir = out_dir
        self.task_ids = task_ids

    def __call__(self, x, key=None):
        if key in _TIME_KEYS or (key or "").endswith("time_cost"):
            return "<t>"
        if key == "service":
            return "<service>"
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


def _metrics_lines(raw):
    text = raw.decode() if isinstance(raw, bytes) else raw
    return [re.sub(r"^(acestep_(uptime_seconds|avg_job_seconds)) .*",
                   r"\1 <v>", line) for line in text.splitlines()
            if "hbm" not in line]


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
def test_dataset_routes_answer_like_jax(dataset_servers, monkeypatch, method,
                                        route):
    """Each route on a server with no dataset session yet and a missing
    audio dir: the port's status code and envelope equal the JAX
    server's (timestamps aside). Both resolve user paths under the same
    safe root (the test's directory, which conftest gives the JAX
    package)."""
    from acestep_tpu.utils.path_safety import get_safe_root

    monkeypatch.setattr("acestep_torch.utils.path_safety._SAFE_ROOT",
                        get_safe_root())
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
