"""LoRA training over REST on the CPU: the port's `TrainingService` runs 2
steps on tiny preprocessed tensors beside the JAX package's service on the
same tensors (the JAX handler's seeded weights carried across); status and
metrics carry the JAX service's keys, the adapter file loads into the
`LoraManager`, a quantized service trains against its dequantized weights,
and the tfevents export reads back with its CRCs, record for record equal
to the JAX export. The two trainers draw their noise from different RNGs,
so losses are compared only for being finite; keys and records exactly."""

import json
import os
import struct
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acestep_tpu.pipeline.handler import AceStepHandler as JaxHandler
from acestep_tpu.serving.training_service import TrainingService as JService
from acestep_tpu.utils import tfevents as jtf
from acestep_torch.lora.manager import load_adapter_file
from acestep_torch.pipeline.handler import AceStepHandler
from acestep_torch.serving.training_service import TrainingService
from acestep_torch.training.preprocess import preprocess_samples
from acestep_torch.utils import tfevents as ttf
from acestep_torch.utils.audio import save_wav
from torch_parity import np_tree, port_cfg, tiny_dit_cfg, tiny_vae_cfg

GEOM = dict(frame_bucket=8, min_frames=8)
CONFIG = {"rank": 2, "max_steps": 2, "batch_size": 1, "checkpoint_every": 0,
          "log_every": 1, "adapter_name": "api_adapter"}


@pytest.fixture(scope="module")
def handlers():
    jh = JaxHandler(dit_config=tiny_dit_cfg(), vae_config=tiny_vae_cfg(),
                    dtype=jnp.float32, **GEOM)
    jh.initialize_service(seed=0)
    th = AceStepHandler(port_cfg(tiny_dit_cfg()), port_cfg(tiny_vae_cfg()),
                        dtype=torch.float32, device="cpu", **GEOM)
    th.initialize_service(params=np_tree(jh.params),
                          vae_params=np_tree(jh.vae_params))
    return jh, th


@pytest.fixture(scope="module")
def tensors(handlers, tmp_path_factory):
    _, th = handlers
    root = tmp_path_factory.mktemp("tensors")
    rng = np.random.default_rng(0)
    samples = []
    for i in range(3):
        path = str(root / f"s{i}.wav")
        save_wav(path, (0.1 * rng.standard_normal((8 * 40, 2))).astype(
            np.float32))
        samples.append({"audio_path": path, "caption": f"s{i}",
                        "lyrics": "[inst]"})
    out = str(root / "tensors")
    list(preprocess_samples(th, samples, out))
    return out


def _run(svc, tensors, out_dir, **extra):
    svc.start(dataset_dir=tensors, config=dict(CONFIG, output_dir=out_dir,
                                               **extra))
    deadline = time.time() + 300
    while time.time() < deadline:
        st = svc.status()
        if st["status"] in ("completed", "failed", "stopped"):
            return st
        time.sleep(0.1)
    raise TimeoutError(st)


def test_status_and_metrics_keys_equal_jax(handlers, tensors, tmp_path):
    jh, th = handlers
    got = _run(TrainingService(th), tensors, str(tmp_path / "t"))
    want = _run(JService(jh), tensors, str(tmp_path / "j"))
    assert got["status"] == want["status"] == "completed", (got, want)
    assert set(got) == set(want)
    assert got["step"] == want["step"] == 2
    assert [set(e) for e in got["events"]] == [set(e) for e in want["events"]]
    assert [e["step"] for e in got["events"]] == \
        [e["step"] for e in want["events"]]
    assert np.isfinite(got["loss"])
    tm = TrainingService(th).metrics(output_dir=str(tmp_path / "t"))
    jm = JService(jh).metrics(output_dir=str(tmp_path / "j"))
    assert set(tm) == set(jm) and tm["steps"] == jm["steps"]
    # the trained adapter: in the handler's LoRA runtime, and on disk in
    # the JAX layout with its targets and stacked factors
    assert th.lora.status()["active_adapter"] == "api_adapter"
    adapter = load_adapter_file(str(tmp_path / "t" / "api_adapter.npz"))
    assert adapter["meta"]["rank"] == 2
    assert len(adapter["weights"]) == 11
    with np.load(str(tmp_path / "j" / "api_adapter.npz")) as z:
        jkeys = set(z.files)
    with np.load(str(tmp_path / "t" / "api_adapter.npz")) as z:
        assert set(z.files) == jkeys


def test_quantized_service_trains_on_dequantized_base(tensors, tmp_path):
    th = AceStepHandler(port_cfg(tiny_dit_cfg()), port_cfg(tiny_vae_cfg()),
                        dtype=torch.float32, device="cpu", **GEOM)
    th.initialize_service(seed=1, quantization="int8")
    st = _run(TrainingService(th), tensors, str(tmp_path / "q"))
    assert st["status"] == "completed", st
    assert st.get("dequantized_base") is True and st["step"] == 2
    assert np.isfinite(st["loss"])


def test_start_validates_and_rejects_a_second_run(handlers, tensors,
                                                  tmp_path):
    _, th = handlers
    svc = TrainingService(th)
    with pytest.raises(ValueError, match="dataset_dir or manifest_path"):
        svc.start()
    svc.start(dataset_dir=tensors, config=dict(
        CONFIG, max_steps=500, output_dir=str(tmp_path / "long")))
    with pytest.raises(RuntimeError, match="already running"):
        svc.start(dataset_dir=tensors, config={})
    assert svc.stop() == {"status": "stopping"}
    deadline = time.time() + 120
    while svc.status()["status"] not in ("stopped", "completed", "failed"):
        assert time.time() < deadline
        time.sleep(0.1)
    assert svc.status()["status"] == "stopped"


def _records(path):
    """Payloads of a TFRecord file, each record's two CRCs checked."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        header = data[pos:pos + 8]
        (n,) = struct.unpack("<Q", header)
        assert struct.unpack("<I", data[pos + 8:pos + 12])[0] == \
            ttf._masked_crc(header)
        payload = data[pos + 12:pos + 12 + n]
        assert struct.unpack("<I", data[pos + 12 + n:pos + 16 + n])[0] == \
            ttf._masked_crc(payload)
        out.append(payload)
        pos += 16 + n
    return out


def test_tfevents_export_reads_back(tmp_path):
    metrics = tmp_path / "metrics.jsonl"
    rows = [{"step": s, "loss": 1.0 / (s + 1), "ts": 1000.0 + s}
            for s in range(5)] + [{"step": 5}]
    metrics.write_text("".join(json.dumps(r) + "\n" for r in rows))
    got = ttf.export_metrics_jsonl(str(metrics), str(tmp_path / "t"))
    want = jtf.export_metrics_jsonl(str(metrics), str(tmp_path / "j"))
    assert os.path.basename(got) == os.path.basename(want)
    assert ttf.has_event_files(str(tmp_path / "t"))
    recs = _records(got)
    # the version stamp (with the export's own wall time), then one event
    # per plottable row, byte-equal to the JAX export's
    assert len(recs) == 6 and b"brain.Event:2" in recs[0]
    assert recs[1:] == _records(want)[1:]
    assert ttf.crc32c(b"123456789") == 0xE3069283


# ------------------------------------------------------------------
# /v1/dataset/* over HTTP (the JAX package's test_dataset_build_over_http
# and test_dataset_session_workflow_over_http, on the port's server)
# ------------------------------------------------------------------


def _http(port, method, route, body=None):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, route, json.dumps(body) if body is not None
                 else None, {"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = json.loads(resp.read().decode())
    conn.close()
    return resp.status, out


def _poll(port, route, timeout=120.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        _, st = _http(port, "GET", route)
        if st["data"]["status"] in ("completed", "failed"):
            return st["data"]
        time.sleep(0.1)
    raise TimeoutError(route)


class _Planner:
    """A stub planner for both packages (their samplers draw from
    different RNGs); it records the thread it runs on and whether the
    server's reinit lock is held."""

    def __init__(self, lock=None):
        self.lock = lock
        self.calls = []

    def understand(self, codes, seed=0):
        import threading

        self.calls.append((threading.current_thread().name,
                           self.lock.locked() if self.lock else None))
        return {"caption": f"stub caption {len(codes) % 7}", "bpm": 92,
                "genres": ["ambient"], "keyscale": "E minor"}


def test_dataset_flow_over_http(handlers, tmp_path, monkeypatch):
    import threading
    import wave

    from acestep_tpu.serving.training_service import \
        DatasetService as JDatasetService
    from acestep_torch.serving.server import AppState, create_server

    jh, th = handlers
    monkeypatch.setattr("acestep_torch.utils.path_safety._SAFE_ROOT",
                        str(tmp_path))
    audio_dir = tmp_path / "raw"
    audio_dir.mkdir()
    rng = np.random.default_rng(3)
    for i, name in enumerate(("a.wav", "b.wav")):
        pcm = (0.2 * rng.standard_normal((4800 + 960 * i, 2)) * 32767)
        with wave.open(str(audio_dir / name), "wb") as f:
            f.setnchannels(2)
            f.setsampwidth(2)
            f.setframerate(48000)
            f.writeframes(pcm.astype("<i2").tobytes())
    (audio_dir / "a.txt").write_text("some words")

    state = AppState({"tiny": th}, None, output_dir=str(tmp_path / "out"),
                     persist_dir=str(tmp_path / "persist"))
    planner = _Planner(state.reinit_lock)
    state.dataset.llm = planner        # as the server's main attaches it
    encodes = []
    real_encode = th.encode_audio

    def encode(audio):
        encodes.append((threading.current_thread().name,
                        state.reinit_lock.locked()))
        return real_encode(audio)

    monkeypatch.setattr(th, "encode_audio", encode)
    texts = []
    real_text = th.text_embedder.encode_text

    def encode_text(*args, **kwargs):
        texts.append((threading.current_thread().name,
                      state.reinit_lock.locked()))
        return real_text(*args, **kwargs)

    monkeypatch.setattr(th.text_embedder, "encode_text", encode_text)
    server = create_server(state, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    try:
        # before any scan: session routes reject cleanly
        assert _http(port, "GET", "/v1/dataset/samples")[0] == 400
        status, out = _http(port, "GET", "/v1/dataset/auto_label_status")
        assert status == 200 and out["data"]["status"] == "idle"

        # build -> status
        status, out = _http(port, "POST", "/v1/dataset/build", {
            "audio_dir": str(audio_dir), "out_dir": str(tmp_path / "ds"),
            "val_fraction": 0.0})
        assert status == 200 and out["data"]["status"] == "started"
        st = _poll(port, "/v1/dataset/status")
        assert st["status"] == "completed", st
        assert st["result"]["num_samples"] == 2
        assert st["progress"]["encoded"] == st["progress"]["labeled"] == 2
        assert _http(port, "POST", "/v1/dataset/build", {
            "audio_dir": str(tmp_path / "no_such_dir")})[0] == 404
        assert _http(port, "POST", "/v1/dataset/build",
                     {"audio_dir": "/no/such/dir"})[0] == 400

        # scan -> edit -> auto_label -> save -> preprocess
        status, out = _http(port, "POST", "/v1/dataset/scan", {
            "audio_dir": str(audio_dir), "dataset_name": "http_set",
            "custom_tag": "acid", "tag_position": "prepend"})
        assert status == 200 and out["data"]["num_samples"] == 2
        samples = out["data"]["samples"]
        assert samples[0]["filename"] == "a.wav"
        assert samples[0]["raw_lyrics"] == "some words"
        assert samples[0]["custom_tag"] == "acid"
        status, out = _http(port, "GET", "/v1/dataset/sample/1")
        assert status == 200 and out["data"]["filename"] == "b.wav"
        status, out = _http(port, "PUT", "/v1/dataset/sample/1",
                            {"bpm": 123})
        assert status == 200 and out["data"]["sample"]["bpm"] == 123
        assert _http(port, "GET", "/v1/dataset/sample/9")[0] == 404

        status, out = _http(port, "POST", "/v1/dataset/auto_label_async",
                            {"only_unlabeled": False})
        assert status == 200
        task = _poll(port, "/v1/dataset/auto_label_status/"
                     + out["data"]["task_id"])
        assert task["status"] == "completed", task
        assert task["result"]["labeled_count"] == 2
        save_path = tmp_path / "sess.json"
        status, _ = _http(port, "POST", "/v1/dataset/save", {
            "save_path": str(save_path), "genre_ratio": 50})
        assert status == 200
        saved = json.load(open(save_path))
        assert saved["metadata"]["genre_ratio"] == 50
        assert [s["caption"] for s in saved["samples"]] == [
            s["caption"] for s in task["result"]["samples"]]

        out_dir = tmp_path / "sess_tensors"
        status, out = _http(port, "POST", "/v1/dataset/preprocess_async",
                            {"output_dir": str(out_dir)})
        assert status == 200
        task = _poll(port, "/v1/dataset/preprocess_status/"
                     + out["data"]["task_id"])
        assert task["status"] == "completed" and task["current"] == 2
        assert len([f for f in os.listdir(out_dir)
                    if f.endswith(".npz")]) == 2
        # the synchronous routes answer with the result itself
        status, out = _http(port, "POST", "/v1/dataset/auto_label",
                            {"only_unlabeled": True})
        assert status == 200
        assert out["data"]["message"] == "All samples already labeled"
        status, out = _http(port, "POST", "/v1/dataset/load",
                            {"dataset_path": str(save_path)})
        assert status == 200 and out["data"]["labeled_count"] == 2
    finally:
        state.shutdown()
        server.shutdown()
        server.server_close()
    # every device call ran off the HTTP threads, under the reinit lock
    calls = encodes + texts + planner.calls
    assert len(encodes) == 6 and len(planner.calls) == 4
    assert len(texts) == 8     # caption and lyrics, 2 songs, 2 tensor runs
    assert all(locked for _, locked in calls)
    assert not any("process_request" in name for name, _ in calls)

    # the JAX service on the same audio: the same manifest and session
    jsvc = JDatasetService(jh, _Planner())
    jsvc.start(str(audio_dir), str(tmp_path / "ds_jax"))
    deadline = time.time() + 300
    while jsvc.status()["status"] == "running":
        assert time.time() < deadline
        time.sleep(0.1)
    assert jsvc.status()["status"] == "completed"
    with open(tmp_path / "ds" / "dataset.json") as f, \
            open(tmp_path / "ds_jax" / "dataset.json") as g:
        assert json.load(f) == json.load(g)
    jsvc.scan(str(audio_dir), dataset_name="http_set", custom_tag="acid",
              tag_position="prepend")
    jsvc.update_sample(1, {"bpm": 123})
    jsvc.auto_label()
    jsvc.save_session(str(tmp_path / "sess_jax.json"), genre_ratio=50)
    want = json.load(open(tmp_path / "sess_jax.json"))
    for d in (saved, want):
        del d["metadata"]["created_at"]
    assert saved == want


class _OverlapPlanner:
    """A stub planner that records, for each call, whether the server's
    reinit lock is held, and the most calls in flight at once. The first
    `understand` sets `entered`, waits until `gate` is set and then
    lingers, so that a job started meanwhile would enter the planner
    beside it."""

    def __init__(self, lock, gate):
        import threading

        self.lock = lock
        self.gate = gate
        self.entered = threading.Event()
        self.calls = []
        self.active = self.most = 0
        self._guard = threading.Lock()

    def _call(self, name):
        with self._guard:
            self.active += 1
            self.most = max(self.most, self.active)
            self.calls.append((name, self.lock.locked()))
        if name == "understand" and len(self.calls) == 1:
            self.entered.set()
            self.gate.wait(timeout=60)
            time.sleep(0.5)
        with self._guard:
            self.active -= 1

    def understand(self, codes, seed=0, **kw):
        self._call("understand")
        return {"caption": "stub caption", "bpm": 92}

    def format_sample(self, caption, lyrics, **kw):
        self._call("format")
        return {"caption": caption + ", formatted", "lyrics": lyrics}

    def create_sample(self, query, **kw):
        self._call("sample")
        return {"caption": "sampled", "lyrics": "[inst]"}

    def plan(self, **kw):
        self._call("plan")
        return {"metadata": {}, "audio_codes": ""}


class _SilentDiT:
    """Renders 0.1 s of silence per song (the render worker's handler)."""

    def generate_music(self, **kwargs):
        from acestep_torch.pipeline.handler import GenerationResult

        audio = np.zeros((4800, 2), np.float32)
        return GenerationResult(
            audios=[audio], pred_latents=np.zeros((1, 25, 64), np.float32),
            seeds=[0], time_costs={}, sample_rate=48000, audio_paths=[],
            extra={"frames": 25, "task": "text2music"})


def test_planner_users_take_one_lock(handlers, tmp_path, monkeypatch):
    """A session label task holds the planner while a format job and a
    sample job wait in the render queue and /format_input is called: no
    two planner calls overlap, and each holds the reinit lock."""
    import threading

    from acestep_torch.serving.server import AppState, create_server

    _, th = handlers
    monkeypatch.setattr("acestep_torch.utils.path_safety._SAFE_ROOT",
                        str(tmp_path))
    audio_dir = tmp_path / "raw"
    audio_dir.mkdir()
    rng = np.random.default_rng(5)
    for name in ("a.wav", "b.wav"):
        save_wav(str(audio_dir / name), (0.1 * rng.standard_normal(
            (4800, 2))).astype(np.float32))
    gate = threading.Event()
    state = AppState({"tiny": th, "silent": _SilentDiT()}, None,
                     output_dir=str(tmp_path / "out"),
                     persist_dir=str(tmp_path / "persist"))
    planner = _OverlapPlanner(state.reinit_lock, gate)
    state.llm_handler = state.dataset.llm = planner
    server = create_server(state, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    try:
        assert _http(port, "POST", "/v1/dataset/scan",
                     {"audio_dir": str(audio_dir)})[0] == 200
        status, out = _http(port, "POST", "/v1/dataset/auto_label_async",
                            {"only_unlabeled": False})
        assert status == 200
        label_task = out["data"]["task_id"]
        assert planner.entered.wait(timeout=60)
        jobs = []
        for body in ({"prompt": "p", "use_format": True},
                     {"sample_query": "q"}):
            status, out = _http(port, "POST", "/release_task",
                                dict(body, model="silent"))
            assert status == 200
            jobs.append(out["data"]["task_id"])
        formatted = {}
        route = threading.Thread(target=lambda: formatted.update(
            out=_http(port, "POST", "/format_input",
                      {"caption": "c", "lyrics": "l"})))
        route.start()
        deadline = time.time() + 60
        while state.job_store.get(jobs[0]).status == "queued":
            assert time.time() < deadline
            time.sleep(0.01)
        gate.set()
        task = _poll(port, "/v1/dataset/auto_label_status/" + label_task)
        assert task["status"] == "completed", task
        route.join(timeout=60)
        assert formatted["out"][0] == 200
        deadline = time.time() + 60
        while any(state.job_store.get(j).status in ("queued", "running")
                  for j in jobs):
            assert time.time() < deadline
            time.sleep(0.05)
        assert [(state.job_store.get(j).status, state.job_store.get(j).error)
                for j in jobs] == [("succeeded", None)] * 2
    finally:
        gate.set()
        state.shutdown()
        server.shutdown()
        server.server_close()
    names = sorted(name for name, _ in planner.calls)
    assert names == ["format", "format", "plan", "plan", "sample",
                     "understand", "understand"]
    assert all(locked for _, locked in planner.calls)
    assert planner.most == 1
