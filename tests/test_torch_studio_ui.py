"""The Studio's flows against the port's server (the counterpart of
tests/test_studio_ui.py).

The page: the port's `studio.html` equals the JAX package's outside HTML
comments, so the JAX file's structural tests (tabs, modes, endpoints,
i18n, JS wiring) hold for both pages. The live tests drive the HTTP
sequences the page's JS issues against the port's REST server over a tiny
real port handler on the CPU (`DiTConfig.tiny(fsq_dim=64)`, seeded
weights): the page served, the generate body of each mode (text2music,
extract, lego, complete), the dice, every JS fetch route routed, the LoRA
panel's round trip and the batch-8 LRC / score / audio round trip. The
file imports neither JAX nor the JAX package, so it also runs where only
the port is installed.
"""

import http.client
import json
import os
import re
import threading
import time
from urllib.parse import quote

import numpy as np
import pytest
import torch

from acestep_torch.config import DiTConfig, VAEConfig
from acestep_torch.pipeline.handler import AceStepHandler
from acestep_torch.serving import AppState, create_server
from acestep_torch.utils.path_safety import get_safe_root, set_safe_root

ROOT = os.path.join(os.path.dirname(__file__), "..")
STUDIO = os.path.join(ROOT, "acestep_torch", "serving", "studio.html")
JAX_STUDIO = os.path.join(ROOT, "acestep_tpu", "serving", "studio.html")


def _read(path):
    with open(path, "r", encoding="utf-8") as f:
        return f.read()


def _without_comments(html):
    return re.sub(r"<!--.*?-->", "", html, flags=re.S)


def test_page_equals_jax_outside_comments():
    page, jax_page = _read(STUDIO), _read(JAX_STUDIO)
    assert _without_comments(page) == _without_comments(jax_page)
    assert len(_without_comments(page)) > 0.9 * len(page)


@pytest.fixture()
def safe_root(tmp_path):
    """The port's safe root at the test's directory for one test."""
    old = get_safe_root()
    set_safe_root(str(tmp_path))
    yield str(tmp_path)
    set_safe_root(old)


def _request(port, method, route, body=None, timeout=30):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request(method, route, None if body is None else json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    if "json" in (resp.getheader("Content-Type") or ""):
        return resp.status, json.loads(raw.decode())
    return resp.status, raw


def _post(port, route, body):
    return _request(port, "POST", route, body)


def _get(port, route):
    return _request(port, "GET", route)


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("studio")
    handler = AceStepHandler(
        DiTConfig.tiny(fsq_dim=64), VAEConfig.tiny(decoder_input_channels=64),
        dtype=torch.float32, device="cpu", frame_bucket=8, min_frames=8,
        refer_frames=8)
    handler.initialize_service(seed=0)
    state = AppState({"tiny": handler}, None,
                     output_dir=str(tmp_path / "out"),
                     persist_dir=str(tmp_path / "persist"),
                     examples_dir=os.path.join(ROOT, "examples"))
    server = create_server(state, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield handler, state, server.server_address[1], tmp_path
    state.shutdown()
    server.shutdown()
    server.server_close()


def _generate(port, body, timeout=120):
    status, out = _post(port, "/release_task", body)
    assert status == 200, out
    task_id = out["data"]["task_id"]
    deadline = time.time() + timeout
    while time.time() < deadline:
        _, res = _post(port, "/query_result", {"task_id_list": [task_id]})
        entry = res["data"][0]
        if entry["status"] != 0:
            return entry
        time.sleep(0.1)
    raise TimeoutError("generation did not finish")


@pytest.mark.parametrize("route", ["/studio", "/"])
def test_studio_page_served(live, route):
    _, _, port, _ = live
    status, body = _get(port, route)
    assert status == 200
    with open(STUDIO, "rb") as f:
        assert body == f.read()


@pytest.mark.parametrize("mode,extra", [
    ("text2music", {}),
    ("extract", {"track_name": "vocals"}),
    ("lego", {"track_name": "drums", "repainting_start": 0.0,
              "repainting_end": 0.2}),
    ("complete", {"track_classes": ["drums", "bass"]}),
])
def test_generate_modes_over_http(live, mode, extra):
    """The page's generate body for each mode completes through the
    server, and the handler ran that task."""
    handler, _, port, _ = live
    body = {"prompt": "studio smoke", "lyrics": "[inst]",
            "audio_duration": 0.3, "inference_steps": 2,
            "task_type": mode, "seed": 3, "use_random_seed": False, **extra}
    seen = []
    real = handler.generate_music

    def spy(**kw):
        seen.append(kw)
        return real(**kw)

    handler.generate_music = spy
    try:
        entry = _generate(port, body)
    finally:
        del handler.generate_music
    items = json.loads(entry["result"])
    assert entry["status"] == 1, items
    assert items[0]["file"] and os.path.exists(items[0]["file"])
    assert [kw["task"] for kw in seen] == [mode]


def test_dice_endpoint_serves_examples(live):
    _, _, port, _ = live
    status, out = _post(port, "/create_random_sample",
                        {"sample_mode": "custom_mode"})
    assert status == 200
    assert out["data"].get("caption")
    status, out = _post(port, "/create_random_sample",
                        {"sample_mode": "simple_mode"})
    assert status == 200
    assert out["data"].get("description") or out["data"].get("caption")


def test_js_fetch_routes_exist_on_server(live):
    """Every fetch() route in the page's JS is routed by the port's server
    (an unrouted path answers 404 without the JSON envelope)."""
    _, _, port, _ = live
    script = _read(STUDIO).split("<script>")[1].split("</script>")[0]
    routes = set(re.findall(r"api\([`'\"](/[\w/]+)", script))
    routes |= set(re.findall(r"[`'\"](/v1/training/start\w*)[`'\"]", script))
    assert len(routes) >= 15

    def probe(method, route):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request(method, route, body=b"{}" if method == "POST" else None,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = resp.read().decode("utf-8", "replace")
        conn.close()
        return resp.status != 404 or '"code"' in body

    unrouted = [r for r in sorted(routes)
                if not (probe("POST", r) or probe("GET", r))]
    assert not unrouted, f"routes not found on the server: {unrouted}"


@pytest.mark.slow
def test_generate_batch8_lrc_score_audio_roundtrip(live):
    """The Generate tab's full flow: a batch-of-8 request with LRC on ->
    poll -> every item carries its file, LRC text and alignment score ->
    the first item's audio URL serves a WAV."""
    _, _, port, _ = live
    body = {"prompt": "studio batch walk", "lyrics": "la la la la",
            "audio_duration": 0.3, "inference_steps": 2, "batch_size": 8,
            "want_lrc": True, "seed": 5, "use_random_seed": False}
    entry = _generate(port, body, timeout=600)
    items = json.loads(entry["result"])
    assert entry["status"] == 1, items
    assert len(items) == 8
    for item in items:
        assert item["file"] and os.path.exists(item["file"])
        assert "lrc" in item or "lrc_error" in item
        assert "alignment_score" in item or "lrc_error" in item
    status, audio_bytes = _get(port, "/v1/audio?path=" + quote(
        items[0]["file"]))
    assert status == 200
    assert audio_bytes[:4] == b"RIFF" and len(audio_bytes) > 100


def test_lora_panel_roundtrip_over_http(live, safe_root):
    """The LoRA tab's round trip: load a PEFT-layout adapter -> status
    shows it -> scale -> toggle off / on -> unload, the fetch sequence the
    panel's buttons issue; the render under the adapter differs from the
    base and toggled off equals it."""
    from safetensors.numpy import save_file

    handler, _, port, _ = live
    cfg = handler.cfg
    rng = np.random.default_rng(0)
    tensors = {}
    qkv_out = cfg.num_attention_heads * cfg.head_dim
    for layer in range(cfg.num_hidden_layers):
        tensors[f"layers.{layer}.self_attn.q_proj.lora_A.weight"] = \
            rng.standard_normal((2, cfg.hidden_size)).astype(np.float32)
        tensors[f"layers.{layer}.self_attn.q_proj.lora_B.weight"] = \
            rng.standard_normal((qkv_out, 2)).astype(np.float32)
    path = os.path.join(safe_root, "adapter_model.safetensors")
    save_file(tensors, path)

    def render():
        return handler.generate_music("lora panel", audio_duration=0.32,
                                      seeds=4, normalize=False).pred_latents

    base = render()
    status, out = _post(port, "/v1/lora/load",
                        {"lora_path": path, "adapter_name": "studio_t"})
    assert status == 200, out
    status, out = _get(port, "/v1/lora/status")
    assert any(a.get("name") == "studio_t"
               for a in out["data"].get("adapters", [])), out
    status, out = _post(port, "/v1/lora/scale",
                        {"adapter_name": "studio_t", "scale": 0.5})
    assert status == 200 and out["data"]["scale"] == 0.5
    on = render()
    status, out = _post(port, "/v1/lora/toggle", {"use_lora": False})
    assert status == 200 and out["data"]["use_lora"] is False
    off = render()
    status, out = _post(port, "/v1/lora/toggle", {"use_lora": True})
    assert status == 200 and out["data"]["use_lora"] is True
    status, out = _post(port, "/v1/lora/unload", {"adapter_name": "studio_t"})
    assert status == 200
    _, out = _get(port, "/v1/lora/status")
    assert not any(a.get("name") == "studio_t"
                   for a in out["data"].get("adapters", []))
    assert not np.array_equal(on, base)
    np.testing.assert_array_equal(off, base)
