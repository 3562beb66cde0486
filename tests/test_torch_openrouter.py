"""The port's OpenRouter chat adapter against the JAX package's: the same
chat bodies parse into equal requests, and the live servers (each over the
fake DiT handler of test_torch_serving) answer non-streaming and streaming
completions and the model listing with equal shapes once ids, creation
times and the model card's name are replaced by markers. Exact equality
throughout."""

import base64
import http.client
import io
import json
import os
import wave

import pytest

from acestep_tpu.serving import openrouter as jor
from acestep_torch.serving import openrouter as tor
from test_torch_serving import Server


def _wav_b64():
    buf = io.BytesIO()
    with wave.open(buf, "wb") as f:
        f.setnchannels(2)
        f.setsampwidth(2)
        f.setframerate(48000)
        f.writeframes(b"\x01\x00" * 2 * 480)
    return base64.b64encode(buf.getvalue()).decode()


def _audio_part(fmt="wav"):
    return {"type": "input_audio",
            "input_audio": {"data": _wav_b64(), "format": fmt}}


BODIES = {
    "tagged": {"model": "acestep/acestep-v15-turbo", "seed": 5,
               "messages": [{"role": "user", "content":
                             "make it fast <prompt>synthwave</prompt>\n"
                             "<lyrics>[Verse]\nhello</lyrics>"}],
               "audio_config": {"duration": 30, "format": "flac",
                                "bpm": 120, "vocal_language": "ja"}},
    "plain_chat": {"messages": [
        {"role": "system", "content": "you write songs"},
        {"role": "user", "content": "a happy summer song about surfing. "
         "Something uplifting with lots of major chords all around."}]},
    "lyrics_shape": {"messages": [{"role": "user", "content":
                                   "line one\nline two\nline three\n"
                                   "line four"}],
                     "temperature": 0.7, "top_p": 0.8, "top_k": 20},
    "cover_audio": {"task_type": "cover", "messages": [{"role": "user",
                    "content": [{"type": "text", "text":
                                 "<prompt>rock cover</prompt>"},
                                _audio_part(), _audio_part("mp3"),
                                _audio_part()]}],
                    "audio_cover_strength": 0.6},
    "continuation": {"messages": [{"role": "user", "content": [
        {"type": "text", "text": "<prompt>continue this</prompt>"},
        _audio_part()]}]},
    "instrumental": {"lyrics": "", "thinking": True, "batch_size": 2,
                     "audio_config": {"instrumental": True},
                     "messages": [{"role": "user",
                                   "content": "<prompt>ambient</prompt>"}],
                     "use_format": True, "guidance_scale": 5.0},
    "repaint": {"task_type": "repaint", "repainting_start": 2.0,
                "repainting_end": 9.5, "messages": [{"role": "user",
                "content": [_audio_part(), {"type": "text",
                                            "text": "<prompt>fix</prompt>"}]}]},
}


def _parsed(mod, body):
    req = mod.chat_to_request(json.loads(json.dumps(body))).to_dict()
    for key in ("src_audio_path", "reference_audio_path"):
        path = req[key]
        if path:
            with open(path, "rb") as f:
                req[key] = ("<tmp>", os.path.splitext(path)[1], f.read())
            os.unlink(path)
    return req


@pytest.mark.parametrize("name", list(BODIES))
def test_chat_bodies_parse_equal(name):
    assert _parsed(tor, BODIES[name]) == _parsed(jor, BODIES[name])


@pytest.mark.parametrize("name", ["tagged", "cover_audio"])
def test_parse_messages_equal(name):
    def parsed(mod):
        prompt, lyrics, paths, system, query = mod.parse_messages(
            BODIES[name]["messages"])
        blobs = []
        for p in paths:
            with open(p, "rb") as f:
                blobs.append((os.path.splitext(p)[1], f.read()))
            os.unlink(p)
        return prompt, lyrics, blobs, system, query

    assert parsed(tor) == parsed(jor)


def _norm(x, key=None):
    if key == "created" or (key == "id" and str(x).startswith("chatcmpl-")):
        return "<v>"
    if key == "name" and isinstance(x, str) and x.startswith("ACE-Step"):
        return "<card>"
    if isinstance(x, dict):
        return {k: _norm(v, k) for k, v in x.items()}
    if isinstance(x, list):
        return [_norm(v) for v in x]
    return x


@pytest.fixture()
def chat_servers(tmp_path):
    made = {side: Server(side, str(tmp_path / side))
            for side in ("jax", "torch")}
    yield made
    for s in made.values():
        s.close()


def _stream(srv, body):
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
    conn.request("POST", "/v1/chat/completions", json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    raw = resp.read().decode()
    conn.close()
    events = [line[6:] for line in raw.splitlines()
              if line.startswith("data: ")]
    parsed = [json.loads(e) if e != "[DONE]" else e for e in events]
    # heartbeats ('.') depend on timing
    return resp.status, [e for e in parsed if e == "[DONE]" or
                         e["choices"][0]["delta"].get("content") != "."]


def test_completions_and_models_equal(chat_servers):
    body = dict(BODIES["tagged"])
    body["audio_config"] = {"duration": 10, "format": "wav"}
    got = {}
    for side, srv in chat_servers.items():
        status, out = srv.post("/v1/chat/completions", body)
        s_status, events = _stream(srv, dict(body, stream=True))
        m_status, models = srv.get("/v1/chat/models")
        got[side] = _norm([status, out, s_status, events, m_status, models])
    assert got["torch"] == got["jax"]
    status, out, s_status, events, _, models = got["torch"]
    assert status == 200 and s_status == 200
    url = out["choices"][0]["message"]["audio"][0]["audio_url"]["url"]
    assert url.startswith("data:audio/wav;base64,")
    assert events[-1] == "[DONE]"
    assert models["data"][0]["id"] == "acestep/acestep-v15-turbo"
    _, listing = chat_servers["torch"].get("/v1/chat/models")
    assert listing["data"][0]["name"] == "ACE-Step PyTorch: acestep-v15-turbo"
