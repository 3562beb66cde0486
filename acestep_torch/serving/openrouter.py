"""OpenRouter-compatible chat adapter.

Mirrors the reference adapter (acestep/openrouter_adapter.py):
POST /v1/chat/completions turns a chat conversation into a music-generation
job on the shared queue and returns the audio base64-embedded in an
OpenAI-style completion (streaming SSE or non-streaming JSON). Message
parsing supports <prompt>/<lyrics> tags, a lyrics-shape heuristic, and
input_audio blocks routed to src/reference audio by task type
(ref :142-320).

The reference streams from an asyncio progress queue; here the server is
thread-per-request, so the SSE generator polls the job store, emitting "."
heartbeats every ~2 s — the same wire behavior.
"""

from __future__ import annotations

import base64
import json
import os
import re
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple
from uuid import uuid4

from acestep_torch.serving.schemas import GenerateMusicRequest

MODEL_PREFIX = "acestep"
DEFAULT_AUDIO_FORMAT = "wav"
GENERATION_TIMEOUT = int(os.environ.get("ACESTEP_GENERATION_TIMEOUT", "600"))

_AUDIO_MIME = {"wav": "audio/wav", "flac": "audio/flac", "mp3": "audio/mpeg",
               "opus": "audio/opus", "aac": "audio/aac", "ogg": "audio/ogg"}

_LYRICS_MARKERS = ("[verse", "[chorus", "[bridge", "[intro", "[outro",
                   "[hook", "[pre-chorus", "[refrain", "[inst")


def generate_completion_id() -> str:
    return f"chatcmpl-{uuid4().hex[:24]}"


def model_id_for(name: str) -> str:
    return f"{MODEL_PREFIX}/{name}"


def parse_model_name(model_id: Optional[str]) -> Optional[str]:
    if not model_id:
        return None
    return model_id.split("/", 1)[1] if "/" in model_id else model_id


def audio_to_base64_url(path: str, audio_format: str) -> Optional[str]:
    try:
        with open(path, "rb") as f:
            b64 = base64.b64encode(f.read()).decode("ascii")
    except OSError:
        return None
    mime = _AUDIO_MIME.get(audio_format, "application/octet-stream")
    return f"data:{mime};base64,{b64}"


def sniff_audio_format(data: bytes) -> Optional[str]:
    """Container format from magic bytes; None when unrecognized.

    The request carries ONE upload_audio_format for both src and reference
    uploads (reference schema), so a ref.mp3 next to a src.wav would
    otherwise be written with the wrong extension and fail the
    extension-dispatched decoder (utils/audio.load_audio)."""
    head = data[:16]
    if head[:4] == b"RIFF" and head[8:12] == b"WAVE":
        return "wav"
    if head[:4] == b"fLaC":
        return "flac"
    if head[:4] == b"OggS":
        return "ogg"
    if head[4:8] == b"ftyp":
        return "m4a"
    if head[:3] == b"ID3":
        return "mp3"
    if len(head) >= 2 and head[0] == 0xFF:
        if (head[1] & 0xF6) == 0xF0:
            return "aac"        # ADTS sync
        if (head[1] & 0xE0) == 0xE0:
            return "mp3"        # MPEG audio frame sync
    return None


def base64_to_temp_file(b64_data: str, audio_format: str = "wav") -> str:
    data = base64.b64decode(b64_data)
    audio_format = sniff_audio_format(data) or audio_format
    fd, path = tempfile.mkstemp(suffix=f".{audio_format}",
                                prefix="acestep_or_")
    with os.fdopen(fd, "wb") as f:
        f.write(data)
    return path


def extract_tagged_content(text: str) -> Tuple[Optional[str], Optional[str], str]:
    """Pull <prompt>…</prompt> / <lyrics>…</lyrics> out of a message."""
    prompt = lyrics = None
    remaining = text
    m = re.search(r"<prompt>(.*?)</prompt>", text, re.DOTALL | re.IGNORECASE)
    if m:
        prompt = m.group(1).strip()
        remaining = remaining.replace(m.group(0), "").strip()
    m = re.search(r"<lyrics>(.*?)</lyrics>", text, re.DOTALL | re.IGNORECASE)
    if m:
        lyrics = m.group(1).strip()
        remaining = remaining.replace(m.group(0), "").strip()
    return prompt, lyrics, remaining


def looks_like_lyrics(text: str) -> bool:
    if not text:
        return False
    lowered = text.lower()
    if any(marker in lowered for marker in _LYRICS_MARKERS):
        return True
    lines = [line.strip() for line in text.split("\n") if line.strip()]
    if len(lines) >= 4:
        return sum(len(l) for l in lines) / len(lines) < 60
    return False


def is_instrumental(lyrics: str) -> bool:
    cleaned = (lyrics or "").strip().lower()
    return cleaned in ("", "[inst]", "[instrumental]")


def parse_messages(messages: List[Dict[str, Any]]
                   ) -> Tuple[str, str, List[str], Optional[str], Optional[str]]:
    """Returns (prompt, lyrics, audio_paths, system_instruction, sample_query)."""
    prompt_parts: List[str] = []
    lyrics = ""
    audio_paths: List[str] = []
    system_instruction = None
    has_tags = False

    def take_text(text: str) -> None:
        nonlocal lyrics, has_tags
        text = text.strip()
        t_prompt, t_lyrics, remaining = extract_tagged_content(text)
        if t_prompt is not None or t_lyrics is not None:
            has_tags = True
            if t_prompt:
                prompt_parts.append(t_prompt)
            if t_lyrics:
                lyrics = t_lyrics
            if remaining:
                prompt_parts.append(remaining)
        elif looks_like_lyrics(text):
            lyrics = text
        else:
            prompt_parts.append(text)

    for msg in messages or []:
        role = msg.get("role")
        content = msg.get("content")
        if role == "system":
            if isinstance(content, str):
                system_instruction = content
            continue
        if role != "user":
            continue
        if isinstance(content, str):
            take_text(content)
        elif isinstance(content, list):
            for part in content:
                if not isinstance(part, dict):
                    continue
                if part.get("type") == "text":
                    take_text(part.get("text", ""))
                elif part.get("type") == "input_audio":
                    audio = part.get("input_audio") or {}
                    b64 = audio.get("data", "")
                    fmt = audio.get("format", "wav")
                    if b64:
                        try:
                            audio_paths.append(base64_to_temp_file(b64, fmt))
                        except (ValueError, OSError):
                            pass

    prompt = " ".join(p for p in prompt_parts if p).strip()
    sample_query = None
    # plain chat text with no structure => inspiration ("sample") mode
    if not has_tags and not lyrics and prompt:
        sample_query = prompt
        prompt = ""
    return prompt, lyrics, audio_paths, system_instruction, sample_query


def chat_to_request(body: Dict[str, Any]) -> GenerateMusicRequest:
    """OpenRouter chat body -> GenerateMusicRequest (ref :321-421)."""
    prompt, lyrics, audio_paths, _system, sample_query = parse_messages(
        body.get("messages", []))

    audio_config = body.get("audio_config") or {}
    if body.get("lyrics"):
        lyrics = body["lyrics"]
    if audio_config.get("instrumental") and not lyrics:
        lyrics = "[inst]"

    task_type = body.get("task_type", "text2music")
    reference_audio = src_audio = None
    used = 0
    # audio routing matches the reference adapter (:673-686): ONLY the
    # edit tasks consume audio[0] as src; every other task type — incl.
    # an echoed-back 'music_continuation' — treats audio[0] as the style
    # reference (routing it to src would silently turn continuation into
    # cover-style source conditioning)
    if task_type in ("cover", "repaint", "lego", "extract", "complete"):
        src_audio = audio_paths[0] if audio_paths else None
        reference_audio = audio_paths[1] if len(audio_paths) > 1 else None
        used = min(len(audio_paths), 2)
    elif audio_paths:
        reference_audio = audio_paths[0]
        used = 1
        if task_type == "text2music":
            task_type = "music_continuation"
    for path in audio_paths[used:]:
        # attachments beyond what the task consumes would leak their
        # temp files (the job cleanup only tracks the two request paths)
        try:
            os.unlink(path)
        except OSError:
            pass

    seed = body.get("seed")
    return GenerateMusicRequest(
        prompt=prompt,
        lyrics=lyrics,
        sample_query=sample_query or "",
        sample_mode=bool(body.get("sample_mode") or sample_query),
        bpm=audio_config.get("bpm"),
        key_scale=audio_config.get("key_scale") or "",
        time_signature=audio_config.get("time_signature") or "",
        audio_duration=audio_config.get("duration"),
        vocal_language=audio_config.get("vocal_language") or "en",
        lm_temperature=body.get("temperature", 0.85),
        lm_top_p=body.get("top_p", 0.9),
        lm_top_k=body.get("top_k", 0),
        thinking=bool(body.get("thinking", False)),
        inference_steps=8,
        guidance_scale=body.get("guidance_scale", 7.0),
        seed=seed if seed is not None else -1,
        use_random_seed=seed is None,
        batch_size=body.get("batch_size", 1),
        task_type=task_type,
        reference_audio_path=reference_audio,
        src_audio_path=src_audio,
        repainting_start=body.get("repainting_start", 0.0),
        repainting_end=body.get("repainting_end"),
        audio_cover_strength=body.get("audio_cover_strength", 1.0),
        use_format=bool(body.get("use_format", False)),
        use_cot_caption=bool(body.get("use_cot_caption", True)),
        use_cot_language=bool(body.get("use_cot_language", True)),
        model=parse_model_name(body.get("model")),
        audio_format=audio_config.get("format") or DEFAULT_AUDIO_FORMAT,
    )


def format_lm_content(result: Dict[str, Any]) -> str:
    """Human-readable metadata block for the assistant message (ref :92-123)."""
    extra = result.get("extra_outputs", {}) or {}
    metas = extra.get("lm_metadata", {}) or {}
    lines = ["Music generated successfully."]
    for key in ("caption", "bpm", "duration", "keyscale", "language",
                "timesignature"):
        value = metas.get(key)
        if value not in (None, "", "N/A"):
            lines.append(f"- {key}: {value}")
    return "\n".join(lines)


def first_audio_path(result: Dict[str, Any]) -> Optional[str]:
    for audio in result.get("audios") or []:
        path = audio.get("path")
        if path and os.path.exists(path):
            return path
    return None


def build_completion(rec, model_id: str, audio_format: str) -> Dict[str, Any]:
    """Non-streaming chat.completion payload from a finished JobRecord."""
    result = rec.result or {}
    audio_obj = None
    path = first_audio_path(result)
    if path:
        url = audio_to_base64_url(path, audio_format)
        if url:
            audio_obj = [{"type": "audio_url", "audio_url": {"url": url}}]
    return {
        "id": generate_completion_id(),
        "object": "chat.completion",
        "created": int(time.time()),
        "model": model_id,
        "choices": [{
            "index": 0,
            "message": {
                "role": "assistant",
                "content": format_lm_content(result),
                "audio": audio_obj,
            },
            "finish_reason": "stop",
        }],
        "usage": {"prompt_tokens": 0, "completion_tokens": 0,
                  "total_tokens": 0},
    }


def sse_chunks(state, job_id: str, model_id: str, audio_format: str,
               timeout: float = GENERATION_TIMEOUT,
               heartbeat_s: float = 2.0, poll_s: float = 0.1):
    """Generator of SSE byte chunks; polls the job store until terminal."""
    completion_id = generate_completion_id()
    created = int(time.time())

    def chunk(content=None, role=None, audio=None, finish_reason=None) -> bytes:
        delta: Dict[str, Any] = {}
        if role:
            delta["role"] = role
        if content is not None:
            delta["content"] = content
        if audio is not None:
            delta["audio"] = audio
        payload = {
            "id": completion_id, "object": "chat.completion.chunk",
            "created": created, "model": model_id,
            "choices": [{"index": 0, "delta": delta,
                         "finish_reason": finish_reason}],
        }
        return f"data: {json.dumps(payload)}\n\n".encode("utf-8")

    yield chunk(role="assistant", content="Generating music")
    deadline = time.time() + timeout
    last_beat = time.time()
    while True:
        rec = state.job_store.get(job_id)
        if rec is None:
            # aged out of the store / store restarted — not a timeout
            yield chunk(content="\n\nError: job no longer exists")
            yield chunk(finish_reason="error")
            yield b"data: [DONE]\n\n"
            return
        if time.time() > deadline:
            yield chunk(content="\n\nError: generation timed out")
            yield chunk(finish_reason="error")
            yield b"data: [DONE]\n\n"
            return
        if rec.status == "failed":
            yield chunk(content=f"\n\nError: {rec.error or 'Generation failed'}")
            yield chunk(finish_reason="error")
            yield b"data: [DONE]\n\n"
            return
        if rec.status == "succeeded":
            result = rec.result or {}
            yield chunk(content=f"\n\n{format_lm_content(result)}")
            path = first_audio_path(result)
            if path:
                url = audio_to_base64_url(path, audio_format)
                if url:
                    yield chunk(audio=[{"type": "audio_url",
                                        "audio_url": {"url": url}}])
            yield chunk(finish_reason="stop")
            yield b"data: [DONE]\n\n"
            return
        if time.time() - last_beat >= heartbeat_s:
            yield chunk(content=".")
            last_beat = time.time()
        time.sleep(poll_s)


def models_payload(state) -> Dict[str, Any]:
    """OpenRouter-format model listing (ref openrouter_models.py)."""
    now = int(time.time())
    data = []
    for name in state.dit_handlers:
        data.append({
            "id": model_id_for(name),
            "name": f"ACE-Step PyTorch: {name}",
            "created": now,
            "description": "Music generation (text2music, cover, repaint)",
            "architecture": {
                "modality": "text->audio",
                "input_modalities": ["text", "audio"],
                "output_modalities": ["audio"],
            },
            "pricing": {"prompt": "0", "completion": "0", "request": "0"},
            "context_length": 4096,
        })
    return {"object": "list", "data": data}
