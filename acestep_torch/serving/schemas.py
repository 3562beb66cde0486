"""Request schema for the REST API.

Mirrors the reference's `GenerateMusicRequest` pydantic model
(acestep/api_server.py:457-541) field-for-field, as a
plain dataclass with a tolerant `from_dict` that accepts the same client
key aliases the reference's RequestParser handles.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

# NOTE: "Generate audio semantic tokens..." is the COVER/LM instruction —
# the handler detects cover mode from that exact phrase. Requests default to
# an empty instruction so the handler resolves the task-specific one
# (constants.TASK_INSTRUCTIONS) from task_type.

# Client-key aliases accepted by the reference's manual RequestParser
# (api_server.py:1061-1171): e.g. "keyscale" vs "key_scale".
_ALIASES = {
    "caption": "prompt",
    "keyscale": "key_scale",
    "timesignature": "time_signature",
    "language": "vocal_language",
    "duration": "audio_duration",
    "steps": "inference_steps",
    "infer_steps": "inference_steps",
    "guidance": "guidance_scale",
    "format": "audio_format",
}


@dataclass
class GenerateMusicRequest:
    prompt: str = ""
    lyrics: str = ""

    # thinking=True => 5 Hz LM generates audio codes (lm-dit behavior);
    # thinking=False => DiT-only. Missing metas may still be LM-filled.
    thinking: bool = False
    sample_mode: bool = False
    sample_query: str = ""
    use_format: bool = False
    model: Optional[str] = None

    bpm: Optional[int] = None
    key_scale: str = ""
    time_signature: str = ""
    vocal_language: str = "en"
    inference_steps: int = 8
    guidance_scale: float = 7.0
    use_random_seed: bool = True
    seed: Union[int, str] = -1

    reference_audio_path: Optional[str] = None
    src_audio_path: Optional[str] = None
    # stdlib-server upload channel (the reference uses multipart uploads,
    # api_server.py:1149-1171): base64-encoded audio bytes + format
    reference_audio_b64: Optional[str] = None
    src_audio_b64: Optional[str] = None
    upload_audio_format: str = "wav"
    audio_duration: Optional[float] = None
    batch_size: Optional[int] = None

    repainting_start: float = 0.0
    repainting_end: Optional[float] = None

    instruction: str = ""      # empty = resolve from task_type
    # pasted <|audio_code_N|> stream (superset of the reference REST
    # schema: its gradio UI routes text2music_audio_code_string straight
    # into params.audio_codes — here the studio goes through this field).
    # Also accepted by full_analysis_only to transcribe codes directly.
    audio_codes: str = ""
    audio_cover_strength: float = 1.0
    task_type: str = "text2music"
    analysis_only: bool = False
    full_analysis_only: bool = False

    use_adg: bool = False
    cfg_interval_start: float = 0.0
    cfg_interval_end: float = 1.0
    infer_method: str = "ode"          # "ode" | "sde"
    shift: float = 3.0
    timesteps: Optional[str] = None    # comma-separated custom timesteps

    audio_format: str = "wav"
    use_tiled_decode: bool = True

    lm_model_path: Optional[str] = None
    lm_backend: str = "jax"

    constrained_decoding: bool = True
    constrained_decoding_debug: bool = False
    want_lrc: bool = False          # attach LRC + alignment score per result
    use_cot_caption: bool = True
    use_cot_language: bool = True
    is_format_caption: bool = False
    allow_lm_batch: bool = True
    track_name: Optional[str] = None
    track_classes: Optional[List[str]] = None

    lm_temperature: float = 0.85
    # per-phase temperature overrides (reference metadata_temperature /
    # codes_temperature, llm_inference.py:282-304); None = lm_temperature
    lm_metadata_temperature: Optional[float] = None
    lm_codes_temperature: Optional[float] = None
    lm_cfg_scale: float = 2.5
    lm_top_k: Optional[int] = None
    lm_top_p: Optional[float] = 0.9
    lm_repetition_penalty: float = 1.0
    lm_negative_prompt: str = "NO USER INPUT"

    @classmethod
    def from_dict(cls, body: Dict[str, Any]) -> "GenerateMusicRequest":
        known = {f.name: f for f in dataclasses.fields(cls)}
        kwargs: Dict[str, Any] = {}
        for key, value in (body or {}).items():
            name = _ALIASES.get(key, key)
            if name not in known or value is None:
                continue
            kwargs[name] = _coerce(known[name].type, value)
        return cls(**kwargs)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _coerce(annot: str, value: Any) -> Any:
    """Light coercion for common client sloppiness (strings for numbers)."""
    if isinstance(value, str):
        text = value.strip()
        if annot in ("int", "Optional[int]"):
            try:
                return int(float(text))
            except ValueError:
                return value
        if annot in ("float", "Optional[float]"):
            try:
                return float(text)
            except ValueError:
                return value
        if annot == "bool":
            return text.lower() in ("1", "true", "yes", "on")
        if annot.startswith(("List[str]", "Optional[List[str]]")):
            # a bare string for a string-list field would otherwise be
            # iterated per character downstream (', '.join garbling)
            return [p.strip() for p in text.split(",") if p.strip()]
    return value
