"""Top-level Python inference API of the port.

`GenerationParams` / `GenerationConfig` / `GenerationResult` with the field
surface of `acestep_tpu/inference.py`, and `generate_music(dit_handler,
llm_handler=None, params, config)`: metadata merging (user values win), the
DiT render, normalisation and saving. The 5 Hz LM planning phase is not
ported yet, so the facade runs as with `thinking=False` and no planner.
"""

from __future__ import annotations

import json
import os
import time
import traceback
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

from acestep_torch.utils.audio import generate_uuid_from_params

# ------------------------------------------------------------------
# Dataclasses (the field surface of acestep_tpu/inference.py)
# ------------------------------------------------------------------


@dataclass
class GenerationParams:
    task_type: str = "text2music"
    # empty = resolve the task-specific instruction (repaint/cover/extract/
    # lego/complete templates) in the handler; a non-empty value overrides
    instruction: str = ""

    reference_audio: Optional[str] = None
    src_audio: Optional[str] = None
    audio_codes: str = ""
    track_name: Optional[str] = None          # extract/lego templates
    track_classes: Optional[List[str]] = None  # complete template

    caption: str = ""
    lyrics: str = ""
    instrumental: bool = False

    vocal_language: str = "unknown"
    bpm: Optional[int] = None
    keyscale: str = ""
    timesignature: str = ""
    duration: float = -1.0

    enable_normalization: bool = True
    normalization_db: float = -1.0
    latent_shift: float = 0.0
    latent_rescale: float = 1.0

    inference_steps: int = 8
    seed: int = -1
    guidance_scale: float = 7.0
    use_adg: bool = False
    cfg_interval_start: float = 0.0
    cfg_interval_end: float = 1.0
    shift: float = 1.0
    infer_method: str = "ode"
    timesteps: Optional[List[float]] = None

    repainting_start: float = 0.0
    repainting_end: float = -1
    audio_cover_strength: float = 1.0
    cover_noise_strength: float = 0.0

    thinking: bool = True
    lm_temperature: float = 0.85
    # optional per-phase overrides (reference metadata_temperature /
    # codes_temperature, llm_inference.py:282-304): None = use lm_temperature
    lm_metadata_temperature: Optional[float] = None
    lm_codes_temperature: Optional[float] = None
    lm_repetition_penalty: float = 1.0
    lm_cfg_scale: float = 2.0
    lm_top_k: int = 0
    lm_top_p: float = 0.9
    lm_negative_prompt: str = "NO USER INPUT"
    use_cot_metas: bool = True
    use_cot_caption: bool = True
    use_cot_lyrics: bool = False
    use_cot_language: bool = True
    use_constrained_decoding: bool = True

    cot_bpm: Optional[int] = None
    cot_keyscale: str = ""
    cot_timesignature: str = ""
    cot_duration: Optional[float] = None
    cot_vocal_language: str = "unknown"
    cot_caption: str = ""
    cot_lyrics: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)


@dataclass
class GenerationConfig:
    batch_size: int = 2
    allow_lm_batch: bool = False
    use_random_seed: bool = True
    seeds: Optional[List[int]] = None
    lm_batch_chunk_size: int = 8
    constrained_decoding_debug: bool = False
    # wav by default: the native FLAC encoder is not ported yet (flac and
    # the other compressed formats go through ffmpeg when it is present)
    audio_format: str = "wav"
    output_dir: str = "outputs"
    want_lrc: bool = False      # per-result LRC + alignment score

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)


@dataclass
class GenerationResult:
    audios: List[Dict[str, Any]] = field(default_factory=list)
    status_message: str = ""
    extra_outputs: Dict[str, Any] = field(default_factory=dict)
    success: bool = True
    error: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)


# ------------------------------------------------------------------
# Metadata merge (user wins)
# ------------------------------------------------------------------


def _merge_metadata(params: GenerationParams, lm_meta: Dict[str, Any]) -> Dict[str, Any]:
    meta: Dict[str, Any] = {}
    meta["bpm"] = params.bpm if params.bpm else lm_meta.get("bpm", "N/A")
    meta["keyscale"] = params.keyscale or lm_meta.get("keyscale", "N/A")
    meta["timesignature"] = (params.timesignature
                             or lm_meta.get("timesignature", "N/A"))
    if params.duration and params.duration > 0:
        meta["duration"] = f"{int(params.duration)} seconds"
    elif lm_meta.get("duration"):
        try:
            meta["duration"] = f"{int(float(lm_meta['duration']))} seconds"
        except (TypeError, ValueError):   # unconstrained LM may emit text
            pass
    caption = params.caption
    if not caption and (lm_meta.get("caption") or params.cot_caption):
        caption = str(lm_meta.get("caption") or params.cot_caption)
    elif params.use_cot_caption and lm_meta.get("caption"):
        caption = str(lm_meta["caption"])
    language = params.vocal_language
    if (language in ("", "unknown") or params.use_cot_language) and \
            (lm_meta.get("language")
             or params.cot_vocal_language not in ("", "unknown")):
        language = str(lm_meta.get("language")
                       or params.cot_vocal_language)
    meta["caption"] = caption
    meta["language"] = language
    return meta


# ------------------------------------------------------------------
# Main entry
# ------------------------------------------------------------------


def _audio_entry(params: GenerationParams, res, i: int, path
                 ) -> Dict[str, Any]:
    """One per-song result entry: uuid key + reproducibility sidecar."""
    p_dict = params.to_dict()
    p_dict["seed"] = res.seeds[i]
    entry = {
        "path": path,
        "key": generate_uuid_from_params(p_dict),
        "seed": res.seeds[i],
        "params": p_dict,
        "sample_rate": res.sample_rate,
    }
    if path:
        sidecar = os.path.splitext(path)[0] + ".json"
        try:
            with open(sidecar, "w", encoding="utf-8") as f:
                json.dump(p_dict, f, indent=2, ensure_ascii=False)
            entry["params_path"] = sidecar
        except OSError:
            pass             # best-effort decoration
    return entry


def generate_music(dit_handler, llm_handler=None,
                   params: Optional[GenerationParams] = None,
                   config: Optional[GenerationConfig] = None
                   ) -> GenerationResult:
    """DiT render -> save. Errors come back as `success=False` with the
    message, like the JAX facade."""
    params = params or GenerationParams()
    config = config or GenerationConfig()
    t0 = time.time()
    time_costs: Dict[str, Any] = {}
    try:
        if llm_handler is not None:
            raise NotImplementedError(
                "the 5 Hz LM planner is not ported yet: pass "
                "llm_handler=None (the thinking=False path)")
        if config.want_lrc:
            raise NotImplementedError(
                "LRC alignment is not ported yet (scoring slice)")
        lyrics = "[Instrumental]" if params.instrumental and not params.lyrics \
            else params.lyrics
        lm_meta: Dict[str, Any] = {}
        audio_codes = params.audio_codes or None
        meta = _merge_metadata(params, lm_meta)
        duration = float(params.duration) if params.duration and \
            params.duration > 0 else None
        seeds = config.seeds if config.seeds is not None else (
            None if params.seed is None or params.seed < 0 else params.seed)

        res = dit_handler.generate_music(
            captions=meta.get("caption") or params.caption,
            lyrics=lyrics,
            metas={k: v for k, v in meta.items() if k not in ("caption",)},
            task=params.task_type,
            instructions=params.instruction or None,
            vocal_languages=meta.get("language", params.vocal_language),
            audio_duration=duration,
            batch_size=config.batch_size,
            seeds=seeds,
            use_random_seed=config.use_random_seed and config.seeds is None
            and (params.seed is None or params.seed < 0),
            src_audio=(None if params.task_type == "text2music"
                       else params.src_audio),
            refer_audios=params.reference_audio,
            audio_code_hints=audio_codes,
            repainting_start=(params.repainting_start
                              if params.task_type in ("repaint", "lego")
                              else None),
            repainting_end=(None if params.repainting_end is None
                            or params.repainting_end < 0
                            else params.repainting_end)
            if params.task_type in ("repaint", "lego") else None,
            audio_cover_strength=params.audio_cover_strength,
            cover_noise_strength=params.cover_noise_strength,
            infer_method=params.infer_method,
            shift=params.shift,
            infer_steps=params.inference_steps,
            timesteps=params.timesteps,
            guidance_scale=params.guidance_scale,
            use_adg=params.use_adg,
            cfg_interval=(params.cfg_interval_start, params.cfg_interval_end),
            track_name=params.track_name,
            track_classes=params.track_classes,
            latent_shift=params.latent_shift,
            latent_rescale=params.latent_rescale,
            normalize=params.enable_normalization,
            normalize_db=params.normalization_db,
            save_dir=config.output_dir,
            audio_format=config.audio_format,
        )
        time_costs.update(res.time_costs)
        time_costs["total_time_cost"] = time.time() - t0
        paths = res.audio_paths or [None] * len(res.audios)
        audios = [_audio_entry(params, res, i, path)
                  for i, path in enumerate(paths)]
        for entry, audio in zip(audios, res.audios):
            entry["audio"] = audio
        return GenerationResult(
            audios=audios,
            status_message="success",
            extra_outputs={
                "time_costs": time_costs,
                "lm_metadata": lm_meta,
                "audio_codes": audio_codes,
                "frames": res.extra.get("frames"),
                "task": res.extra.get("task"),
                "seeds": res.seeds,
                "pred_latents": res.pred_latents,
            },
        )
    except Exception as e:  # noqa: BLE001 — the error-payload contract
        return GenerationResult(
            audios=[], success=False, error=f"{e}",
            status_message=traceback.format_exc(limit=5))
