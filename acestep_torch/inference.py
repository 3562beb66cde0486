"""Top-level Python inference API of the port.

`GenerationParams` / `GenerationConfig` / `GenerationResult` with the field
surface of `acestep_tpu/inference.py`, and `generate_music(dit_handler,
llm_handler=None, params, config)`: the optional 5 Hz LM planning phase
(CoT metadata, then audio codes that feed the code-hint render), metadata
merging (user values win), the DiT render, normalisation and saving.
`generate_music_group` renders several compatible single-song requests as
one batch (the serving queue's render coalescing). The planner's other
modes: `analyze_input`, `understand_music`, `create_sample` and
`format_sample`.
"""

from __future__ import annotations

import json
import os
import time
import traceback
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

from acestep_torch.utils import trace
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
    # the reference's default; the FLAC encoder is native (utils/flac.py)
    audio_format: str = "flac"
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


@dataclass
class UnderstandResult:
    caption: str = ""
    lyrics: str = ""
    bpm: Optional[int] = None
    duration: Optional[float] = None
    keyscale: str = ""
    language: str = ""
    timesignature: str = ""
    status_message: str = ""
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


def _build_plan_kwargs(params: GenerationParams, *, lyrics: str,
                       infer_type: str) -> Dict[str, Any]:
    """LM planning kwargs from request params — the ONE place the request's
    LM knob surface maps onto the planner (generate_music and
    analyze_input share it). Mirrors reference inference.py:468-487.

    infer_type: 'llm_dit' generates metadata AND codes; 'dit' is
    metadata-only (reference :447: llm_dit iff need_audio_codes AND
    thinking). CoT-only runs (thinking off, use_cot_* on) plan metadata
    without generating codes. use_cot_caption/language=False drop the
    field from the CoT schema itself (llm_inference.py:1231-1232)."""
    return dict(
        caption=params.caption, lyrics=lyrics,
        temperature=params.lm_temperature,
        metadata_temperature=params.lm_metadata_temperature,
        codes_temperature=params.lm_codes_temperature,
        repetition_penalty=params.lm_repetition_penalty,
        cfg_scale=params.lm_cfg_scale,
        top_k=params.lm_top_k, top_p=params.lm_top_p,
        negative_prompt=params.lm_negative_prompt,
        user_metadata=dict(
            bpm=params.bpm or params.cot_bpm,
            keyscale=params.keyscale or params.cot_keyscale,
            timesignature=params.timesignature or params.cot_timesignature,
            duration=(params.duration if params.duration and
                      params.duration > 0 else params.cot_duration),
            language=(params.vocal_language
                      if params.vocal_language not in ("", "unknown")
                      else None),
        ),
        infer_type=infer_type,
        constrained=params.use_constrained_decoding,
        use_cot_caption=params.use_cot_caption,
        use_cot_language=params.use_cot_language,
        use_cot_metas=params.use_cot_metas,
    )


def _plan_seed(params: GenerationParams) -> int:
    """Plan seed follows the request seed (fixed -> reproducible plan;
    unset/random -> varied plans across requests)."""
    if params.seed is not None and params.seed >= 0:
        return int(params.seed)
    import random as _random

    return _random.randrange(2 ** 31)


def analyze_input(llm_handler, params: GenerationParams) -> Dict[str, Any]:
    """analysis_only mode: metadata planning over caption/lyrics — no
    audio, no codes phase (reference api_server.py:1887-1899). Honors the
    full LM knob surface (pinned metadata, constrained toggle, sampling
    knobs, seed) exactly like the generation planning path."""
    if llm_handler is None:
        return {"success": False, "error": "LLM handler not initialized"}
    try:
        plan = llm_handler.plan(
            seed=_plan_seed(params),
            **_build_plan_kwargs(params, lyrics=params.lyrics or "",
                                 infer_type="dit"))
        return {"success": True, "metadata": plan.get("metadata", {}),
                "cot_text": plan.get("cot_text", "")}
    except Exception as e:
        return {"success": False, "error": str(e)}


def _plan_lm(llm_handler, params: GenerationParams,
             config: GenerationConfig, lyrics: str,
             time_costs: Dict[str, Any]):
    """LM planning stage of generate_music -> (lm_meta, audio_codes)."""
    lm_meta: Dict[str, Any] = {}
    audio_codes = params.audio_codes or None
    # the reference skips the LM entirely for cover/repaint (its
    # skip_lm_tasks, inference.py:390) — edit tasks must not have the
    # LM overwrite the user's caption/metadata (or pay LM latency)
    skip_lm = params.task_type in ("cover", "repaint")
    # CoT knobs request LM planning even with thinking off (reference
    # inference.py:397-398: use_lm = thinking OR need_lm_for_cot)
    need_lm_for_cot = (params.use_cot_caption or params.use_cot_language
                       or params.use_cot_metas)
    if llm_handler is not None and not skip_lm and (
            params.thinking or need_lm_for_cot):
        plan = trace.begin("plan")
        plan_kwargs = _build_plan_kwargs(
            params, lyrics=lyrics,
            infer_type=("llm_dit" if (params.thinking
                                      and params.task_type == "text2music"
                                      and not audio_codes) else "dit"))
        # per-item plans when allowed: each song in a batch gets its own
        # CoT + codes, decoded as ONE batched device loop (plan_batch).
        # When the plan produces no codes (infer_type='dit'), one plan
        # serves the batch.
        n_plans = (config.batch_size
                   if config.allow_lm_batch and config.batch_size > 1
                   and plan_kwargs["infer_type"] == "llm_dit"
                   else 1)
        lm_seed = _plan_seed(params)
        if n_plans > 1 and hasattr(llm_handler, "plan_batch"):
            phases = llm_handler.plan_batch(n=n_plans, seed=lm_seed,
                                            **plan_kwargs)
        else:
            phases = [llm_handler.plan(seed=lm_seed + i, **plan_kwargs)
                      for i in range(n_plans)]
        phase = phases[0]
        lm_meta = phase.get("metadata", {})
        if not params.use_cot_metas:
            # user opted out of LM metadata: keep only caption/language
            lm_meta = {k: v for k, v in lm_meta.items()
                       if k in ("caption", "language")}
        if not audio_codes and any(p.get("audio_codes")
                                   for p in phases):
            # gate on ANY plan having codes: plan 0 coming back empty
            # must not silently drop every other plan's codes
            if n_plans > 1:
                audio_codes = [p.get("audio_codes") or None
                               for p in phases]
            else:
                audio_codes = phase["audio_codes"]
        time_costs["lm_time_cost"] = plan.end()
    return lm_meta, audio_codes


def _audio_entry(dit_handler, params: GenerationParams,
                 config: GenerationConfig, res, i: int, path,
                 meta: Dict[str, Any], lyrics: str,
                 time_costs: Dict[str, Any]) -> Dict[str, Any]:
    """One per-song result entry: uuid key + reproducibility sidecar, and
    with `want_lrc` and sung lyrics the LRC and its alignment score (or
    `lrc_error`), its seconds summed over the batch in `auto_lrc_time`.
    The handler's LoRA state enters the key and the sidecar, so the same
    request under another adapter or scale gets another key."""
    with trace.span("entry"):
        p_dict = params.to_dict()
        p_dict["seed"] = res.seeds[i]
        if getattr(dit_handler, "lora", None) is not None:
            p_dict["lora"] = dit_handler.lora.signature()
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
        if config.want_lrc and lyrics.strip().lower() not in (
                "", "[inst]", "[instrumental]"):
            lrc_span = trace.begin("lrc")
            try:
                lrc = dit_handler.generate_lrc(
                    res.pred_latents[i], meta.get("caption", ""), lyrics,
                    metas={k: v for k, v in meta.items() if k != "caption"},
                    vocal_language=meta.get("language", "en"))
                entry["lrc"] = lrc["lrc"]
                entry["alignment_score"] = lrc["score"]
            except Exception as e:   # noqa: BLE001 — best-effort decoration
                entry["lrc_error"] = str(e)
            time_costs["auto_lrc_time"] = (
                time_costs.get("auto_lrc_time", 0.0) + lrc_span.end())
        return entry


def _request_span(**attrs) -> trace.Span:
    """The `request` span of one facade call: under a server job's span
    it takes the job ids, else a fresh request id."""
    span = trace.begin("request", **attrs)
    if span.recording and not span.requests:
        span.requests = (trace.new_request_id(),)
    return span


def generate_music(dit_handler, llm_handler=None,
                   params: Optional[GenerationParams] = None,
                   config: Optional[GenerationConfig] = None
                   ) -> GenerationResult:
    """Optional LM planning -> DiT render -> save. Errors come back as
    `success=False` with the message, like the JAX facade."""
    params = params or GenerationParams()
    config = config or GenerationConfig()
    request = _request_span()
    time_costs: Dict[str, Any] = {}
    try:
        lyrics = "[Instrumental]" if params.instrumental and not params.lyrics \
            else params.lyrics
        lm_meta, audio_codes = _plan_lm(llm_handler, params, config,
                                        lyrics, time_costs)
        meta = _merge_metadata(params, lm_meta)
        duration = None
        if params.duration and params.duration > 0:
            duration = float(params.duration)
        elif lm_meta.get("duration"):
            try:
                duration = float(lm_meta["duration"])
            except (TypeError, ValueError):
                duration = None
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
        time_costs["total_time_cost"] = time.monotonic() - request.t0
        paths = res.audio_paths or [None] * len(res.audios)
        audios = [_audio_entry(dit_handler, params, config, res, i, path,
                               meta, lyrics, time_costs)
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
    finally:
        request.end()


def generate_music_group(dit_handler, llm_handler,
                         jobs: List[tuple]) -> List[GenerationResult]:
    """Render N compatible single-song requests as ONE batched render.

    The serving queue drains compatible waiting jobs and fuses their
    renders into one batch of N rows with per-item conditioning; LM
    metadata planning stays per request. `jobs` is a list of
    (GenerationParams, GenerationConfig); the caller guarantees
    compatibility (serving.server._coalesce_key): task text2music, pinned
    equal duration, equal sampler and output knobs, no audio inputs, no
    code hints, batch_size 1, no LRC. Per-item caption, lyrics, metadata,
    language and seed are honoured: each row draws its noise from its own
    generator, so item i matches a solo render of its seed up to the
    batch's numerics. Returns one GenerationResult per job with
    generate_music's schema, or one `success=False` result per job."""
    import random as _random

    request = _request_span(songs=len(jobs))
    try:
        per = []
        for params, config in jobs:
            lyrics = ("[Instrumental]"
                      if params.instrumental and not params.lyrics
                      else params.lyrics)
            tc: Dict[str, Any] = {}
            lm_meta, _codes = _plan_lm(llm_handler, params, config,
                                       lyrics, tc)
            per.append({"params": params, "config": config,
                        "lyrics": lyrics,
                        "meta": _merge_metadata(params, lm_meta),
                        "lm_meta": lm_meta, "tc": tc})
        p0, c0 = jobs[0]
        duration = (float(p0.duration)
                    if p0.duration and p0.duration > 0 else None)
        # per-item seeds: each request's pinned seed; a host random for a
        # use_random_seed job, so items stay independent
        seeds = []
        for params, config in jobs:
            if config.seeds is not None:
                seeds.append(int(config.seeds[0]))
            elif params.seed is None or params.seed < 0:
                seeds.append(_random.randint(0, 2**31 - 1))
            else:
                seeds.append(int(params.seed))
        res = dit_handler.generate_music(
            captions=[d["meta"].get("caption") or d["params"].caption
                      for d in per],
            lyrics=[d["lyrics"] for d in per],
            metas=[{k: v for k, v in d["meta"].items() if k != "caption"}
                   for d in per],
            task=p0.task_type,
            vocal_languages=[d["meta"].get("language",
                                           d["params"].vocal_language)
                             for d in per],
            audio_duration=duration,
            batch_size=len(jobs),
            seeds=seeds,
            use_random_seed=False,
            infer_method=p0.infer_method,
            shift=p0.shift,
            infer_steps=p0.inference_steps,
            timesteps=p0.timesteps,
            guidance_scale=p0.guidance_scale,
            use_adg=p0.use_adg,
            cfg_interval=(p0.cfg_interval_start, p0.cfg_interval_end),
            latent_shift=p0.latent_shift,
            latent_rescale=p0.latent_rescale,
            normalize=p0.enable_normalization,
            normalize_db=p0.normalization_db,
            save_dir=c0.output_dir,
            audio_format=c0.audio_format,
        )
        shared = dict(res.time_costs)
        shared["total_time_cost"] = time.monotonic() - request.t0
        shared["coalesced_jobs"] = len(jobs)
        results = []
        paths = res.audio_paths or [None] * len(res.audios)
        for i, d in enumerate(per):
            tc_i = dict(shared)
            tc_i.update(d["tc"])        # this job's own lm_time_cost
            entry = _audio_entry(dit_handler, d["params"], d["config"],
                                 res, i, paths[i], d["meta"], d["lyrics"],
                                 tc_i)
            entry["audio"] = res.audios[i]
            results.append(GenerationResult(
                audios=[entry],
                status_message="success",
                extra_outputs={
                    "time_costs": tc_i,
                    "lm_metadata": d["lm_meta"],
                    "audio_codes": None,
                    "frames": res.extra.get("frames"),
                    "task": res.extra.get("task"),
                    "seeds": [res.seeds[i]],
                    "coalesced_jobs": len(jobs),
                    "pred_latents": res.pred_latents[i:i + 1],
                },
            ))
        return results
    except Exception as e:  # noqa: BLE001 — generate_music's error contract
        tb = traceback.format_exc(limit=5)
        return [GenerationResult(audios=[], success=False, error=f"{e}",
                                 status_message=tb) for _ in jobs]
    finally:
        request.end()


def understand_music(llm_handler, audio_codes: str,
                     temperature: float = 0.85,
                     top_k: Optional[int] = None,
                     top_p: Optional[float] = None,
                     repetition_penalty: float = 1.0,
                     use_constrained_decoding: bool = True,
                     constrained_decoding_debug: bool = False) -> UnderstandResult:
    """LM 'understand' mode: audio codes -> metadata/caption/lyrics.

    Knob surface mirrors the reference facade (inference.py:779-800);
    cfg_scale / negative_prompt are not supported in understand mode.
    `constrained_decoding_debug` is accepted for signature parity."""
    if llm_handler is None:
        return UnderstandResult(success=False, error="LLM handler not initialized")
    try:
        out = llm_handler.understand(
            audio_codes, temperature=temperature,
            top_k=top_k or 0, top_p=top_p if top_p is not None else 1.0,
            repetition_penalty=repetition_penalty,
            use_constrained_decoding=use_constrained_decoding)
        return UnderstandResult(
            caption=out.get("caption", ""), lyrics=out.get("lyrics", ""),
            bpm=out.get("bpm"), duration=out.get("duration"),
            keyscale=out.get("keyscale", ""), language=out.get("language", ""),
            timesignature=out.get("timesignature", ""),
            status_message="success")
    except Exception as e:
        return UnderstandResult(success=False, error=str(e))


def create_sample(llm_handler, query: str = "",
                  temperature: float = 0.85) -> Dict[str, Any]:
    """LM 'inspiration' mode: free-form query -> sample blueprint."""
    if llm_handler is None:
        return {"success": False, "error": "LLM handler not initialized"}
    try:
        return {"success": True, **llm_handler.create_sample(query, temperature=temperature)}
    except Exception as e:
        return {"success": False, "error": str(e)}


def format_sample(llm_handler, caption: str = "", lyrics: str = "",
                  temperature: float = 0.3) -> Dict[str, Any]:
    """LM 'format' mode: normalize user caption/lyrics into the SFT format."""
    if llm_handler is None:
        return {"success": False, "error": "LLM handler not initialized"}
    try:
        return {"success": True,
                **llm_handler.format_sample(caption, lyrics, temperature=temperature)}
    except Exception as e:
        return {"success": False, "error": str(e)}
