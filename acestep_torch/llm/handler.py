"""LLMHandler — 5 Hz LM planner facade.

Port of `acestep_tpu/llm/handler.py`. Capability parity with the reference
acestep/llm_inference.py:
initialization, two-phase generation protocol (phase 1 "cot" metadata inside
<think>...</think>, phase 2 "codes" audio-code stream with EOS blocked until
duration*5 codes), CFG with the "NO USER INPUT" negative-prompt convention,
understand / create-sample / format modes, and output parsing.

One backend: llm/generator.LMEngine, whose decode step replays as a CUDA
graph on the card. Quantized planners (`quantization=`, ops/quant) run
the same engine; `tensor_parallel=n` runs it over a 1 x n mesh of
processes (parallel/mesh.py), the vocabulary and w8a8's `head_q` split
with the heads.
"""

from __future__ import annotations

import os
import re
import weakref
from typing import Any, Dict, List, Optional

import torch

from acestep_torch.config import LMConfig
from acestep_torch.constants import DEFAULT_LM_INSTRUCTION
from acestep_torch.llm.fsm import MetadataFSM, TokenTables
from acestep_torch.llm.generator import LMEngine
from acestep_torch.llm.tokenizer import SimpleTokenizer

# ------------------------------------------------------------------
# Output parsing (reference parse_lm_output :2535-2650)
# ------------------------------------------------------------------

_CODE_RE = re.compile(r"<\|audio_code_\d+\|>")
_INT_FIELDS = ("bpm", "duration", "timesignature")


def parse_lm_output(text: str) -> tuple:
    """-> (metadata dict, audio_codes string)."""
    codes = "".join(_CODE_RE.findall(text))
    m = re.search(r"<think>(.*?)</think>", text, re.DOTALL)
    if m:
        reasoning = m.group(1)
    else:
        reasoning = text.split("<|audio_code_")[0]
    metadata: Dict[str, Any] = {}
    current_key, value_lines = None, []

    def flush():
        nonlocal current_key, value_lines
        if current_key and value_lines:
            val = "\n".join(value_lines).strip()
            if current_key in _INT_FIELDS:
                try:
                    metadata[current_key] = int(val)
                except ValueError:
                    metadata[current_key] = val
            else:
                metadata[current_key] = val
        current_key, value_lines = None, []

    for line in reasoning.split("\n"):
        if line.strip().startswith("<"):
            continue
        if line and not line[0].isspace() and ":" in line:
            flush()
            k, v = line.split(":", 1)
            key = k.strip().lower()
            if key in ("bpm", "caption", "duration", "genres", "keyscale",
                       "language", "timesignature", "lyrics"):
                current_key = key
                if v.strip():
                    value_lines.append(v.strip())
        elif line.startswith((" ", "\t")) and current_key:
            value_lines.append(line)
    flush()
    return metadata, codes


def format_metadata_as_cot(metadata: Dict[str, Any]) -> str:
    """YAML-ish sorted CoT block (reference _format_metadata_as_cot)."""
    items = {}
    for key in ["bpm", "caption", "duration", "keyscale", "language",
                "timesignature"]:
        v = metadata.get(key)
        if v is None or v == "":
            continue
        if key == "timesignature" and isinstance(v, str) and v.endswith("/4"):
            v = v.split("/")[0]
        if isinstance(v, str) and v.isdigit():
            v = int(v)
        items[key] = v
    body = "\n".join(f"{k}: {items[k]}" for k in sorted(items))
    return f"<think>\n{body}\n</think>"


# ------------------------------------------------------------------


class LLMHandler:
    def __init__(self, cfg: Optional[LMConfig] = None, dtype=torch.bfloat16,
                 device=None):
        from acestep_torch.pipeline.handler import resolve_device

        self.device = resolve_device(device)
        self.cfg = cfg or LMConfig.tiny(vocab_size=0)  # replaced at init
        self.dtype = dtype
        self.engine: Optional[LMEngine] = None
        self.tokenizer = None
        self.tables: Optional[TokenTables] = None
        self.max_duration = 600
        self.mesh = None          # parallel.mesh.Mesh of a tp > 1 engine
        self._init_args: Dict[str, Any] = {}
        self.initialized = False

    @property
    def engine(self) -> Optional[LMEngine]:
        """The planner's engine. A tensor-parallel engine whose mesh went
        down (a rank failed a forward) is built again first, from the
        arguments of the last `initialize`, on a new world."""
        if self.mesh is not None and self.mesh.down:
            self._revive()
        return self._engine

    @engine.setter
    def engine(self, engine: Optional[LMEngine]) -> None:
        self._engine = engine

    def _revive(self) -> None:
        from acestep_torch.parallel.mesh import MeshError

        args = dict(self._init_args)
        if isinstance(args["params"], weakref.ref):
            args["params"] = args["params"]()
            if args["params"] is None:
                raise MeshError(
                    "the planner's mesh is down and the model it was "
                    "initialized with is gone: call initialize() again")
        self.initialize(**args)

    # --------------------------------------------------------------

    def initialize(self, checkpoint_dir: Optional[str] = None,
                   cfg: Optional[LMConfig] = None, tokenizer=None,
                   params=None, seed: int = 0,
                   max_duration: int = 600,
                   num_fallback_codes: int = 64,
                   tensor_parallel: int = 1,
                   quantization: Optional[str] = None,
                   kv_quant: Optional[bool] = None,
                   max_len: Optional[int] = None) -> None:
        """Load a checkpoint dir (HF layout) or build the self-contained
        fallback stack (SimpleTokenizer + a seeded random LM drawn on the
        device in the handler's dtype, from a `torch.Generator` seeded
        `seed`).

        params: a `QwenLM` to use as is, or the JAX package's parameter
        tree as numpy arrays (carried across by utils/weights.lm_from_jax).

        max_len: engine context bound. Default auto-sizes to max_duration:
        a 600 s plan's phase 2 is ~3008 code tokens on top of the prompt.
        The KV cache is sized per request from actual lengths, so a larger
        bound costs nothing until a request uses it.

        quantization: int8 / fp8 / w8a8 / int4 (or an alias of
        ops/quant.MODE_ALIASES) stores the trunk's linear weights quantized
        (`lm_head` excluded). A seeded model is quantized layer by layer as
        it is drawn; a loaded one in place, module by module. w8a8 adds an
        int8 copy of the head for the decode window (models/lm.
        build_head_q) and drops an untied float head.

        kv_quant: int8 KV cache (per-vector scales, models/lm.KVCache).
        Default follows the weight mode: on for w8a8, off otherwise.

        tensor_parallel: > 1 shards the planner over a 1 x n mesh of the
        first n ranks (parallel/mesh.make_mesh: this process's world when
        one exists, else n ranks from the handler's device on); the engine
        then decodes eagerly. A model given as `params` is held weakly for
        a rebuild of the mesh (`engine`)."""
        self._init_args = dict(
            checkpoint_dir=checkpoint_dir, cfg=cfg, tokenizer=tokenizer,
            params=weakref.ref(params) if isinstance(params, torch.nn.Module)
            else params, seed=seed, max_duration=max_duration,
            num_fallback_codes=num_fallback_codes,
            tensor_parallel=tensor_parallel, quantization=quantization,
            kv_quant=kv_quant, max_len=max_len)
        from acestep_torch.models.lm import (
            QwenLM, build_head_q, build_lm, init_lm_params,
        )
        from acestep_torch.ops.quant import quantize_module_, resolve_mode

        mode = resolve_mode(quantization) if quantization else None

        self.max_duration = max_duration
        # device-FSM tables are keyed by metadata only — they encode token
        # ids of THIS tokenizer, so a re-initialize must drop them
        self._cot_table_cache = {}
        if checkpoint_dir:
            from acestep_torch.llm.tokenizer import load_hf_tokenizer
            from acestep_torch.utils.checkpoint import load_lm_checkpoint

            self.tokenizer = tokenizer or load_hf_tokenizer(checkpoint_dir)
            # config comes from the checkpoint, not the placeholder default
            self.cfg = cfg or LMConfig.from_checkpoint(checkpoint_dir)
        else:
            self.tokenizer = tokenizer or SimpleTokenizer(
                num_audio_codes=num_fallback_codes)
            self.cfg = cfg or LMConfig.tiny(
                vocab_size=self.tokenizer.vocab_size)
        if isinstance(params, QwenLM):
            model = params
        elif params is not None:
            from acestep_torch.utils.weights import lm_from_jax
            model = lm_from_jax(params, build_lm(self.cfg, self.device,
                                                 self.dtype))
        elif checkpoint_dir:
            model = load_lm_checkpoint(checkpoint_dir, self.cfg, self.device,
                                       self.dtype)
        else:
            gen = torch.Generator(self.device).manual_seed(seed)
            model = init_lm_params(self.cfg, gen, dtype=self.dtype,
                                   quantization=mode)
        if mode:
            quantize_module_(model, mode, exclude_prefixes=("lm_head",))
            if mode == "w8a8":
                model.head_q = build_head_q(model, self.cfg)
                if not self.cfg.tie_word_embeddings:
                    del model.lm_head
        if kv_quant is None:
            kv_quant = mode == "w8a8"
        if max_len is None:
            # codes budget for the longest plan + 2048 tokens of prompt
            # (system + caption + lyrics + CoT) headroom
            max_len = max(4096, int(max_duration) * 5 + 8 + 2048)
        mesh = None
        if tensor_parallel > 1:
            from acestep_torch.parallel.mesh import make_mesh, mesh_devices

            # made before the old mesh lets its world go, so that a world
            # that went down starts again on its own devices
            mesh = make_mesh(1, tensor_parallel,
                             devices=mesh_devices(self.device))
        self.release()
        self.mesh = mesh
        try:
            self.engine = LMEngine(model, self.cfg, self.tokenizer,
                                   dtype=self.dtype, kv_quant=kv_quant,
                                   max_len=max_len, mesh=self.mesh)
        except BaseException:
            self.release()
            raise
        self.tables = TokenTables(self.tokenizer)
        self.genres_vocab = None
        genres_path = os.environ.get("ACESTEP_GENRES_VOCAB") or (
            os.path.join(checkpoint_dir, "genres_vocab.txt")
            if checkpoint_dir else None)
        if genres_path and os.path.exists(genres_path):
            from acestep_torch.llm.fsm import GenresVocab
            self.genres_vocab = GenresVocab(genres_path)
        self.initialized = True

    def initialize_auto(self, size: str = "auto",
                        checkpoint_root: Optional[str] = None,
                        quantization: Optional[str] = None,
                        tensor_parallel: int = 1, seed: int = 0,
                        max_duration: int = 600,
                        kv_quant: Optional[bool] = None) -> Dict[str, Any]:
        """Tier-driven planner init with the reference's downgrade ladder.

        Walks runtime_config.lm_fallback_plan (tier size + quantization,
        then w8a8, then smaller sizes) until one geometry initializes
        without exhausting device memory. `size`/`quantization` override
        the tier's first choice; `checkpoint_root` points at a directory
        holding `acestep-5Hz-lm-{size}` checkpoints (random-weight geometry
        is used when absent). Returns {"size", "quantization",
        "downgraded"}."""
        from acestep_torch.runtime_config import (
            get_global_config, lm_fallback_plan)
        from acestep_torch.utils.memory import (
            is_oom_error, release_device_memory)

        tier = get_global_config()
        if (size and size != "auto") or quantization:
            import dataclasses as _dc
            tier = _dc.replace(
                tier,
                lm_size=size if size and size != "auto" else tier.lm_size,
                lm_quantization=quantization or tier.lm_quantization)
        plan = lm_fallback_plan(tier)
        if not plan:
            raise RuntimeError(
                f"tier {tier.name} has no LM planner budget; pass an "
                "explicit size")
        max_duration = min(max_duration, tier.max_duration_s)
        for i, (try_size, try_quant) in enumerate(plan):
            ckpt = None
            if checkpoint_root:
                cand = os.path.join(checkpoint_root,
                                    f"acestep-5Hz-lm-{try_size}")
                if os.path.isdir(cand):
                    ckpt = cand
            try:
                if ckpt:
                    self.initialize(checkpoint_dir=ckpt, seed=seed,
                                    max_duration=max_duration,
                                    tensor_parallel=tensor_parallel,
                                    quantization=try_quant,
                                    kv_quant=kv_quant)
                else:
                    self.initialize(cfg=LMConfig.for_size(try_size),
                                    tokenizer=SimpleTokenizer(
                                        num_audio_codes=64_000),
                                    seed=seed, max_duration=max_duration,
                                    tensor_parallel=tensor_parallel,
                                    quantization=try_quant,
                                    kv_quant=kv_quant)
                return {"size": try_size, "quantization": try_quant,
                        "downgraded": i > 0}
            except Exception as e:  # noqa: BLE001 — OOM ladder below
                if not is_oom_error(e) or i == len(plan) - 1:
                    raise
                self.initialized = False
                self.engine = None
                # the exception's traceback pins the failed attempt's
                # device tensors: drop it before releasing memory
                del e
                release_device_memory()
        raise AssertionError("unreachable: last plan entry re-raises")

    def release(self) -> None:
        """Drop the engine and shut its mesh down (a tp > 1 planner's
        followers stop with the last mesh of the process)."""
        mesh, self.mesh = self.mesh, None
        if mesh is not None:
            self.engine = None
            self.initialized = False
            mesh.close()

    # --------------------------------------------------------------
    # Prompt building (reference build_formatted_prompt*)
    # --------------------------------------------------------------

    @staticmethod
    def _has_negative(negative_prompt: str) -> bool:
        return bool(negative_prompt) and negative_prompt != "NO USER INPUT"

    def build_formatted_prompt(self, caption: str, lyrics: str = "",
                               is_negative_prompt: bool = False,
                               generation_phase: str = "cot",
                               negative_prompt: str = "NO USER INPUT") -> str:
        if is_negative_prompt:
            if generation_phase == "cot":
                if self._has_negative(negative_prompt):
                    prompt = f"# Caption\n{negative_prompt}\n\n# Lyric\n{lyrics}\n"
                else:
                    prompt = f"# Lyric\n{lyrics}\n"
            else:
                prompt = caption
        else:
            prompt = f"# Caption\n{caption}\n\n# Lyric\n{lyrics}\n"
        return self.tokenizer.apply_chat_template(
            [
                {"role": "system",
                 "content": f"# Instruction\n{DEFAULT_LM_INSTRUCTION}\n\n"},
                {"role": "user", "content": prompt},
            ],
            tokenize=False, add_generation_prompt=True)

    def build_formatted_prompt_with_cot(self, caption: str, lyrics: str,
                                        cot_text: str,
                                        is_negative_prompt: bool = False,
                                        negative_prompt: str = "NO USER INPUT") -> str:
        if is_negative_prompt:
            cot = "<think>\n</think>"
            cap = negative_prompt if self._has_negative(negative_prompt) else caption
        else:
            cot, cap = cot_text, caption
        user_prompt = f"# Caption\n{cap}\n\n# Lyric\n{lyrics}\n"
        formatted = self.tokenizer.apply_chat_template(
            [
                {"role": "system",
                 "content": f"# Instruction\n{DEFAULT_LM_INSTRUCTION}\n\n"},
                {"role": "user", "content": user_prompt},
                {"role": "assistant", "content": cot},
            ],
            tokenize=False, add_generation_prompt=False)
        if not formatted.endswith("\n"):
            formatted += "\n"
        return formatted

    def _cot_tables(self, user_metadata: Optional[dict], genres,
                    caption: Optional[str] = None, *,
                    skip_caption: bool = False,
                    skip_language: bool = False):
        """Cached device-FSM tables per (user metadata, genres, caption
        genre matches, skip flags) shape."""
        from acestep_torch.llm.fsm import match_caption_genres
        from acestep_torch.llm.fsm_device import build_cot_tables

        user = {k: v for k, v in (user_metadata or {}).items()
                if v not in (None, "", "N/A")}
        matched = tuple(match_caption_genres(caption, genres)) if genres \
            else ()
        key = (tuple(sorted((k, str(v)) for k, v in user.items())),
               tuple(genres) if genres else None, matched, self.max_duration,
               skip_caption, skip_language)
        if not hasattr(self, "_cot_table_cache"):
            self._cot_table_cache = {}
        if key not in self._cot_table_cache:
            # caption-matched genre subsets make the key space unbounded on
            # a long-running server: evict oldest entries past a small cap
            while len(self._cot_table_cache) >= 32:
                self._cot_table_cache.pop(next(iter(self._cot_table_cache)))
            self._cot_table_cache[key] = build_cot_tables(
                self.tables, user_metadata=user,
                skip_genres=not genres, skip_caption=skip_caption,
                skip_language=skip_language, genres_vocab=genres,
                caption=caption, max_duration=self.max_duration)
        return self._cot_table_cache[key]

    @staticmethod
    def _phase1_skip(user_metadata, use_cot_metas):
        """(user_clean, skip?) — phase 1 is skipped when the user pinned
        every required meta OR CoT metadata is disabled (reference
        llm_inference.py:1192,1208,1262)."""
        user_clean = {k: v for k, v in (user_metadata or {}).items()
                      if v not in (None, "", "N/A")}
        skip = (not use_cot_metas or all(
            k in user_clean
            for k in ("bpm", "keyscale", "timesignature", "duration")))
        return user_clean, skip

    @staticmethod
    def _skipped_result(user_clean):
        return {"metadata": dict(user_clean), "cot_text": "",
                "audio_codes": "", "raw": ""}

    # --------------------------------------------------------------
    # Two-phase generation (reference generate_with_stop_condition)
    # --------------------------------------------------------------

    def generate_with_stop_condition(
        self, caption: str, lyrics: str = "", *,
        infer_type: str = "llm_dit",       # 'dit' stops after phase 1
        temperature: float = 0.85, cfg_scale: float = 2.0,
        top_k: int = 0, top_p: float = 0.9,
        repetition_penalty: float = 1.0,
        metadata_temperature: Optional[float] = None,
        codes_temperature: Optional[float] = None,
        negative_prompt: str = "NO USER INPUT",
        user_metadata: Optional[dict] = None,
        constrained: bool = True,
        target_duration: Optional[float] = None,
        use_cot_caption: bool = True,
        use_cot_language: bool = True,
        use_cot_metas: bool = True,
        seed: int = 0,
        max_cot_tokens: int = 256,
        max_code_tokens: Optional[int] = None,
    ) -> Dict[str, Any]:
        """Returns {"metadata", "audio_codes", "cot_text", "raw"}.

        Per-phase temperatures (reference
        constrained_logits_processor.py:149-152,1666-1695: the processor
        divides logits by metadata_temperature in CoT states and by
        codes_temperature in codes states): each phase here is its own
        own device loop, so the phase temperature simply replaces the base
        `temperature` for that program. `repetition_penalty` matches
        nanovllm/sampling_params.py:13 (completion tokens only, conditional
        logits, before the CFG mix)."""
        if not self.initialized:
            raise RuntimeError("call initialize() first")
        t_meta = metadata_temperature if metadata_temperature is not None \
            else temperature
        t_codes = codes_temperature if codes_temperature is not None \
            else temperature

        user_clean, skip_phase1 = self._phase1_skip(user_metadata,
                                                     use_cot_metas)
        if skip_phase1:
            metadata = dict(user_clean)
            result: Dict[str, Any] = self._skipped_result(user_clean)
            if infer_type == "dit":
                return result
            return self._generate_codes_phase(
                result, caption, lyrics, metadata,
                target_duration=target_duration, cfg_scale=cfg_scale,
                temperature=t_codes, top_k=top_k, top_p=top_p,
                repetition_penalty=repetition_penalty,
                negative_prompt=negative_prompt, constrained=constrained,
                max_code_tokens=max_code_tokens, seed=seed,
                prefix_state=None, cot_raw="")

        # --- phase 1: CoT
        prompt = self.build_formatted_prompt(caption, lyrics)
        neg = self.build_formatted_prompt(caption, lyrics,
                                          is_negative_prompt=True,
                                          negative_prompt=negative_prompt)
        genres = self.genres_vocab.get() if self.genres_vocab else None
        fsm = MetadataFSM(self.tables, user_metadata=user_metadata,
                          max_duration=self.max_duration,
                          genres_vocab=genres,
                          caption=caption,
                          skip_genres=not genres,
                          skip_caption=not use_cot_caption,
                          skip_language=not use_cot_language,
                          enabled=constrained)
        if constrained:
            # device-resident FSM: the whole CoT phase is one on-device
            # loop (fsm_device.py); replay tokens through the host FSM
            # afterwards to extract metadata.
            tables = self._cot_tables(user_metadata, genres, caption,
                                      skip_caption=not use_cot_caption,
                                      skip_language=not use_cot_language)
            token_ids, prefix_state = self.engine.generate_cot_device(
                prompt, unconditional_prompt=neg, cfg_scale=cfg_scale,
                temperature=t_meta, top_k=top_k, top_p=top_p,
                repetition_penalty=repetition_penalty,
                fsm_tables=tables, max_tokens=max_cot_tokens, seed=seed,
                return_state=True)
            for t in token_ids:
                fsm.advance(t)
            cot_raw = self.tokenizer.decode(token_ids)
        else:
            out = self.engine.generate(
                [prompt], unconditional_prompts=[neg], cfg_scale=cfg_scale,
                temperature=t_meta, top_k=top_k, top_p=top_p,
                repetition_penalty=repetition_penalty,
                max_new_tokens=max_cot_tokens, stop_strings=("</think>",),
                fsms=None, seed=seed)
            cot_raw = out.texts[0]
            prefix_state = None
        metadata, _ = parse_lm_output(cot_raw)
        for k, v in (fsm.metadata() or {}).items():
            metadata.setdefault(k, v)
        result: Dict[str, Any] = {"metadata": metadata, "cot_text": cot_raw,
                                  "audio_codes": "", "raw": cot_raw}
        if infer_type == "dit":
            return result

        # --- phase 2: codes
        return self._generate_codes_phase(
            result, caption, lyrics, metadata,
            target_duration=target_duration, cfg_scale=cfg_scale,
            temperature=t_codes, top_k=top_k, top_p=top_p,
            repetition_penalty=repetition_penalty,
            negative_prompt=negative_prompt, constrained=constrained,
            max_code_tokens=max_code_tokens, seed=seed,
            prefix_state=prefix_state, cot_raw=cot_raw)

    def _generate_codes_phase(self, result, caption, lyrics, metadata, *,
                              target_duration, cfg_scale, temperature,
                              top_k, top_p, repetition_penalty,
                              negative_prompt, constrained,
                              max_code_tokens, seed, prefix_state, cot_raw):
        """Phase 2: duration*5 audio codes conditioned on the CoT text
        (shared by the normal path and the phase-1-skip path)."""
        dur = target_duration or metadata.get("duration") or 30
        try:
            dur = float(dur)
        except (TypeError, ValueError):
            dur = 30.0
        cot_text = format_metadata_as_cot(metadata)
        p2 = self.build_formatted_prompt_with_cot(caption, lyrics, cot_text)
        n2 = self.build_formatted_prompt_with_cot(
            caption, lyrics, cot_text, is_negative_prompt=True,
            negative_prompt=negative_prompt)
        if constrained and max_code_tokens is None:
            # Constrained codes == 'exactly duration*5 audio-code tokens'
            # (constrained_logits_processor.py:1285 EOS blocking) — a static
            # rule, so the whole phase runs as ONE on-device loop with zero
            # per-token host round-trips.
            n_codes = max(1, int(dur * 5))
            # phase-2 prompt extends phase 1's: reuse the phase-1 KV cache
            # for the shared prefix (nano-vllm prefix-caching role)
            codes_idx = self.engine.generate_codes(
                [p2], unconditional_prompts=[n2], cfg_scale=cfg_scale,
                temperature=temperature, top_k=top_k, top_p=top_p,
                repetition_penalty=repetition_penalty,
                n_codes=n_codes, seed=seed + 1, prefix=prefix_state)[0]
            codes = "".join(f"<|audio_code_{c}|>" for c in codes_idx)
            result["audio_codes"] = codes
            result["raw"] = cot_raw + "\n" + codes
            return result

        fsm2 = MetadataFSM(self.tables, phase="codes", enabled=constrained)
        fsm2.begin_codes(target_duration=dur)
        max_codes = max_code_tokens or (int(dur) * 5 + 8)
        out2 = self.engine.generate(
            [p2], unconditional_prompts=[n2], cfg_scale=cfg_scale,
            temperature=temperature, top_k=top_k, top_p=top_p,
            repetition_penalty=repetition_penalty,
            max_new_tokens=max_codes, fsms=[fsm2], seed=seed + 1)
        _, codes = parse_lm_output(out2.texts[0])
        result["audio_codes"] = codes
        result["raw"] = cot_raw + "\n" + out2.texts[0]
        return result

    def plan_batch(
        self, caption: str = "", lyrics: str = "", *, n: int = 1,
        infer_type: str = "llm_dit",
        temperature: float = 0.85, cfg_scale: float = 2.0,
        top_k: int = 0, top_p: float = 0.9,
        repetition_penalty: float = 1.0,
        metadata_temperature: Optional[float] = None,
        codes_temperature: Optional[float] = None,
        negative_prompt: str = "NO USER INPUT",
        user_metadata: Optional[dict] = None,
        constrained: bool = True,
        target_duration: Optional[float] = None,
        use_cot_caption: bool = True,
        use_cot_language: bool = True,
        use_cot_metas: bool = True,
        seed: int = 0,
        max_cot_tokens: int = 256,
        max_code_tokens: Optional[int] = None,
    ) -> List[Dict[str, Any]]:
        """n per-item plans for one request, fully batched on device.

        Phase 1 runs as ONE batched device loop (shared FSM tables — the
        request metadata is identical across items; rows sample
        independently). Phase 2 runs as ONE batched codes loop sized to the
        longest item; shorter rows truncate to their own duration*5.
        Replaces n sequential plan() calls."""
        if not self.initialized:
            raise RuntimeError("call initialize() first")
        t_meta = metadata_temperature if metadata_temperature is not None \
            else temperature
        t_codes = codes_temperature if codes_temperature is not None \
            else temperature
        if n <= 1 or not constrained:
            return [self.generate_with_stop_condition(
                caption, lyrics, infer_type=infer_type,
                temperature=temperature, cfg_scale=cfg_scale, top_k=top_k,
                top_p=top_p, repetition_penalty=repetition_penalty,
                metadata_temperature=metadata_temperature,
                codes_temperature=codes_temperature,
                negative_prompt=negative_prompt,
                user_metadata=user_metadata, constrained=constrained,
                target_duration=target_duration,
                use_cot_caption=use_cot_caption,
                use_cot_language=use_cot_language,
                use_cot_metas=use_cot_metas, seed=seed + i,
                max_cot_tokens=max_cot_tokens,
                max_code_tokens=max_code_tokens) for i in range(n)]

        # every required meta user-pinned, or CoT metadata disabled: no
        # batched phase-1 decode (reference llm_inference.py:1208,1262)
        user_clean, skip_phase1 = self._phase1_skip(user_metadata,
                                                    use_cot_metas)
        if skip_phase1:
            results = [self._skipped_result(user_clean) for _ in range(n)]
            if infer_type == "dit":
                return results
            dur = target_duration or user_clean.get("duration") or 30
            try:
                dur = float(dur)
            except (TypeError, ValueError):
                dur = 30.0
            durations = [dur] * n
            prefix_state = None
            return self._batched_codes_phase(
                results, durations, caption, lyrics,
                cfg_scale=cfg_scale, temperature=t_codes, top_k=top_k,
                top_p=top_p, repetition_penalty=repetition_penalty,
                negative_prompt=negative_prompt, seed=seed,
                prefix_state=prefix_state)

        # --- phase 1: batched CoT
        prompt = self.build_formatted_prompt(caption, lyrics)
        neg = self.build_formatted_prompt(caption, lyrics,
                                          is_negative_prompt=True,
                                          negative_prompt=negative_prompt)
        genres = self.genres_vocab.get() if self.genres_vocab else None
        tables = self._cot_tables(user_metadata, genres, caption,
                                  skip_caption=not use_cot_caption,
                                  skip_language=not use_cot_language)
        token_lists, prefix_state = self.engine.generate_cot_device_batch(
            [prompt] * n, unconditional_prompts=[neg] * n,
            cfg_scale=cfg_scale, temperature=t_meta, top_k=top_k,
            top_p=top_p, repetition_penalty=repetition_penalty,
            fsm_tables=tables, max_tokens=max_cot_tokens,
            seed=seed, return_state=True)

        results: List[Dict[str, Any]] = []
        durations: List[float] = []
        for ids in token_lists:
            fsm = MetadataFSM(self.tables, user_metadata=user_metadata,
                              max_duration=self.max_duration,
                              genres_vocab=genres, caption=caption,
                              skip_genres=not genres,
                              skip_caption=not use_cot_caption,
                              skip_language=not use_cot_language)
            for t in ids:
                fsm.advance(t)
            cot_raw = self.tokenizer.decode(ids)
            metadata, _ = parse_lm_output(cot_raw)
            for k, v in (fsm.metadata() or {}).items():
                metadata.setdefault(k, v)
            results.append({"metadata": metadata, "cot_text": cot_raw,
                            "audio_codes": "", "raw": cot_raw})
            dur = target_duration or metadata.get("duration") or 30
            try:
                dur = float(dur)
            except (TypeError, ValueError):
                dur = 30.0
            durations.append(dur)
        if infer_type == "dit":
            return results

        # --- phase 2: one batched codes loop at the longest row
        return self._batched_codes_phase(
            results, durations, caption, lyrics,
            cfg_scale=cfg_scale, temperature=t_codes, top_k=top_k,
            top_p=top_p, repetition_penalty=repetition_penalty,
            negative_prompt=negative_prompt, seed=seed,
            prefix_state=prefix_state)

    def _batched_codes_phase(self, results, durations, caption, lyrics, *,
                             cfg_scale, temperature, top_k, top_p,
                             repetition_penalty, negative_prompt, seed,
                             prefix_state):
        p2s, n2s, n_codes = [], [], []
        for r, dur in zip(results, durations):
            cot_text = format_metadata_as_cot(r["metadata"])
            p2s.append(self.build_formatted_prompt_with_cot(
                caption, lyrics, cot_text))
            n2s.append(self.build_formatted_prompt_with_cot(
                caption, lyrics, cot_text, is_negative_prompt=True,
                negative_prompt=negative_prompt))
            n_codes.append(max(1, int(dur * 5)))
        codes_rows = self.engine.generate_codes(
            p2s, unconditional_prompts=n2s, cfg_scale=cfg_scale,
            temperature=temperature, top_k=top_k, top_p=top_p,
            repetition_penalty=repetition_penalty,
            n_codes=max(n_codes), seed=seed + 1, prefix=prefix_state)
        for r, row, k in zip(results, codes_rows, n_codes):
            codes = "".join(f"<|audio_code_{c}|>" for c in row[:k])
            r["audio_codes"] = codes
            r["raw"] = r["raw"] + "\n" + codes
        return results

    # --------------------------------------------------------------
    # Facade protocol used by acestep_torch.inference
    # --------------------------------------------------------------

    def plan(self, caption: str = "", lyrics: str = "", **kw) -> Dict[str, Any]:
        return self.generate_with_stop_condition(caption, lyrics, **kw)

    def understand(self, audio_codes: str, temperature: float = 0.85,
                   top_k: int = 0, top_p: float = 1.0,
                   repetition_penalty: float = 1.0,
                   use_constrained_decoding: bool = True,
                   seed: int = 0) -> Dict[str, Any]:
        """Understanding mode: audio codes -> metadata.

        Knob surface mirrors the reference understand_audio_from_codes
        (llm_inference.py:1645-1653). `use_constrained_decoding` applies the
        host-side metadata FSM to the output (the understand output follows
        the same <think> metadata schema as phase 1); cfg_scale/negative
        prompts are unsupported in understand mode (reference :1662).

        Codes are truncated to fit the engine context (the reference caps
        LM context at 4096 and samples the head of long songs)."""
        budget = max(self.engine.max_len - 1024, 256)
        ids = self.tokenizer.encode(audio_codes)
        if len(ids) > budget:
            audio_codes = self.tokenizer.decode(ids[:budget])
        prompt = self.tokenizer.apply_chat_template(
            [
                {"role": "system",
                 "content": "# Instruction\nUnderstand the given musical "
                            "conditions and describe the audio semantics "
                            "accordingly:\n\n"},
                {"role": "user", "content": audio_codes},
            ],
            tokenize=False, add_generation_prompt=True)
        if use_constrained_decoding:
            # Constrained metadata, then free-form lyrics — the reference's
            # "understand" phase (llm_inference.py:1702-1724) — as TWO
            # device loops: the <think> block decodes in ONE loop
            # against device FSM tables (no per-token host
            # round-trips), and the lyrics continuation reuses its KV cache
            # via the prefix machinery, decoding chunked + unconstrained.
            genres = self.genres_vocab.get() if self.genres_vocab else None
            tables = self._cot_tables(None, genres, None)
            ids, state = self.engine.generate_cot_device(
                prompt, temperature=temperature, top_k=top_k, top_p=top_p,
                repetition_penalty=repetition_penalty, fsm_tables=tables,
                max_tokens=512, seed=seed, return_state=True)
            cot_raw = self.tokenizer.decode(ids)
            fsm = MetadataFSM(self.tables, max_duration=self.max_duration,
                              genres_vocab=genres, skip_genres=not genres)
            for t in ids:
                fsm.advance(t)
            out = self.engine.generate(
                [prompt + cot_raw], temperature=temperature,
                top_k=top_k, top_p=top_p,
                repetition_penalty=repetition_penalty,
                max_new_tokens=768, seed=seed + 1, prefix=state,
                seen_tokens=[ids])   # penalty continuity across the phases
            text = cot_raw + out.texts[0]
            metadata, _ = parse_lm_output(text)
            for k, v in (fsm.metadata() or {}).items():
                metadata.setdefault(k, v)
        else:
            out = self.engine.generate(
                [prompt], temperature=temperature, top_k=top_k, top_p=top_p,
                repetition_penalty=repetition_penalty,
                max_new_tokens=1024, seed=seed)
            text = out.texts[0]
            metadata, _ = parse_lm_output(text)
        # lyrics = free-form text after </think> (reference
        # _extract_lyrics_from_output, llm_inference.py:1745-1782)
        m = re.search(r"</think>", text)
        if m and "lyrics" not in metadata:
            after = text[m.end():].strip()
            after = re.sub(r"^#\s*Lyrics?\s*\n", "", after, flags=re.IGNORECASE)
            after = re.sub(r"<\|im_end\|>\s*$", "", after).strip()
            if after:
                metadata["lyrics"] = after
        return metadata

    def create_sample(self, query: str = "", temperature: float = 0.85,
                      top_k: int = 0, top_p: float = 1.0,
                      repetition_penalty: float = 1.0,
                      seed: int = 0) -> Dict[str, Any]:
        """Inspiration mode: free-form query -> blueprint."""
        prompt = self.tokenizer.apply_chat_template(
            [
                {"role": "system",
                 "content": "# Instruction\nExpand the user's input into a "
                            "more detailed and specific musical "
                            "description:\n\n"},
                {"role": "user", "content": query or "surprise me"},
            ],
            tokenize=False, add_generation_prompt=True)
        out = self.engine.generate([prompt], temperature=temperature,
                                   top_k=top_k, top_p=top_p,
                                   repetition_penalty=repetition_penalty,
                                   max_new_tokens=512,
                                   stop_strings=("</think>",), seed=seed)
        metadata, _ = parse_lm_output(out.texts[0])
        return metadata

    def format_sample(self, caption: str = "", lyrics: str = "",
                      temperature: float = 0.3,
                      top_k: int = 0, top_p: float = 1.0,
                      repetition_penalty: float = 1.0,
                      seed: int = 0) -> Dict[str, Any]:
        """Format mode: normalize user inputs into the SFT schema."""
        prompt = self.tokenizer.apply_chat_template(
            [
                {"role": "system",
                 "content": "# Instruction\nFormat the user's input into a "
                            "more detailed and specific musical "
                            "description:\n\n"},
                {"role": "user",
                 "content": f"# Caption\n{caption}\n\n# Lyric\n{lyrics}\n"},
            ],
            tokenize=False, add_generation_prompt=True)
        out = self.engine.generate([prompt], temperature=temperature,
                                   top_k=top_k, top_p=top_p,
                                   repetition_penalty=repetition_penalty,
                                   max_new_tokens=512,
                                   stop_strings=("</think>",), seed=seed)
        metadata, _ = parse_lm_output(out.texts[0])
        return metadata
