"""Prompt construction + metadata parsing (pure Python, no device code).

Behavior parity targets:
- reference acestep/core/generation/handler/metadata_utils.py
  (_create_default_meta, _dict_to_meta_string, _parse_metas)
- prompt_utils.py (_format_instruction, _format_lyrics,
  extract_caption_from_sft_format, build_dit_inputs)
- task_utils.py (instruction resolution per task, seed preparation)
"""

from __future__ import annotations

import random
import re
from typing import Any, Dict, List, Optional, Sequence, Union

from acestep_torch.constants import (
    DEFAULT_DIT_INSTRUCTION, SFT_GEN_PROMPT, TASK_INSTRUCTIONS,
)

MetaLike = Union[str, Dict[str, Any], None]


# ------------------------------------------------------------------
# Metadata
# ------------------------------------------------------------------


def create_default_meta() -> str:
    return (
        "- bpm: N/A\n"
        "- timesignature: N/A\n"
        "- keyscale: N/A\n"
        "- duration: 30 seconds\n"
    )


def dict_to_meta_string(meta: Dict[str, Any]) -> str:
    bpm = meta.get("bpm", meta.get("tempo", "N/A"))
    timesig = meta.get("timesignature", meta.get("time_signature", "N/A"))
    keyscale = meta.get("keyscale", meta.get("key", meta.get("scale", "N/A")))
    duration = meta.get("duration", meta.get("length", 30))
    if isinstance(duration, (int, float)):
        duration = f"{int(duration)} seconds"
    elif not isinstance(duration, str):
        duration = "30 seconds"
    return (
        f"- bpm: {bpm}\n"
        f"- timesignature: {timesig}\n"
        f"- keyscale: {keyscale}\n"
        f"- duration: {duration}\n"
    )


def parse_metas(metas: Sequence[MetaLike]) -> List[str]:
    out = []
    for meta in metas:
        if meta is None:
            out.append(create_default_meta())
        elif isinstance(meta, str):
            out.append(meta)
        elif isinstance(meta, dict):
            out.append(dict_to_meta_string(meta))
        else:
            out.append(create_default_meta())
    return out


def build_metadata_dict(bpm=None, key_scale: str = "", time_signature: str = "",
                        duration: Optional[float] = None) -> Dict[str, Any]:
    d: Dict[str, Any] = {
        "bpm": bpm if bpm else "N/A",
        "keyscale": key_scale if key_scale and key_scale.strip() else "N/A",
        "timesignature": time_signature
        if time_signature and time_signature.strip() and time_signature != "N/A"
        else "N/A",
    }
    if duration is not None:
        d["duration"] = f"{int(duration)} seconds"
    return d


def meta_dict_of(meta: MetaLike) -> Dict[str, Any]:
    """Best-effort dict view of a meta value (for caption/language overrides)."""
    if isinstance(meta, dict):
        return meta
    if isinstance(meta, str):
        d: Dict[str, Any] = {}
        for line in meta.splitlines():
            m = re.match(r"-\s*(\w+)\s*:\s*(.+)", line.strip())
            if m:
                d[m.group(1).lower()] = m.group(2).strip()
        return d
    return {}


# ------------------------------------------------------------------
# Prompts
# ------------------------------------------------------------------


def format_instruction(instruction: Optional[str]) -> str:
    instruction = instruction or DEFAULT_DIT_INSTRUCTION
    return instruction if instruction.endswith(":") else instruction + ":"


def format_lyrics(lyrics: str, language: str) -> str:
    return f"# Languages\n{language}\n\n# Lyric\n{lyrics}<|endoftext|>"


def extract_caption_from_sft_format(caption: str) -> str:
    try:
        if "# Instruction" in caption and "# Caption" in caption:
            m = re.search(r"#\s*Caption\s*\n(.*?)(?:\n\s*#\s*Metas|$)", caption,
                          re.DOTALL)
            if m:
                return m.group(1).strip()
        return caption
    except (AttributeError, TypeError):
        return caption


def resolve_instruction(task: str, *, track_name: Optional[str] = None,
                        track_classes: Optional[Sequence[str]] = None) -> str:
    """Task -> instruction text, incl. Extract/Lego/Complete track templating
    (the reference realizes 'vocal2bgm'-style tasks this way,
    constants.py:117-136)."""
    task = (task or "text2music").lower()
    # formatting matches the reference EXACTLY (task_utils.py:66-100):
    # UPPERCASED names and " | " separators are the strings the model was
    # trained on — ", ".join(lowercase) conditions on out-of-distribution
    # instruction text. No TRACK_NAMES membership gate either: the
    # reference formats whatever name the caller passes.
    if task in ("extract", "lego"):
        if track_name:
            return TASK_INSTRUCTIONS[task].format(
                TRACK_NAME=str(track_name).upper())
        return TASK_INSTRUCTIONS[f"{task}_default"]
    if task == "complete":
        if track_classes:
            return TASK_INSTRUCTIONS[task].format(
                TRACK_CLASSES=" | ".join(
                    str(t).upper() for t in track_classes))
        return TASK_INSTRUCTIONS["complete_default"]
    return TASK_INSTRUCTIONS.get(task, DEFAULT_DIT_INSTRUCTION)


def extract_caption_and_language(metas: Sequence[MetaLike],
                                 captions: Sequence[str],
                                 languages: Sequence[str]):
    """Caption/language from metas win over the direct arguments."""
    out_c, out_l = list(captions), list(languages)
    for i, meta in enumerate(metas):
        if i >= len(out_c):
            break
        d = meta_dict_of(meta)
        if d.get("caption"):
            out_c[i] = str(d["caption"])
        # languages may be shorter than captions for direct callers — the
        # handler pre-normalizes to B, but the bounds contract must hold
        # for both lists, not just captions
        if d.get("language") and i < len(out_l):
            out_l[i] = str(d["language"])
    return out_c, out_l


def build_text_prompt(instruction: str, caption: str, meta_str: str) -> str:
    return SFT_GEN_PROMPT.format(format_instruction(instruction), caption, meta_str)


def build_dit_inputs(task: str, instruction: Optional[str], caption: str,
                     lyrics: str, metas: MetaLike = None,
                     vocal_language: str = "en",
                     track_name: Optional[str] = None,
                     track_classes: Optional[Sequence[str]] = None):
    """(caption_input, lyrics_input) for the two text-encoder branches.

    track_name/track_classes feed the extract/lego/complete instruction
    templates exactly like the handler path (handler.py passes them to
    resolve_instruction) — without them those tasks silently fell back to
    the *_default instruction."""
    final_instruction = format_instruction(instruction or
                                           resolve_instruction(
                                               task, track_name=track_name,
                                               track_classes=track_classes))
    d = meta_dict_of(metas)
    actual_caption = str(d["caption"]) if d.get("caption") else caption
    actual_language = str(d["language"]) if d.get("language") else vocal_language
    meta_str = parse_metas([metas])[0]
    return (build_text_prompt(final_instruction, actual_caption, meta_str),
            format_lyrics(lyrics, actual_language))


# ------------------------------------------------------------------
# Seeds (reference task_utils.prepare_seeds)
# ------------------------------------------------------------------


def prepare_seeds(batch_size: int, seeds: Union[None, int, str, Sequence[int]] = None,
                  use_random: bool = False) -> List[int]:
    """Normalize a seed spec to one int per batch item. Strings may be
    comma-separated. -1/None entries become fresh random seeds."""
    if use_random or seeds is None or seeds == "":
        return [random.randint(0, 2 ** 31 - 1) for _ in range(batch_size)]
    if isinstance(seeds, str):
        parts = [p.strip() for p in seeds.split(",") if p.strip()]
        seeds = [int(p) for p in parts] if parts else None
        if seeds is None:
            return [random.randint(0, 2 ** 31 - 1) for _ in range(batch_size)]
    if isinstance(seeds, int):
        seeds = [seeds]
    if not seeds:                     # [] behaves like None: all random
        return [random.randint(0, 2 ** 31 - 1) for _ in range(batch_size)]
    # reference semantics (task_utils.prepare_seeds): a single fixed seed
    # pins item 0 and the REST are random (replicating it would render
    # batch_size identical songs); short lists pad with random, never cycle
    single = len(seeds) == 1 and seeds[0] is not None and seeds[0] >= 0
    out = []
    for i in range(batch_size):
        s = seeds[i] if i < len(seeds) else None
        if single and i > 0:
            s = None
        out.append(random.randint(0, 2 ** 31 - 1) if s is None or s < 0 else int(s))
    return out
