"""Generation timing summary for result payloads.

The reference builds a compact markdown timing summary for every finished
batch and ships it in the `generation_info` field of both the Gradio UI
and the REST results (`acestep/ui/gradio/events/results/generation_info.py
:30-89`, used by `api_server.py:2028-2056`): a generation block (LM + DiT
phase split with a per-song average) and a processing block (file
conversion, scoring, LRC detection).

Same structure here, fed by this stack's time-cost keys: `lm_time_cost`
(planner wall), `dit_total_time_cost` (the whole DiT service call),
`audio_conversion_time`, `auto_score_time`, `auto_lrc_time`.
"""
from __future__ import annotations

from typing import Any, Dict, Optional


def build_generation_info(time_costs: Optional[Dict[str, Any]],
                          num_audios: int,
                          audio_format: str = "flac") -> str:
    """Markdown timing summary; empty string when there is nothing to say
    (no time costs or no audio), matching the reference's early-out."""
    if not time_costs or num_audios <= 0:
        return ""

    songs_label = f"({num_audios} song{'s' if num_audios > 1 else ''})"
    parts = []

    lm_total = float(time_costs.get("lm_time_cost",
                                    time_costs.get("lm_total_time", 0.0)) or 0)
    dit_total = float(time_costs.get("dit_total_time_cost", 0.0) or 0)
    gen_total = lm_total + dit_total
    if gen_total > 0:
        lines = [f"**🎵 Total generation time {songs_label}: "
                 f"{gen_total:.2f}s**",
                 f"- {gen_total / num_audios:.2f}s per song"]
        if lm_total > 0:
            lines.append(f"- LM phase {songs_label}: {lm_total:.2f}s")
        if dit_total > 0:
            lines.append(f"- DiT phase {songs_label}: {dit_total:.2f}s")
        parts.append("\n".join(lines))

    conv = float(time_costs.get("audio_conversion_time", 0.0) or 0)
    score = float(time_costs.get("auto_score_time", 0.0) or 0)
    lrc = float(time_costs.get("auto_lrc_time", 0.0) or 0)
    proc_total = conv + score + lrc
    if proc_total > 0:
        fmt_label = ("WAV 32-bit" if audio_format == "wav32"
                     else audio_format.upper())
        lines = [f"**🔧 Total processing time {songs_label}: "
                 f"{proc_total:.2f}s**"]
        if conv > 0:
            lines.append(f"- to {fmt_label} {songs_label}: {conv:.2f}s")
        if score > 0:
            lines.append(f"- scoring {songs_label}: {score:.2f}s")
        if lrc > 0:
            lines.append(f"- LRC detection {songs_label}: {lrc:.2f}s")
        parts.append("\n".join(lines))

    return "\n\n".join(parts)
