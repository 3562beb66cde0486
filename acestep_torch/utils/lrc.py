"""LRC lyric-timestamp parsing and WebVTT conversion.

A copy of `acestep_tpu/utils/lrc.py`: the port keeps its own, as it
imports nothing of the JAX package.

The reference results UI turns the LRC produced by lyric alignment into
subtitles synced to the audio player
(`acestep/ui/gradio/events/results/lrc_utils.py:21-165`): it parses
``[MM:SS.cc]``/``[MM:SS.ccc]`` tags (two-digit fractions are centiseconds,
three-digit are milliseconds), drops lines without a timestamp or text,
merges lines that start within 2 s of each other so they stay readable,
and closes each cue at the next cue's start (or the explicit second tag,
the track duration, or +5 s for the final line).

This module is the stateless core of that behavior: pure text -> cue-list
and cue-list -> VTT string transforms. File I/O and player wiring live in
the serving layer (`serving/server.py` route ``/lrc_to_vtt``) and the
studio page, which renders the cues through a JS text track on the
``<audio>`` element.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

# Lines closer together than this merge into one cue
# (reference lrc_utils.py:74 MIN_DISPLAY_DURATION).
MIN_DISPLAY_DURATION = 2.0

_TIMESTAMP = re.compile(r"\[(\d{2}):(\d{2})\.(\d{2,3})\]")


def _tag_seconds(minutes: str, seconds: str, frac: str) -> float:
    f = int(frac)
    return (int(minutes) * 60 + int(seconds)
            + (f / 100.0 if len(frac) == 2 else f / 1000.0))


def parse_lrc_to_subtitles(lrc_text: str,
                           total_duration: Optional[float] = None,
                           ) -> List[Dict[str, Any]]:
    """Parse LRC text into ``{"text", "timestamp": [start, end]}`` cues.

    Mirrors the reference parser exactly (lrc_utils.py:21-118): a second
    timestamp on a line is an explicit end; unterminated cues end at the
    next cue's start, then at ``total_duration``, then at start+5 s; a
    non-positive span is widened to 3 s.
    """
    if not lrc_text or not lrc_text.strip():
        return []

    raw: List[Dict[str, Any]] = []
    for line in lrc_text.strip().split("\n"):
        line = line.strip()
        if not line:
            continue
        tags = _TIMESTAMP.findall(line)
        if not tags:
            continue
        text = _TIMESTAMP.sub("", line).strip()
        if not text:
            continue
        start = _tag_seconds(*tags[0])
        end = _tag_seconds(*tags[1]) if len(tags) >= 2 else None
        raw.append({"start": start, "explicit_end": end, "text": text})

    raw.sort(key=lambda e: e["start"])
    if not raw:
        return []

    merged: List[Dict[str, Any]] = []
    i = 0
    while i < len(raw):
        cur = raw[i]
        text, start, explicit_end = cur["text"], cur["start"], cur["explicit_end"]
        j = i + 1
        while j < len(raw) and raw[j]["start"] - start < MIN_DISPLAY_DURATION:
            text += "\n" + raw[j]["text"]
            if raw[j]["explicit_end"]:
                explicit_end = raw[j]["explicit_end"]
            j += 1
        merged.append({"start": start, "explicit_end": explicit_end,
                       "text": text})
        i = j

    subtitles: List[Dict[str, Any]] = []
    for idx, entry in enumerate(merged):
        start = entry["start"]
        if entry["explicit_end"] is not None:
            end = entry["explicit_end"]
        elif idx + 1 < len(merged):
            end = merged[idx + 1]["start"]
        elif total_duration is not None and total_duration > start:
            end = total_duration
        else:
            end = start + 5.0
        if end <= start:
            end = start + 3.0
        subtitles.append({"text": entry["text"], "timestamp": [start, end]})
    return subtitles


def format_vtt_timestamp(seconds: float) -> str:
    """``HH:MM:SS.mmm`` (reference lrc_utils.py:121-127; we round the
    millisecond field instead of truncating so binary-inexact
    centisecond tags like 65.07 don't land 1 ms low)."""
    total_ms = round(seconds * 1000)
    hours, rem = divmod(total_ms, 3_600_000)
    minutes, rem = divmod(rem, 60_000)
    secs, millis = divmod(rem, 1000)
    return f"{hours:02d}:{minutes:02d}:{secs:02d}.{millis:03d}"


def lrc_to_vtt(lrc_text: str,
               total_duration: Optional[float] = None) -> Optional[str]:
    """LRC text -> a WebVTT document string, or None when there is nothing
    to show (empty input or no timestamped lines) — the caller clears the
    subtitle track in that case, matching the reference's ``gr.update(
    subtitles=None)`` path."""
    if not lrc_text or not lrc_text.strip():
        return None
    subtitles = parse_lrc_to_subtitles(lrc_text, total_duration=total_duration)
    if not subtitles:
        return None
    lines = ["WEBVTT", ""]
    for i, sub in enumerate(subtitles):
        lines.append(str(i + 1))
        lines.append(f"{format_vtt_timestamp(sub['timestamp'][0])} --> "
                     f"{format_vtt_timestamp(sub['timestamp'][1])}")
        lines.append(sub["text"])
        lines.append("")
    return "\n".join(lines)
