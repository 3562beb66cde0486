"""Cross-attention -> lyric timestamps -> LRC.

A copy of `acestep_tpu/scoring/alignment.py`: the port keeps its own, as it
imports nothing of the JAX package.

Capability parity with the reference aligner
(upstream acestep/core/scoring/dit_alignment.py +
core/generation/handler/lyric_timestamp.py): run one early-exit decoder
pass at small t capturing selected cross-attention layers/heads, slice the
lyric span of the packed condition sequence, head-average + median-filter,
DTW the (token x frame) cost matrix, group token timestamps into sentences,
and emit "[mm:ss.xx]" LRC lines.

Framework notes: the packed condition layout here is the fixed concat
[lyrics, timbre, text] (models/dit.py pack order), so the lyric span is
simply [0, lyric_len). Decoder frames are patchified by `patch_size`, so
frame f corresponds to audio time f * patch_size / 25 Hz.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from acestep_torch.scoring.dtw import dtw, median_filter

from acestep_torch.constants import LATENT_RATE

# reference default capture set (handler.py:129)
DEFAULT_CAPTURE = {2: [6], 3: [10, 11], 4: [3], 5: [8, 9], 6: [8]}


@dataclass
class TokenTimestamp:
    token: str
    start: float
    end: float


@dataclass
class SentenceTimestamp:
    text: str
    start: float
    end: float
    tokens: List[TokenTimestamp] = field(default_factory=list)


def preprocess_attention(captured: Dict[int, np.ndarray],
                         lyric_len: int,
                         filter_width: int = 7) -> np.ndarray:
    """{layer: (B, heads, Tq, Tk)} -> (Tq_frames, lyric_len) averaged map.

    Averages every captured layer/head, slices the lyric span of the packed
    condition axis, median-filters along time, and renormalizes per token.
    """
    maps = []
    for probs in captured.values():
        arr = np.asarray(probs, np.float32)
        maps.append(arr.mean(axis=(0, 1)))          # (Tq, Tk)
    attn = np.mean(maps, axis=0)[:, :lyric_len]     # (Tq, lyric)
    attn = attn.T                                    # (lyric, Tq)
    attn = median_filter(attn, filter_width)
    total = attn.sum(axis=1, keepdims=True)
    attn = np.where(total > 0, attn / np.maximum(total, 1e-9), attn)
    return attn


class MusicStampsAligner:
    """Token/sentence timestamps from an attention map.

    `token_strs` are the decoded lyric token strings (one per lyric position,
    padding excluded); newline tokens delimit sentences."""

    def __init__(self, patch_size: int = 2, latent_rate: float = LATENT_RATE):
        self.frame_seconds = patch_size / latent_rate

    def token_timestamps(self, attn: np.ndarray,
                         token_strs: Sequence[str]) -> List[TokenTimestamp]:
        n_tokens = min(len(token_strs), attn.shape[0])
        if n_tokens == 0:
            return []
        cost = -attn[:n_tokens]                      # maximize attention
        text_idx, time_idx = dtw(cost)
        starts = np.full(n_tokens, -1, np.int64)
        ends = np.zeros(n_tokens, np.int64)
        for ti, fi in zip(text_idx, time_idx):
            if starts[ti] < 0:
                starts[ti] = fi
            ends[ti] = fi
        out = []
        for i in range(n_tokens):
            start_s = max(starts[i], 0) * self.frame_seconds
            end_s = (ends[i] + 1) * self.frame_seconds
            out.append(TokenTimestamp(token=token_strs[i], start=start_s,
                                      end=end_s))
        return out

    @staticmethod
    def sentence_timestamps(tokens: List[TokenTimestamp]
                            ) -> List[SentenceTimestamp]:
        sentences: List[SentenceTimestamp] = []
        current: List[TokenTimestamp] = []

        def flush():
            if not current:
                return
            text = "".join(t.token for t in current).strip()
            if text:
                sentences.append(SentenceTimestamp(
                    text=text, start=current[0].start, end=current[-1].end,
                    tokens=list(current)))
            current.clear()

        for tok in tokens:
            if "\n" in tok.token:
                before, _, after = tok.token.partition("\n")
                if before:
                    current.append(TokenTimestamp(before, tok.start, tok.end))
                flush()
                if after.strip():
                    current.append(TokenTimestamp(after, tok.start, tok.end))
            else:
                current.append(tok)
        flush()
        return sentences

    def get_timestamps_and_lrc(self, captured: Dict[int, np.ndarray],
                               token_strs: Sequence[str],
                               lyric_len: Optional[int] = None):
        lyric_len = lyric_len or len(token_strs)
        attn = preprocess_attention(captured, lyric_len)
        tokens = self.token_timestamps(attn, token_strs)
        sentences = self.sentence_timestamps(tokens)
        return tokens, sentences, format_lrc(sentences)


_SCAFFOLD = ("# Languages", "# Lyric", "<|endoftext|>")


def _is_scaffold(text: str) -> bool:
    """Prompt scaffolding (format_lyrics headers, language codes, structure
    tags like [Verse]) — aligned like any token but not lyric content."""
    stripped = text.strip()
    if not stripped or stripped.startswith("#"):
        return True
    if any(tag in stripped for tag in _SCAFFOLD):
        return True
    if stripped.startswith("[") and stripped.endswith("]"):
        return True          # structure tags: [Verse], [Chorus], [inst]
    if len(stripped) <= 3 and stripped.isalpha() and stripped.islower():
        return True          # bare language code line ("en", "zh", ...)
    return False


def format_lrc(sentences: List[SentenceTimestamp]) -> str:
    """'[mm:ss.xx]text' lines (reference dit_alignment.format_lrc); prompt
    scaffolding lines are dropped."""
    lines = []
    for s in sentences:
        if _is_scaffold(s.text):
            continue
        minutes = int(s.start // 60)
        seconds = s.start - minutes * 60
        lines.append(f"[{minutes:02d}:{seconds:05.2f}]{s.text}")
    return "\n".join(lines)
