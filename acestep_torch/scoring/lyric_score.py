"""Alignment-quality score for generated songs.

A copy of `acestep_tpu/scoring/lyric_score.py`: the port keeps its own, as it
imports nothing of the JAX package.

Capability parity with the reference's `MusicLyricScorer`
(upstream acestep/core/scoring/dit_score.py): a 0-1 score for how
well the rendered audio follows the lyrics, computed from the same
cross-attention map used for LRC. The score combines:

- coverage: fraction of lyric tokens whose attention mass is meaningfully
  concentrated (not uniform noise),
- monotonicity: fraction of DTW path steps that move forward in time as the
  text advances (singing follows lyric order),
- confidence: mean attention probability along the DTW path, normalized
  against the uniform baseline.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from acestep_torch.scoring.alignment import preprocess_attention
from acestep_torch.scoring.dtw import dtw


def lyric_alignment_score(captured: Dict[int, np.ndarray],
                          lyric_len: int) -> dict:
    """Returns {score, coverage, monotonicity, confidence}."""
    attn = preprocess_attention(captured, lyric_len)   # (tokens, frames)
    n_tokens, n_frames = attn.shape
    if n_tokens == 0 or n_frames == 0:
        return {"score": 0.0, "coverage": 0.0, "monotonicity": 0.0,
                "confidence": 0.0}

    uniform = 1.0 / n_frames
    peak = attn.max(axis=1)
    coverage = float(np.mean(peak > 3.0 * uniform))

    text_idx, time_idx = dtw(-attn)
    if len(text_idx) > 1:
        d_text = np.diff(text_idx)
        d_time = np.diff(time_idx)
        moved = d_text > 0
        # strict: the DTW path's time indices are non-decreasing by
        # construction, so `>= 0` would be vacuously 1.0; a token advance
        # only counts as monotonic when audio time actually advances too
        # (degenerate all-tokens-on-one-frame alignments score 0 here)
        monotonic = np.mean(d_time[moved] > 0) if moved.any() else 0.0
    else:
        monotonic = 0.0
    confidence_raw = float(np.mean(attn[text_idx, time_idx]))
    confidence = float(np.clip(confidence_raw / (5.0 * uniform), 0.0, 1.0))

    score = float(np.clip(0.4 * coverage + 0.3 * float(monotonic)
                          + 0.3 * confidence, 0.0, 1.0))
    return {"score": score, "coverage": coverage,
            "monotonicity": float(monotonic), "confidence": confidence}
