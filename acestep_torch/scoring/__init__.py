"""Scoring & alignment: LRC lyric timestamps, alignment quality, PMI reward.

Port of `acestep_tpu/scoring/`:
- `dtw` (numpy anti-diagonal DTW), `median_filter`;
- `MusicStampsAligner` (cross-attention -> token/sentence timestamps -> LRC);
- `lyric_alignment_score` (alignment-quality metric);
- `calculate_reward_score` (PMI of conditional against unconditional LM
  log-probabilities), `sequence_logprob`.
"""

from acestep_torch.scoring.dtw import dtw, median_filter
from acestep_torch.scoring.alignment import (
    MusicStampsAligner,
    SentenceTimestamp,
    TokenTimestamp,
    format_lrc,
)
from acestep_torch.scoring.lyric_score import lyric_alignment_score
from acestep_torch.scoring.lm_score import calculate_reward_score, sequence_logprob

__all__ = [
    "dtw",
    "median_filter",
    "MusicStampsAligner",
    "TokenTimestamp",
    "SentenceTimestamp",
    "format_lrc",
    "lyric_alignment_score",
    "calculate_reward_score",
    "sequence_logprob",
]
