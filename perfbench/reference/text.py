"""The text side of a text2music request, worked out again from what the
client sent: the DiT's caption prompt and lyric prompt strings, and their
byte-level hash embeddings (UTF-8 bytes + 1, 0 the pad id, looked up in a
(257, dim) Gaussian table drawn by numpy's default_rng(0) x 0.02, padded to
a length bucket).

Frozen copies of the plain string and table rules of ACE-Step's prompt
format; imports nothing but numpy.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

INSTRUCTION = "Fill the audio semantic mask based on the given conditions:"
PROMPT = "# Instruction\n{}\n\n# Caption\n{}\n\n# Metas\n{}<|endoftext|>\n"
BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)
TEXT_MAX_LEN = 256
LYRIC_MAX_LEN = 2048


def meta_string(duration_s: float, bpm=None, keyscale: str = "",
                timesignature: str = "") -> str:
    return (f"- bpm: {bpm if bpm else 'N/A'}\n"
            f"- timesignature: {timesignature or 'N/A'}\n"
            f"- keyscale: {keyscale or 'N/A'}\n"
            f"- duration: {int(duration_s)} seconds\n")


def caption_prompt(caption: str, duration_s: float) -> str:
    return PROMPT.format(INSTRUCTION, caption, meta_string(duration_s))


def lyric_prompt(lyrics: str, language: str) -> str:
    return f"# Languages\n{language}\n\n# Lyric\n{lyrics}<|endoftext|>"


def hash_table(dim: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    return (rng.standard_normal((257, dim)) * 0.02).astype(np.float32)


def padded_len(n: int, max_len: int) -> int:
    """The bucketed length n tokens are padded to."""
    return min(next((b for b in BUCKETS if n <= b), BUCKETS[-1]), max_len)


def embed(table: np.ndarray, texts: Sequence[str],
          max_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """(hidden (B, L, dim) float32, mask (B, L) int32)."""
    rows = [list(t.encode("utf-8"))[:max_len] for t in texts]
    L = padded_len(max(len(r) for r in rows), max_len)
    ids = np.zeros((len(rows), L), np.int64)
    mask = np.zeros((len(rows), L), np.int32)
    for i, r in enumerate(rows):
        r = r[:L]
        ids[i, :len(r)] = np.asarray(r, np.int64) + 1
        mask[i, :len(r)] = 1
    return table[ids], mask
