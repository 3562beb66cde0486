"""Text embedding for DiT conditioning.

`HashTextEmbedder` is the deterministic, dependency-free embedder of
`acestep_tpu/pipeline/embedder.py` (byte-level tokens -> a fixed seeded
Gaussian table), identical table and all, so both packages condition on the
same embeddings. It returns host numpy arrays: (hidden_states (B, L, dim)
float32, attention_mask (B, L) int32). The Qwen3-Embedding encoder is not
ported yet.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

TEXT_MAX_LEN = 256     # reference conditioning_text.py max_length=256
LYRIC_MAX_LEN = 2048   # reference conditioning_text.py max_length=2048


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class HashTextEmbedder:
    """Deterministic byte-level embedder.

    Tokens are UTF-8 bytes (+1 so 0 stays the pad id); embeddings come from a
    fixed seeded Gaussian table projected to `dim`. Not semantically
    meaningful, but deterministic, shape-correct, and unique per text — which
    is exactly what structural tests and throughput benches need.
    """

    def __init__(self, dim: int = 1024, seed: int = 0):
        self.dim = dim
        rng = np.random.default_rng(seed)
        self.table = (rng.standard_normal((257, dim)) * 0.02).astype(np.float32)

    def _ids(self, texts: Sequence[str], max_len: int):
        rows = [list(t.encode("utf-8"))[:max_len] for t in texts]
        L = _bucket(max(len(r) for r in rows) if rows else 1, (32, 64, 128, 256,
                                                               512, 1024, 2048))
        L = min(L, max_len)
        ids = np.zeros((len(rows), L), np.int32)
        mask = np.zeros((len(rows), L), np.int32)
        for i, r in enumerate(rows):
            r = r[:L]
            ids[i, : len(r)] = np.asarray(r, np.int32) + 1
            mask[i, : len(r)] = 1
        return ids, mask

    def encode_text(self, texts: Sequence[str], max_len: int = TEXT_MAX_LEN):
        ids, mask = self._ids(texts, max_len)
        return self.table[ids], mask   # host arrays; transferred by the jit call

    def encode_lyrics(self, texts: Sequence[str], max_len: int = LYRIC_MAX_LEN):
        return self.encode_text(texts, max_len)

    def lyric_token_strings(self, text: str,
                            max_len: int = LYRIC_MAX_LEN) -> List[str]:
        """Per-position token strings for the lyric sequence (LRC alignment).
        Byte-level tokens decode back to single characters."""
        data = text.encode("utf-8")[:max_len]
        return [bytes([b]).decode("utf-8", errors="replace") for b in data]
