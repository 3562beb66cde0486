"""Text embedding for DiT conditioning.

`HashTextEmbedder` is the deterministic, dependency-free embedder of
`acestep_tpu/pipeline/embedder.py` (byte-level tokens -> a fixed seeded
Gaussian table), identical table and all, so both packages condition on the
same embeddings. `QwenTextEmbedder` runs the Qwen3-Embedding trunk
(`models/lm.lm_encode`) over a HF tokenizer's ids. Both return host numpy
arrays: (hidden_states (B, L, dim) float32, attention_mask (B, L) int32).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

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


class QwenTextEmbedder:
    """Qwen3-Embedding trunk + HF tokenizer.

    encode_text runs the full trunk (last hidden state); encode_lyrics uses
    only the embedding table, matching the reference split. `model` is a
    `models.lm.QwenLM` (utils/checkpoint.load_lm_checkpoint)."""

    def __init__(self, model, cfg, tokenizer, dtype=torch.bfloat16):
        self.model = model
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.dtype = dtype
        self.device = model.embed_tokens.device

    def _tokenize(self, texts: Sequence[str], max_len: int):
        enc = self.tokenizer(list(texts), padding=True, truncation=True,
                             max_length=max_len)
        ids = np.asarray(enc["input_ids"], np.int64)
        mask = np.asarray(enc["attention_mask"], np.int32)
        L = _bucket(ids.shape[1], (32, 64, 128, 256, 512, 1024, 2048))
        L = min(L, max_len)
        if ids.shape[1] < L:
            pad_id = self.tokenizer.pad_token_id or 0
            ids = np.pad(ids, ((0, 0), (0, L - ids.shape[1])),
                         constant_values=pad_id)
            mask = np.pad(mask, ((0, 0), (0, L - mask.shape[1])))
        return ids[:, :L], mask[:, :L]

    @torch.no_grad()
    def encode_text(self, texts: Sequence[str], max_len: int = TEXT_MAX_LEN):
        from acestep_torch.models.lm import lm_encode

        ids, mask = self._tokenize(texts, max_len)
        hidden = lm_encode(self.model, self.cfg,
                           torch.as_tensor(ids, device=self.device),
                           torch.as_tensor(mask, device=self.device),
                           dtype=self.dtype)
        return hidden.float().cpu().numpy(), mask

    @torch.no_grad()
    def encode_lyrics(self, texts: Sequence[str], max_len: int = LYRIC_MAX_LEN):
        ids, mask = self._tokenize(texts, max_len)
        emb = self.model.embed_tokens[torch.as_tensor(ids, device=self.device)]
        return emb.float().cpu().numpy(), mask

    def lyric_token_strings(self, text: str,
                            max_len: int = LYRIC_MAX_LEN) -> List[str]:
        ids = self.tokenizer(text, truncation=True,
                             max_length=max_len)["input_ids"]
        return [self.tokenizer.decode([i]) for i in ids]
