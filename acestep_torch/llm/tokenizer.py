"""Minimal built-in tokenizer (fallback + tests).

The production path uses the HF Qwen3 tokenizer from the checkpoint dir
(reference llm_inference.py:548-571). This byte/char-level tokenizer with the
same special-token surface (<think>, </think>, <|audio_code_N|>, chat-template
markers, EOS) makes the whole LM stack runnable without downloads.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence


class SimpleTokenizer:
    """Greedy longest-match tokenizer over printable chars + special tokens."""

    def __init__(self, num_audio_codes: int = 64, extra_specials: Sequence[str] = ()):
        specials = [
            "<|im_start|>", "<|im_end|>", "<|endoftext|>",
            "<think>", "</think>", "\n",
        ]
        specials += [f"<|audio_code_{i}|>" for i in range(num_audio_codes)]
        specials += list(extra_specials)
        # printable ASCII + the schema's unicode accidentals (♯/♭ appear in
        # VALID_KEYSCALES; unknown chars must never alias a special token)
        chars = [chr(c) for c in range(32, 127)] + ["♯", "♭"]
        self._id_to_text: List[str] = specials + chars
        self._text_to_id: Dict[str, int] = {
            t: i for i, t in enumerate(self._id_to_text)}
        self.eos_token_id = self._text_to_id["<|im_end|>"]
        self.pad_token_id = self._text_to_id["<|endoftext|>"]
        self._special_re = re.compile(
            "(" + "|".join(re.escape(s) for s in specials if len(s) > 1) + ")")
        self.num_audio_codes = num_audio_codes

    @property
    def vocab_size(self) -> int:
        return len(self._id_to_text)

    def __len__(self) -> int:
        # HF convention: len(tokenizer) = full vocab incl. added tokens
        return len(self._id_to_text)

    def encode(self, text: str) -> List[int]:
        out: List[int] = []
        for part in self._special_re.split(text):
            if not part:
                continue
            if part in self._text_to_id and (len(part) > 1 or part == "\n"):
                out.append(self._text_to_id[part])
            else:
                for ch in part:
                    out.append(self._text_to_id.get(ch, self.pad_token_id))
        return out

    def decode(self, ids: Sequence[int]) -> str:
        return "".join(self._id_to_text[i] for i in ids
                       if 0 <= i < len(self._id_to_text))

    def __call__(self, texts, padding=True, truncation=True, max_length=None):
        if isinstance(texts, str):
            texts = [texts]
        rows = [self.encode(t) for t in texts]
        if truncation and max_length:
            rows = [r[:max_length] for r in rows]
        L = max(len(r) for r in rows) if rows else 1
        ids = [r + [self.pad_token_id] * (L - len(r)) for r in rows]
        mask = [[1] * len(r) + [0] * (L - len(r)) for r in rows]
        return {"input_ids": ids, "attention_mask": mask}

    def apply_chat_template(self, messages, tokenize: bool = False,
                            add_generation_prompt: bool = True) -> str:
        """Qwen-style ChatML template."""
        parts = []
        for m in messages:
            parts.append(f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n")
        if add_generation_prompt:
            parts.append("<|im_start|>assistant\n")
        else:
            # drop the trailing im_end so generation continues the last msg
            if parts and parts[-1].endswith("<|im_end|>\n"):
                parts[-1] = parts[-1][: -len("<|im_end|>\n")]
        return "".join(parts)

    def audio_code_id(self, n: int) -> int:
        return self._text_to_id[f"<|audio_code_{n}|>"]


def load_hf_tokenizer(path: str):
    """HF tokenizer from a local checkpoint dir (no network)."""
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise ImportError(
            f"loading the tokenizer of {path} needs the `transformers` "
            "package, which is not installed; pass tokenizer=... (for "
            "example SimpleTokenizer) instead") from e

    return AutoTokenizer.from_pretrained(path, trust_remote_code=True,
                                         local_files_only=True)
