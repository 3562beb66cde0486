"""Plain float32 reference of the turbo DiT's audio-code path: the 5 Hz
codes a planner wrote turned into the 25 Hz latents a cover render's
context carries (ACE-Step 1.5's FSQ detokenizer).

- `fsq_codes`: each code id, written in the mixed radix of the FSQ levels
  (8, 8, 8, 5, 5, 5 for the 64,000 codes), as one value a level in
  [-1, 1]: (digit - level // 2) / (level // 2);
- `lm_hints`: those values through the quantizer's output projection,
  then the detokenizer: its input projection, one copy a 25 Hz frame of
  the 5 Hz vector plus that frame's learned token, a bidirectional
  encoder stack over each group of `pool_window_size` frames (the stack
  of `reference/dit.py`), its norm and output projection; frames past a
  song's codes take the silence latent (zeros here).

Imports nothing but torch and the DiT reference.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .dit import encoder_stack, linear

Tensor = torch.Tensor


def fsq_codes(ids: Tensor, levels: Sequence[int]) -> Tensor:
    """ids (...,) -> (..., len(levels)) float32 in [-1, 1]."""
    out, base = [], 1
    for lv in levels:
        digit = torch.div(ids, base, rounding_mode="floor") % lv
        half = lv // 2
        out.append((digit.float() - half) / half)
        base *= lv
    return torch.stack(out, -1)


def lm_hints(W: dict, dit: dict, codes: Sequence[int], frames: int,
             device) -> Tensor:
    """(1, frames, 64): the 25 Hz latents of one song's 5 Hz `codes`,
    zeros past them."""
    P, h = dit["pool_window_size"], dit["hidden_size"]
    n = min(len(codes), frames // P)
    ids = torch.as_tensor(list(codes)[:n], dtype=torch.long, device=device)
    q = linear(W, "tokenizer.fsq.project_out", fsq_codes(ids, dit["fsq_levels"]))
    x = linear(W, "detokenizer.embed_tokens", q)
    x = x[:, None, :] + W["detokenizer.special_tokens"][None]     # (n, P, h)
    x = encoder_stack(W, "detokenizer", x.reshape(n, P, h), None, dit)
    x = linear(W, "detokenizer.proj_out", x).reshape(1, n * P, -1)
    out = torch.zeros((1, frames, x.shape[-1]), device=device)
    out[:, :n * P] = x
    return out
