"""PMI reward score via the 5 Hz LM.

Port of `acestep_tpu/scoring/lm_score.py`: pointwise mutual information
between the user condition and the generated audio codes, estimated as
log P(codes | condition) - log P(codes | null condition) under the planner
LM, normalized per code token. Positive = the condition shaped the music.

Scoring is one teacher-forced forward per prompt (no autoregressive loop),
on the engine's model as it is: bf16, weight-only quantized (dequantized
per module at use) or w8a8 (int8 products, and the int8 head copy when the
untied head was dropped), and on every rank of a tensor-parallel engine
(`LMEngine.sequence_logprob`).
"""

from __future__ import annotations

import numpy as np
import torch

from acestep_torch.models.lm import lm_encode, lm_logits


@torch.no_grad()
def sequence_logprob(model, cfg, input_ids, target_start: int,
                     dtype=torch.bfloat16) -> float:
    """Sum of log P(token_i | tokens_<i) for i >= target_start.

    input_ids: (L,) full prompt+target token ids."""
    dev = model.embed_tokens.device
    ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long,
                          device=dev)[None]
    hidden = lm_encode(model, cfg, ids, torch.ones_like(ids), dtype=dtype)
    logp = torch.log_softmax(lm_logits(model, cfg, hidden).float(), dim=-1)
    # token at position i+1 predicted from position i
    token_lp = logp[0, :-1].gather(-1, ids[0, 1:, None])[:, 0]
    return float(token_lp[max(target_start - 1, 0):].sum())


def calculate_reward_score(llm_handler, audio_codes: str, caption: str = "",
                           lyrics: str = "",
                           negative_prompt: str = "NO USER INPUT",
                           ) -> dict:
    """PMI score for generated codes under the user condition.

    Returns {pmi, cond_logprob, uncond_logprob, num_codes, score} where
    score is pmi normalized per code and squashed to 0-1."""
    engine = getattr(llm_handler, "engine", None)
    if engine is None:
        raise RuntimeError("LLM handler not initialized")
    tokenizer = llm_handler.tokenizer

    cond_prompt = llm_handler.build_formatted_prompt(caption, lyrics)
    uncond_prompt = llm_handler.build_formatted_prompt(negative_prompt, "")

    cond_ids = tokenizer.encode(cond_prompt)
    uncond_ids = tokenizer.encode(uncond_prompt)
    code_ids = tokenizer.encode(audio_codes)
    n_codes = max(len(code_ids), 1)

    cond_full = np.asarray(list(cond_ids) + list(code_ids), np.int64)
    uncond_full = np.asarray(list(uncond_ids) + list(code_ids), np.int64)

    cond_lp = engine.sequence_logprob(cond_full, len(cond_ids))
    uncond_lp = engine.sequence_logprob(uncond_full, len(uncond_ids))
    pmi = cond_lp - uncond_lp
    per_code = pmi / n_codes
    score = float(1.0 / (1.0 + np.exp(-4.0 * per_code)))  # squash to (0,1)
    return {"pmi": float(pmi), "cond_logprob": cond_lp,
            "uncond_logprob": uncond_lp, "num_codes": n_codes,
            "score": score}
