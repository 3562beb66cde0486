"""The planner's analytic operations and bytes (the yardstick of the cells
with a 5 Hz planner, beside `counts.py`'s of the DiT and VAE):

- `trunk_params`: the matrices a decode step multiplies by, per token:
  q/k/v/o and the SwiGLU's three of every layer;
- `step_bytes`: what one decode step must read from the card's memory:
  the trunk's bf16 weights, the head's rows of the window it computes
  (the 64,000 audio-code rows in phase 2), the embedding rows of the fed
  tokens, and every row's K and V at its length;
- `stream_flops`: forward FLOPs of `n` tokens of one stream fed after
  `start` tokens (2 x MACs of the trunk's matrices, of the head's window
  where a token is sampled, and QK^T plus PV over the keys each query
  sees);
- `plan_flops`: one song's useful planner work, both CFG streams: each
  phase-1 prompt and the CoT tokens fed after it, and each phase-2 prompt
  past what it shares with that stream, then its codes. Pads fed by a
  finished row and the cross-request prefix reuse are not counted: they
  are not what the song needs.
"""

from __future__ import annotations

from typing import Sequence

BF16 = 2


def trunk_params(lm: dict) -> int:
    h, inter = lm["hidden_size"], lm["intermediate_size"]
    qd = lm["num_attention_heads"] * lm["head_dim"]
    kvd = lm["num_key_value_heads"] * lm["head_dim"]
    per_layer = h * qd + 2 * h * kvd + qd * h + 3 * h * inter
    return lm["num_hidden_layers"] * per_layer


def kv_bytes_per_token(lm: dict) -> int:
    return (lm["num_hidden_layers"] * 2 * lm["num_key_value_heads"]
            * lm["head_dim"] * BF16)


def step_bytes(lm: dict, rows: int, kv_tokens: float, window: int) -> float:
    """Bytes one decode step of `rows` rows reads at `kv_tokens` cached
    tokens summed over the rows, computing the head over `window` ids."""
    h = lm["hidden_size"]
    return (BF16 * (trunk_params(lm) + window * h + rows * h)
            + kv_tokens * kv_bytes_per_token(lm))


def stream_flops(lm: dict, start: int, n: int, heads: int,
                 window: int) -> float:
    """n tokens of one stream at positions start .. start + n - 1, with
    the head's `window` ids computed at `heads` of them."""
    if n <= 0:
        return 0.0
    qd = lm["num_attention_heads"] * lm["head_dim"]
    keys = n * start + n * (n + 1) // 2          # keys seen, summed
    return (2.0 * n * trunk_params(lm) + 2.0 * heads * window * lm["hidden_size"]
            + 4.0 * lm["num_hidden_layers"] * qd * keys)


def plan_flops(lm: dict, *, prompts1: Sequence[int], cot: int,
               prompts2: Sequence[int], shared: Sequence[int], codes: int,
               cot_window: int, code_window: int) -> float:
    """One song's planner FLOPs over its conditional and unconditional
    streams: `prompts1` / `prompts2` their phase prompts' lengths, `cot`
    the CoT tokens sampled, `shared` each phase-2 prompt's tokens in
    common with its phase-1 stream, `codes` the codes sampled. Each token
    sampled takes the head at the position before it."""
    f = 0.0
    for p1, p2, s in zip(prompts1, prompts2, shared):
        f += stream_flops(lm, 0, p1 + cot - 1, cot, cot_window)
        f += stream_flops(lm, s, p2 - s + codes - 1, codes, code_window)
    return f
