"""The yardstick's arithmetic: analytic operations and bytes, and the
card's published peaks. Frozen here so that a change to the program
cannot change how it is measured.

- `dit_flops`: the DiT decoder trajectory plus the per-trajectory cross
  K/V projection (2 x MACs), the formula of the port's `bench_torch.py`
  (equal to the JAX package's to the FLOP).
- `encoder_flops`, `condition_flops`: the condition encoder (text
  projector, lyric and timbre encoder stacks), counted with the same
  conventions (banded layers attend `min(L, window)` keys).
- `vae_decode_flops`: the Oobleck decoder over the song's own frames
  (window overlap, recomputed by the tiled decode, is not useful work and
  is not counted).
- `k1_ops_bytes`, `k4_ops_bytes`: the flash-attention forward (K1) and the
  fused snake + conv residual stack (K4), each input byte read once and
  each output byte written once, as `chip_smoke.py` counts them.
"""

from __future__ import annotations

from typing import Optional

# Published dense peaks of the cards torch names, NVIDIA's data sheets
# (the SXM part at its full power limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989.4e12, "bytes_per_s": 3.35e12},
}


def peak(card: str) -> Optional[dict]:
    return PEAKS.get(card)


def _sliding(dit: dict, i: int) -> bool:
    return dit["use_sliding_window"] and i % 2 == 0


def dit_flops(dit: dict, frames: int, cond_len: int, steps: int, batch: int,
              cfg_steps: int = 0) -> float:
    """Forward FLOPs of the decoder trajectory and its cross K/V."""
    L = -(-frames // dit["patch_size"])
    h = dit["hidden_size"]
    qd = dit["num_attention_heads"] * dit["head_dim"]
    kvd = dit["num_key_value_heads"] * dit["head_dim"]
    inter = dit["intermediate_size"]
    n_layers = dit["num_hidden_layers"]
    window = dit["sliding_window"] or 128
    per_layer = 0.0
    for i in range(n_layers):
        kv_span = min(L, window if _sliding(dit, i) else L)
        f = 2 * L * (h * qd + 2 * h * kvd + qd * h)
        f += 2 * 2 * L * kv_span * qd
        f += 2 * L * (h * qd + qd * h)
        f += 2 * 2 * L * cond_len * qd
        f += 2 * L * h * inter * 3
        per_layer += f
    c, ps = dit["audio_acoustic_hidden_dim"], dit["patch_size"]
    io = 2 * L * (3 * c * ps * h) + 2 * L * (h * c * ps)
    kv_once = n_layers * 2 * cond_len * (2 * h * kvd)
    return batch * ((per_layer + io) * (steps + cfg_steps) + kv_once)


def encoder_flops(dit: dict, L: int, in_dim: int, n_layers: int) -> float:
    """An encoder stack over L positions: input projection, pre-norm
    self-attention and SwiGLU layers."""
    h = dit["hidden_size"]
    qd = dit["num_attention_heads"] * dit["head_dim"]
    kvd = dit["num_key_value_heads"] * dit["head_dim"]
    f = 2 * L * in_dim * h
    for i in range(n_layers):
        span = min(L, dit["sliding_window"] if _sliding(dit, i) else L)
        f += 2 * L * (h * qd + 2 * h * kvd + qd * h) + 4 * L * span * qd
        f += 2 * L * h * dit["intermediate_size"] * 3
    return f


def condition_flops(dit: dict, text_len: int, lyric_len: int,
                    refer_frames: int) -> float:
    """The condition encoder of one request."""
    h = dit["hidden_size"]
    return (2 * text_len * dit["text_hidden_dim"] * h
            + encoder_flops(dit, lyric_len, dit["text_hidden_dim"],
                            dit["num_lyric_encoder_hidden_layers"])
            + encoder_flops(dit, refer_frames, dit["timbre_hidden_dim"],
                            dit["num_timbre_encoder_hidden_layers"]))


def vae_decode_flops(vae: dict, frames: int) -> float:
    """The Oobleck decoder over `frames` latent frames."""
    cm = [1] + list(vae["channel_multiples"])
    ratios = list(vae["downsampling_ratios"])[::-1]
    n = len(ratios)
    dch, lat = vae["decoder_channels"], vae["decoder_input_channels"]
    L = frames
    f = 2 * L * lat * dch * cm[-1] * 7
    for i, s in enumerate(ratios):
        cin, cout = dch * cm[n - i], dch * cm[n - i - 1]
        f += 2 * L * cin * cout * 2 * s          # transposed conv, k = 2s
        L *= s
        f += 48.0 * cout * cout * L              # 3 x (k7 + k1) units
    f += 2 * L * dch * vae["audio_channels"] * 7
    return f


def banded_pairs(L: int, window: Optional[int]) -> int:
    """(query, key) pairs with |i - j| <= window (all L^2 for None)."""
    if window is None:
        return L * L
    w = min(window, L - 1)
    return L * (2 * w + 1) - w * (w + 1)


def k1_ops_bytes(B: int, L: int, Hq: int, Hkv: int, D: int,
                 window: Optional[int]) -> tuple:
    """(FLOPs, bytes) of one K1 launch: QK^T and PV over the attended
    pairs; q, k, v and out in bf16, the float32 log-sum-exp."""
    flops = 4.0 * B * Hq * D * banded_pairs(L, window)
    nbytes = 2 * (2 * B * L * Hq * D + 2 * B * L * Hkv * D) + 4 * B * Hq * L
    return flops, nbytes


def k4_ops_bytes(N: int, L: int, C: int) -> tuple:
    """(FLOPs, bytes) of one K4 call (3 units, k=7 and k=1 convs): the
    activation in and out in bf16 and the three units' bf16 weights."""
    return 48.0 * C * C * N * L, 2 * 2 * N * L * C + 3 * 8 * C * C * 2


def bound_s(flops: float, nbytes: float, card: str) -> float:
    """The least time the card could take: the larger of operations over
    the bf16 peak and bytes over the memory bandwidth."""
    p = PEAKS[card]
    return max(flops / p["bf16_flops"], nbytes / p["bytes_per_s"])


def request_flops(dit: dict, vae: dict, *, frames: int, steps: int,
                  text_len: int, lyric_len: int, refer_frames: int) -> float:
    """The analytic FLOPs of one text2music song: condition encoder, cross
    K/V and decoder trajectory, and the VAE decode."""
    cond_len = lyric_len + 1 + text_len
    return (condition_flops(dit, text_len, lyric_len, refer_frames)
            + dit_flops(dit, frames, cond_len, steps, 1)
            + vae_decode_flops(vae, frames))

