"""Plain float32 reference of ACE-Step 1.5's turbo text2music path: the
condition encoder (text projector, lyric encoder, timbre encoder), the
per-layer cross-attention K/V, the DiT decoder and the 8-step turbo
sampler.

Written from the architecture (Qwen3-style pre-norm blocks, per-head Q/K
RMSNorm, rotate-half RoPE, GQA, SwiGLU; AdaLN-modulated decoder layers
alternating banded |i-j| <= W and full self-attention; 2-frame patches in
and out) in plain torch operations over a dict of float32 tensors named as
the state dict of the checkpoint layout the benchmark loads. No kernel, no
cache across requests, no batching: one request at a time.

Imports nothing but torch.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


# ------------------------------------------------------------------
# Parameter names and shapes
# ------------------------------------------------------------------


def _attn_shapes(p: str, h: int, nq: int, nkv: int, d: int) -> Dict[str, tuple]:
    return {f"{p}.q_proj.weight": (nq * d, h), f"{p}.k_proj.weight": (nkv * d, h),
            f"{p}.v_proj.weight": (nkv * d, h), f"{p}.o_proj.weight": (h, nq * d),
            f"{p}.q_norm.scale": (d,), f"{p}.k_norm.scale": (d,)}


def _mlp_shapes(p: str, h: int, inter: int) -> Dict[str, tuple]:
    return {f"{p}.gate.weight": (inter, h), f"{p}.up.weight": (inter, h),
            f"{p}.down.weight": (h, inter)}


def _stack_shapes(p: str, dit: dict, in_dim: int, n: int,
                  special: bool) -> Dict[str, tuple]:
    h, nq, nkv, d = (dit["hidden_size"], dit["num_attention_heads"],
                     dit["num_key_value_heads"], dit["head_dim"])
    out = {f"{p}.embed_tokens.weight": (h, in_dim),
           f"{p}.embed_tokens.bias": (h,), f"{p}.norm.scale": (h,)}
    if special:
        out[f"{p}.special_token"] = (1, 1, h)
    for i in range(n):
        lp = f"{p}.layers.{i}"
        out[f"{lp}.input_layernorm.scale"] = (h,)
        out[f"{lp}.post_attention_layernorm.scale"] = (h,)
        out.update(_attn_shapes(f"{lp}.self_attn", h, nq, nkv, d))
        out.update(_mlp_shapes(f"{lp}.mlp", h, dit["intermediate_size"]))
    return out


def param_shapes(dit: dict) -> Dict[str, tuple]:
    """Every tensor of the DiT checkpoint: {name: shape}."""
    h, nq, nkv, d = (dit["hidden_size"], dit["num_attention_heads"],
                     dit["num_key_value_heads"], dit["head_dim"])
    inter, c = dit["intermediate_size"], dit["audio_acoustic_hidden_dim"]
    out: Dict[str, tuple] = {"null_condition_emb": (1, 1, h),
                             "decoder.scale_shift_table": (2, h)}
    for i in range(dit["num_hidden_layers"]):
        lp = f"decoder.layers.{i}"
        out[f"{lp}.scale_shift_table"] = (6, h)
        for norm in ("self_attn_norm", "cross_attn_norm", "mlp_norm"):
            out[f"{lp}.{norm}.scale"] = (h,)
        out.update(_attn_shapes(f"{lp}.self_attn", h, nq, nkv, d))
        out.update(_attn_shapes(f"{lp}.cross_attn", h, nq, nkv, d))
        out.update(_mlp_shapes(f"{lp}.mlp", h, inter))
    ps = dit["patch_size"]
    out.update({"decoder.proj_in.weight": (h, dit["in_channels"], ps),
                "decoder.proj_in.bias": (h,),
                "decoder.condition_embedder.weight": (h, h),
                "decoder.condition_embedder.bias": (h,),
                "decoder.norm_out.scale": (h,),
                "decoder.proj_out.weight": (h, c, ps),
                "decoder.proj_out.bias": (c,)})
    for te in ("time_embed", "time_embed_r"):
        out.update({f"decoder.{te}.linear_1.weight": (h, 256),
                    f"decoder.{te}.linear_1.bias": (h,),
                    f"decoder.{te}.linear_2.weight": (h, h),
                    f"decoder.{te}.linear_2.bias": (h,),
                    f"decoder.{te}.time_proj.weight": (6 * h, h),
                    f"decoder.{te}.time_proj.bias": (6 * h,)})
    out["encoder.text_projector.weight"] = (h, dit["text_hidden_dim"])
    out.update(_stack_shapes("encoder.lyric_encoder", dit,
                             dit["text_hidden_dim"],
                             dit["num_lyric_encoder_hidden_layers"], False))
    out.update(_stack_shapes("encoder.timbre_encoder", dit,
                             dit["timbre_hidden_dim"],
                             dit["num_timbre_encoder_hidden_layers"], True))
    # the 5 Hz tokenizer and detokenizer: loaded, but a text2music request
    # without audio codes does not reach its output
    out.update({"tokenizer.audio_acoustic_proj.weight": (h, c),
                "tokenizer.audio_acoustic_proj.bias": (h,)})
    out.update(_stack_shapes("tokenizer.pooler", dit, h,
                             dit["num_attention_pooler_hidden_layers"], True))
    k = len(dit["fsq_levels"])
    out.update({"tokenizer.fsq.project_in.weight": (k, dit["fsq_dim"]),
                "tokenizer.fsq.project_in.bias": (k,),
                "tokenizer.fsq.project_out.weight": (dit["fsq_dim"], k),
                "tokenizer.fsq.project_out.bias": (dit["fsq_dim"],)})
    det = _stack_shapes("detokenizer", dit, h,
                        dit["num_attention_pooler_hidden_layers"], False)
    det["detokenizer.special_tokens"] = (dit["pool_window_size"], h)
    det["detokenizer.proj_out.weight"] = (c, h)
    det["detokenizer.proj_out.bias"] = (c,)
    out.update(det)
    return out


# ------------------------------------------------------------------
# Primitives (float32)
# ------------------------------------------------------------------


def rms_norm(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def linear(W: dict, p: str, x: Tensor) -> Tensor:
    y = x @ W[f"{p}.weight"].T
    b = W.get(f"{p}.bias")
    return y if b is None else y + b


def rope(L: int, d: int, theta: float, device) -> Tuple[Tensor, Tensor]:
    half = d // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float64,
                                        device=device) / half))
    f = torch.arange(L, dtype=torch.float64, device=device)[:, None] * inv
    emb = torch.cat([f, f], -1)
    return emb.cos().float(), emb.sin().float()


def apply_rope(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """x (B, L, H, D)."""
    x1, x2 = x.chunk(2, -1)
    rot = torch.cat([-x2, x1], -1)
    return x * cos[None, :, None] + rot * sin[None, :, None]


def band(L: int, window: Optional[int], device) -> Optional[Tensor]:
    """(L, L) True = attend: |i - j| <= window, or None for full."""
    if window is None:
        return None
    i = torch.arange(L, device=device)
    return (i[:, None] - i[None, :]).abs() <= window


def sdpa(q: Tensor, k: Tensor, v: Tensor, mask: Optional[Tensor]) -> Tensor:
    """q (B, Lq, Hq, D), k/v (B, Lk, Hkv, D); mask broadcastable to
    (B, 1, Lq, Lk) bool. KV heads shared by Hq / Hkv query heads each."""
    rep = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if mask is not None:
        # the most negative float, not -inf: a query whose every key is
        # masked (padding far from any valid lyric token) attends all keys
        # evenly, as the upstream encoder's additive masks make it
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    return torch.einsum("bhqk,bkhd->bqhd", logits.softmax(-1), v)


def self_attention(W: dict, p: str, x: Tensor, mask, cos, sin,
                   dit: dict) -> Tensor:
    B, L, _ = x.shape
    nq, nkv, d = (dit["num_attention_heads"], dit["num_key_value_heads"],
                  dit["head_dim"])
    eps = dit["rms_norm_eps"]
    q = rms_norm(linear(W, f"{p}.q_proj", x).view(B, L, nq, d),
                 W[f"{p}.q_norm.scale"], eps)
    k = rms_norm(linear(W, f"{p}.k_proj", x).view(B, L, nkv, d),
                 W[f"{p}.k_norm.scale"], eps)
    v = linear(W, f"{p}.v_proj", x).view(B, L, nkv, d)
    o = sdpa(apply_rope(q, cos, sin), apply_rope(k, cos, sin), v, mask)
    return linear(W, f"{p}.o_proj", o.reshape(B, L, nq * d))


def swiglu(W: dict, p: str, x: Tensor) -> Tensor:
    return linear(W, f"{p}.down", F.silu(linear(W, f"{p}.gate", x))
                  * linear(W, f"{p}.up", x))


def is_sliding(dit: dict, i: int) -> bool:
    """Layers alternate banded and full, starting banded."""
    return dit["use_sliding_window"] and i % 2 == 0


# ------------------------------------------------------------------
# Condition encoder
# ------------------------------------------------------------------


def encoder_stack(W: dict, p: str, x: Tensor, key_mask: Optional[Tensor],
                  dit: dict) -> Tensor:
    """Bidirectional pre-norm stack over x (B, L, H); key_mask (B, L) with
    1 = valid key, None = all valid."""
    B, L, _ = x.shape
    cos, sin = rope(L, dit["head_dim"], dit["rope_theta"], x.device)
    keys = (torch.ones((B, L), dtype=torch.bool, device=x.device)
            if key_mask is None else key_mask.bool())
    full = keys[:, None, None, :]
    banded = full & band(L, dit["sliding_window"], x.device)[None, None]
    eps = dit["rms_norm_eps"]
    n = sum(1 for k in W if k.startswith(f"{p}.layers.")
            and k.endswith(".input_layernorm.scale"))
    for i in range(n):
        lp = f"{p}.layers.{i}"
        mask = banded if is_sliding(dit, i) else full
        x = x + self_attention(W, f"{lp}.self_attn",
                               rms_norm(x, W[f"{lp}.input_layernorm.scale"],
                                        eps), mask, cos, sin, dit)
        x = x + swiglu(W, f"{lp}.mlp",
                       rms_norm(x, W[f"{lp}.post_attention_layernorm.scale"],
                                eps))
    return rms_norm(x, W[f"{p}.norm.scale"], eps)


def condition(W: dict, dit: dict, text: Tensor, text_mask: Tensor,
              lyric: Tensor, lyric_mask: Tensor, refer: Tensor) -> Tensor:
    """(B, Lc, H) condition sequence [lyrics | timbre | text]; `refer` is
    one (B, T_ref, 64) timbre reference a request."""
    t = linear(W, "encoder.text_projector", text)
    ly = encoder_stack(W, "encoder.lyric_encoder",
                       linear(W, "encoder.lyric_encoder.embed_tokens", lyric),
                       lyric_mask, dit)
    tb = encoder_stack(W, "encoder.timbre_encoder",
                       linear(W, "encoder.timbre_encoder.embed_tokens", refer),
                       None, dit)[:, :1]
    return torch.cat([ly, tb, t], dim=1)


# ------------------------------------------------------------------
# Decoder
# ------------------------------------------------------------------


def sinusoid(t: Tensor, dim: int = 256) -> Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10_000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = (t.float() * 1000.0)[:, None] * freqs[None]
    return torch.cat([args.cos(), args.sin()], -1)


def time_embed(W: dict, p: str, t: Tensor) -> Tuple[Tensor, Tensor]:
    temb = linear(W, f"{p}.linear_2", F.silu(linear(W, f"{p}.linear_1",
                                                    sinusoid(t))))
    proj = linear(W, f"{p}.time_proj", F.silu(temb))
    return temb, proj.view(t.shape[0], 6, -1)


def cross_kv(W: dict, dit: dict, enc: Tensor) -> List[Tuple[Tensor, Tensor]]:
    B, Lk, _ = enc.shape
    nkv, d = dit["num_key_value_heads"], dit["head_dim"]
    enc = linear(W, "decoder.condition_embedder", enc)
    out = []
    for i in range(dit["num_hidden_layers"]):
        p = f"decoder.layers.{i}.cross_attn"
        k = rms_norm(linear(W, f"{p}.k_proj", enc).view(B, Lk, nkv, d),
                     W[f"{p}.k_norm.scale"], dit["rms_norm_eps"])
        out.append((k, linear(W, f"{p}.v_proj", enc).view(B, Lk, nkv, d)))
    return out


def decoder(W: dict, dit: dict, xt: Tensor, t: Tensor, ctx: Tensor,
            kv: List[Tuple[Tensor, Tensor]]) -> Tensor:
    """One velocity prediction: xt (B, T, 64) at timestep t (B,)."""
    B, T0, _ = xt.shape
    eps, ps = dit["rms_norm_eps"], dit["patch_size"]
    nq, d = dit["num_attention_heads"], dit["head_dim"]
    temb_t, proj_t = time_embed(W, "decoder.time_embed", t)
    temb_r, proj_r = time_embed(W, "decoder.time_embed_r", t - t)
    temb, tproj = temb_t + temb_r, proj_t + proj_r
    h = torch.cat([ctx, xt], -1)
    h = F.pad(h, (0, 0, 0, (-T0) % ps))
    h = F.conv1d(h.transpose(1, 2), W["decoder.proj_in.weight"],
                 W["decoder.proj_in.bias"], stride=ps).transpose(1, 2)
    L = h.shape[1]
    cos, sin = rope(L, d, dit["rope_theta"], h.device)
    banded = band(L, dit["sliding_window"], h.device)
    for i in range(dit["num_hidden_layers"]):
        lp = f"decoder.layers.{i}"
        mods = W[f"{lp}.scale_shift_table"][None] + tproj
        sh, sc, g, c_sh, c_sc, c_g = (mods[:, j:j + 1] for j in range(6))
        x = rms_norm(h, W[f"{lp}.self_attn_norm.scale"], eps) * (1 + sc) + sh
        mask = banded if is_sliding(dit, i) else None
        h = h + self_attention(W, f"{lp}.self_attn", x, mask, cos, sin,
                               dit) * g
        x = rms_norm(h, W[f"{lp}.cross_attn_norm.scale"], eps)
        p = f"{lp}.cross_attn"
        q = rms_norm(linear(W, f"{p}.q_proj", x).view(B, L, nq, d),
                     W[f"{p}.q_norm.scale"], eps)
        o = sdpa(q, kv[i][0], kv[i][1], None)
        h = h + linear(W, f"{p}.o_proj", o.reshape(B, L, nq * d))
        x = rms_norm(h, W[f"{lp}.mlp_norm.scale"], eps) * (1 + c_sc) + c_sh
        h = h + swiglu(W, f"{lp}.mlp", x) * c_g
    mods = W["decoder.scale_shift_table"][None] + temb[:, None]
    h = rms_norm(h, W["decoder.norm_out.scale"], eps) * (1 + mods[:, 1:2]) \
        + mods[:, 0:1]
    h = F.conv_transpose1d(h.transpose(1, 2), W["decoder.proj_out.weight"],
                           W["decoder.proj_out.bias"],
                           stride=ps).transpose(1, 2)
    return h[:, :T0]


def sample_turbo(W: dict, dit: dict, noise: Tensor, schedule: Sequence[float],
                 ctx: Tensor, kv) -> Tensor:
    """Euler ODE over the discrete schedule (no trailing 0) -> x0."""
    ts = list(schedule) + [0.0]
    x = noise
    for i in range(len(schedule)):
        t = torch.full((x.shape[0],), ts[i], dtype=torch.float32,
                       device=x.device)
        x = x - decoder(W, dit, x, t, ctx, kv) * (ts[i] - ts[i + 1])
    return x


def latents(W: dict, dit: dict, *, text: Tensor, text_mask: Tensor,
            lyric: Tensor, lyric_mask: Tensor, refer: Tensor, src: Tensor,
            noise: Tensor, schedule: Sequence[float]) -> Tensor:
    """A text2music request's x0 (B, T, 64): the condition, the cross K/V
    and the trajectory; `src` (B, T, 64) is the silence latent the context
    carries beside an all-ones chunk mask."""
    enc = condition(W, dit, text, text_mask, lyric, lyric_mask, refer)
    ctx = torch.cat([src, torch.ones_like(src)], -1)
    return sample_turbo(W, dit, noise, schedule, ctx, cross_kv(W, dit, enc))
