"""AceStep DiT stack: condition encoders, 5 Hz tokenizer/detokenizer and the
flow-matching decoder.

Port of `acestep_tpu/models/dit.py`. Parameters live in one `AceStepDiT`
module whose attribute names follow the JAX parameter tree
(`decoder.layers[i].self_attn.q_proj`, `encoder.lyric_encoder.norm`, ...);
the forward passes are functions over it, as in the JAX package:

- layer stacks are Python loops over `nn.ModuleList`s;
- the condition sequence has the fixed layout [lyrics | timbre | text];
  the decoder's cross-attention is maskless, so padded condition positions
  are attended, as in the reference decoder;
- cross-attention K/V are computed once per trajectory (`decoder_cross_kv`);
- the decoder's self-attention goes through `ops.flash_attention` in every
  layer at every length: the hand-written kernel on a CUDA device, its
  dense plain version on the CPU. Layers alternate banded (|i-j| <= W) and
  full attention. A config whose `attention_impl` is "dense" takes the
  plain masked attention instead (`resolve_attention_impl`);
- a decoder step is a sequence of segments cut at each layer's two
  attention cores; a sampler's step on a CUDA device replays them as CUDA
  graphs (`models/dit_graphs.py`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from acestep_torch.config import DiTConfig
from acestep_torch.ops.basic import (
    MLP, Attention, RMSNorm, _sdpa, attention, cross_kv, cross_q, linear, mlp,
    rms_norm, rope_cos_sin, seeded_init_, self_qkv, timestep_sinusoidal,
)
from acestep_torch.ops.conv import conv1d, conv1d_transpose
from acestep_torch.ops import flash_attention as fa
from acestep_torch.ops.fsq import fsq_indices_to_codes, fsq_quantize
from acestep_torch.ops.masks import bidirectional_mask

# ==================================================================
# Modules (attribute names follow the JAX parameter tree)
# ==================================================================


def _normal_(t: torch.Tensor, generator, scale: float = 1.0) -> None:
    t.normal_(0.0, 1.0, generator=generator).mul_(scale)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: DiTConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        h = cfg.hidden_size
        self.input_layernorm = RMSNorm(h, **kw)
        self.self_attn = Attention(h, cfg.num_attention_heads,
                                   cfg.num_key_value_heads, cfg.head_dim, **kw)
        self.post_attention_layernorm = RMSNorm(h, **kw)
        self.mlp = MLP(h, cfg.intermediate_size, **kw)


class DiTLayer(nn.Module):
    def __init__(self, cfg: DiTConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        h = cfg.hidden_size
        attn = (h, cfg.num_attention_heads, cfg.num_key_value_heads,
                cfg.head_dim)
        self.self_attn_norm = RMSNorm(h, **kw)
        self.self_attn = Attention(*attn, **kw)
        self.cross_attn_norm = RMSNorm(h, **kw)
        self.cross_attn = Attention(*attn, **kw)
        self.mlp_norm = RMSNorm(h, **kw)
        self.mlp = MLP(h, cfg.intermediate_size, **kw)
        # AdaLN modulation table
        self.scale_shift_table = nn.Parameter(torch.empty(6, h, **kw))

    @torch.no_grad()
    def init_own_(self, generator):
        _normal_(self.scale_shift_table, generator,
                 self.scale_shift_table.shape[1] ** -0.5)


class TimestepEmbedding(nn.Module):
    def __init__(self, h: int, in_channels: int = 256, *, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.linear_1 = nn.Linear(in_channels, h, **kw)
        self.linear_2 = nn.Linear(h, h, **kw)
        self.time_proj = nn.Linear(h, 6 * h, **kw)


class Decoder(nn.Module):
    def __init__(self, cfg: DiTConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        h = cfg.hidden_size
        self.layers = nn.ModuleList(DiTLayer(cfg, **kw)
                                    for _ in range(cfg.num_hidden_layers))
        self.proj_in = nn.Conv1d(cfg.in_channels, h, cfg.patch_size, **kw)
        self.time_embed = TimestepEmbedding(h, **kw)
        self.time_embed_r = TimestepEmbedding(h, **kw)
        self.condition_embedder = nn.Linear(h, h, **kw)
        self.norm_out = RMSNorm(h, **kw)
        self.proj_out = nn.ConvTranspose1d(h, cfg.audio_acoustic_hidden_dim,
                                           cfg.patch_size, **kw)
        self.scale_shift_table = nn.Parameter(torch.empty(2, h, **kw))

    @torch.no_grad()
    def init_own_(self, generator):
        _normal_(self.scale_shift_table, generator,
                 self.scale_shift_table.shape[1] ** -0.5)


class StackEncoder(nn.Module):
    """embed_tokens -> encoder layers -> norm (lyric / timbre encoders and
    the tokenizer's attention pooler)."""

    def __init__(self, cfg: DiTConfig, in_dim: int, n_layers: int, *,
                 special_token_std: Optional[float] = None, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        h = cfg.hidden_size
        self.embed_tokens = nn.Linear(in_dim, h, **kw)
        self.layers = nn.ModuleList(EncoderLayer(cfg, **kw)
                                    for _ in range(n_layers))
        self.norm = RMSNorm(h, **kw)
        self._special_std = special_token_std
        if special_token_std is not None:
            self.special_token = nn.Parameter(torch.empty(1, 1, h, **kw))

    @torch.no_grad()
    def init_own_(self, generator):
        if self._special_std is not None:
            _normal_(self.special_token, generator, self._special_std)


class ConditionEncoder(nn.Module):
    def __init__(self, cfg: DiTConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        h = cfg.hidden_size
        self.text_projector = nn.Linear(cfg.text_hidden_dim, h, bias=False,
                                        **kw)
        self.lyric_encoder = StackEncoder(
            cfg, cfg.text_hidden_dim, cfg.num_lyric_encoder_hidden_layers,
            **kw)
        # the timbre encoder's special token is kept for checkpoint parity;
        # the reference never prepends it
        self.timbre_encoder = StackEncoder(
            cfg, cfg.timbre_hidden_dim, cfg.num_timbre_encoder_hidden_layers,
            special_token_std=1.0, **kw)


class FSQProjections(nn.Module):
    def __init__(self, cfg: DiTConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        klev = len(cfg.fsq_levels)
        self.project_in = nn.Linear(cfg.fsq_dim, klev, **kw)
        self.project_out = nn.Linear(klev, cfg.fsq_dim, **kw)


class AudioTokenizer(nn.Module):
    def __init__(self, cfg: DiTConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        h = cfg.hidden_size
        self.audio_acoustic_proj = nn.Linear(cfg.audio_acoustic_hidden_dim, h,
                                             **kw)
        self.pooler = StackEncoder(cfg, h,
                                   cfg.num_attention_pooler_hidden_layers,
                                   special_token_std=0.02, **kw)
        self.fsq = FSQProjections(cfg, **kw)


class AudioDetokenizer(nn.Module):
    def __init__(self, cfg: DiTConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        h = cfg.hidden_size
        self.embed_tokens = nn.Linear(h, h, **kw)
        self.special_tokens = nn.Parameter(
            torch.empty(cfg.pool_window_size, h, **kw))
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, **kw)
            for _ in range(cfg.num_attention_pooler_hidden_layers))
        self.norm = RMSNorm(h, **kw)
        self.proj_out = nn.Linear(h, cfg.audio_acoustic_hidden_dim, **kw)

    @torch.no_grad()
    def init_own_(self, generator):
        _normal_(self.special_tokens, generator, 0.02)


class AceStepDiT(nn.Module):
    """Full parameter set of AceStepConditionGenerationModel."""

    def __init__(self, cfg: DiTConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.decoder = Decoder(cfg, **kw)
        self.encoder = ConditionEncoder(cfg, **kw)
        self.tokenizer = AudioTokenizer(cfg, **kw)
        self.detokenizer = AudioDetokenizer(cfg, **kw)
        self.null_condition_emb = nn.Parameter(
            torch.empty(1, 1, cfg.hidden_size, **kw))

    @torch.no_grad()
    def init_own_(self, generator):
        _normal_(self.null_condition_emb, generator)


def build_dit(cfg: DiTConfig, device, dtype=torch.float32) -> AceStepDiT:
    """Uninitialised module on `device` (no init pass over the weights)."""
    return AceStepDiT(cfg, device="meta", dtype=dtype).to_empty(
        device=device).requires_grad_(False)


def init_dit_params(cfg: DiTConfig, generator: torch.Generator, *,
                    dtype=torch.float32) -> AceStepDiT:
    """Seeded DiT on `generator`'s device, with the JAX init's
    distributions: linear/conv weights N(0, 0.02), zero biases, unit norm
    scales, AdaLN tables N(0, 1/hidden), special tokens as in the JAX init."""
    model = build_dit(cfg, generator.device, dtype)
    seeded_init_(model, generator)
    return model


def _sliding_flags(cfg: DiTConfig, n_layers: int) -> List[bool]:
    return [cfg.layer_is_sliding(i) for i in range(n_layers)]


# ==================================================================
# Encoder stack (pre-norm self-attn + SwiGLU)
# ==================================================================


def encoder_stack(layers: nn.ModuleList, cfg: DiTConfig, x: torch.Tensor, *,
                  full_mask: Optional[torch.Tensor],
                  sliding_mask: Optional[torch.Tensor],
                  sliding_flags: List[bool], rope) -> torch.Tensor:
    eps = cfg.rms_norm_eps
    for lp, is_sliding in zip(layers, sliding_flags):
        if sliding_mask is None:
            mask = full_mask
        elif full_mask is None:
            # only valid when L <= window + 1 (attention pooler and
            # detokenizer, L = 5-6): the band is then all-True
            mask = sliding_mask
        else:
            mask = sliding_mask if is_sliding else full_mask
        a = attention(lp.self_attn, rms_norm(lp.input_layernorm, x, eps),
                      num_heads=cfg.num_attention_heads,
                      num_kv_heads=cfg.num_key_value_heads,
                      head_dim=cfg.head_dim, mask=mask, rope=rope, eps=eps)
        x = x + a
        x = x + mlp(lp.mlp, rms_norm(lp.post_attention_layernorm, x, eps))
    return x


# ==================================================================
# Condition encoders
# ==================================================================


def lyric_encoder(p: StackEncoder, cfg: DiTConfig, lyric_embs: torch.Tensor,
                  lyric_mask: torch.Tensor) -> torch.Tensor:
    """(B, L, text_hidden_dim) + (B, L) -> (B, L, H); bidirectional,
    alternating sliding/full with the padding mask applied."""
    x = linear(p.embed_tokens, lyric_embs)
    L = x.shape[1]
    rope = rope_cos_sin(L, cfg.head_dim, cfg.rope_theta, dtype=x.dtype,
                        device=x.device)
    full = bidirectional_mask(L, lyric_mask)
    sliding = bidirectional_mask(L, lyric_mask, window=cfg.sliding_window)
    x = encoder_stack(p.layers, cfg, x, full_mask=full, sliding_mask=sliding,
                      sliding_flags=_sliding_flags(cfg, len(p.layers)),
                      rope=rope)
    return rms_norm(p.norm, x, cfg.rms_norm_eps)


def unpack_by_order(packed: torch.Tensor, order_mask: torch.Tensor,
                    batch_size: int, max_count: int):
    """Scatter N packed vectors into (B, max_count, D) by batch id; items
    beyond max_count per batch are dropped. Returns (out, int32 mask)."""
    N, D = packed.shape
    same = order_mask[:, None] == order_mask[None, :]
    before = torch.tril(same, diagonal=-1).sum(dim=1)
    valid = before < max_count
    slot = torch.where(valid, order_mask.long() * max_count + before,
                       torch.full_like(before, batch_size * max_count))
    one_hot = F.one_hot(slot, batch_size * max_count + 1).to(packed.dtype)
    out = (one_hot.T @ packed)[:-1].reshape(batch_size, max_count, D)
    mask = (one_hot.sum(dim=0) > 0)[:-1].reshape(batch_size, max_count)
    return out, mask.to(torch.int32)


def timbre_encoder(p: StackEncoder, cfg: DiTConfig, refs_packed: torch.Tensor,
                   order_mask: torch.Tensor, batch_size: int, max_count: int):
    """(N, T, 64) packed reference latents -> (B, max_count, H) timbre
    embeddings; geometry-only masks, full layers unrestricted, the first
    position's output is the timbre vector."""
    x = linear(p.embed_tokens, refs_packed)
    L = x.shape[1]
    rope = rope_cos_sin(L, cfg.head_dim, cfg.rope_theta, dtype=x.dtype,
                        device=x.device)
    full = bidirectional_mask(L, device=x.device)
    sliding = bidirectional_mask(L, window=cfg.sliding_window,
                                 device=x.device)
    x = encoder_stack(p.layers, cfg, x, full_mask=full, sliding_mask=sliding,
                      sliding_flags=_sliding_flags(cfg, len(p.layers)),
                      rope=rope)
    x = rms_norm(p.norm, x, cfg.rms_norm_eps)
    return unpack_by_order(x[:, 0, :], order_mask, batch_size, max_count)


def condition_encoder(model: AceStepDiT, cfg: DiTConfig, *,
                      text_hidden_states, text_attention_mask,
                      lyric_hidden_states, lyric_attention_mask,
                      refer_audio_packed, refer_order_mask,
                      max_refer_count: int = 1):
    """(encoder_hidden_states, encoder_attention_mask), fixed layout
    [lyrics | timbre | text]."""
    enc_p = model.encoder
    B = text_hidden_states.shape[0]
    text = linear(enc_p.text_projector, text_hidden_states)
    lyric = lyric_encoder(enc_p.lyric_encoder, cfg, lyric_hidden_states,
                          lyric_attention_mask)
    timbre, timbre_mask = timbre_encoder(enc_p.timbre_encoder, cfg,
                                         refer_audio_packed, refer_order_mask,
                                         B, max_refer_count)
    enc = torch.cat([lyric, timbre.to(lyric.dtype), text], dim=1)
    enc_mask = torch.cat([lyric_attention_mask.to(torch.int32), timbre_mask,
                          text_attention_mask.to(torch.int32)], dim=1)
    return enc, enc_mask


# ==================================================================
# 5 Hz audio tokenizer / detokenizer
# ==================================================================


def attention_pooler(p: StackEncoder, cfg: DiTConfig,
                     x: torch.Tensor) -> torch.Tensor:
    """(B, T, P, H) patches -> (B, T, H) via CLS-token pooling."""
    B, T, P, H = x.shape
    x = linear(p.embed_tokens, x)
    cls = p.special_token.to(x.dtype).expand(B, T, 1, H)
    x = torch.cat([cls, x], dim=2).reshape(B * T, P + 1, H)
    rope = rope_cos_sin(P + 1, cfg.head_dim, cfg.rope_theta, dtype=x.dtype,
                        device=x.device)
    sliding = bidirectional_mask(P + 1, window=cfg.sliding_window,
                                 device=x.device)
    x = encoder_stack(p.layers, cfg, x, full_mask=None, sliding_mask=sliding,
                      sliding_flags=_sliding_flags(cfg, len(p.layers)),
                      rope=rope)
    x = rms_norm(p.norm, x, cfg.rms_norm_eps)
    return x[:, 0, :].reshape(B, T, H)


def audio_tokenize(model: AceStepDiT, cfg: DiTConfig, latents: torch.Tensor):
    """25 Hz latents (B, T, 64), T % pool_window == 0 -> (quantized
    (B, T/5, H), indices (B, T/5))."""
    p = model.tokenizer
    B, T, _ = latents.shape
    P = cfg.pool_window_size
    x = linear(p.audio_acoustic_proj, latents)
    x = x.reshape(B, T // P, P, cfg.hidden_size)
    pooled = attention_pooler(p.pooler, cfg, x)
    z = linear(p.fsq.project_in, pooled)
    codes, indices = fsq_quantize(z, cfg.fsq_levels)
    return linear(p.fsq.project_out, codes), indices


def audio_codes_to_quantized(model: AceStepDiT, cfg: DiTConfig,
                             indices: torch.Tensor) -> torch.Tensor:
    """5 Hz code ids (B, T5) -> quantized hidden (B, T5, H): float32 codes
    times the weights cast to float32, as in the JAX package."""
    codes = fsq_indices_to_codes(indices, cfg.fsq_levels)
    return linear(model.tokenizer.fsq.project_out, codes)


def audio_detokenize(model: AceStepDiT, cfg: DiTConfig,
                     quantized: torch.Tensor) -> torch.Tensor:
    """(B, T5, H) -> 25 Hz LM hints (B, T5*P, 64)."""
    p = model.detokenizer
    B, T, H = quantized.shape
    P = cfg.pool_window_size
    x = linear(p.embed_tokens, quantized)
    x = x[:, :, None, :] + p.special_tokens.to(x.dtype)[None, None]
    x = x.reshape(B * T, P, H)
    rope = rope_cos_sin(P, cfg.head_dim, cfg.rope_theta, dtype=x.dtype,
                        device=x.device)
    sliding = bidirectional_mask(P, window=cfg.sliding_window,
                                 device=x.device)
    x = encoder_stack(p.layers, cfg, x, full_mask=None, sliding_mask=sliding,
                      sliding_flags=_sliding_flags(cfg, len(p.layers)),
                      rope=rope)
    x = rms_norm(p.norm, x, cfg.rms_norm_eps)
    x = linear(p.proj_out, x)
    return x.reshape(B, T * P, cfg.audio_acoustic_hidden_dim)


# ==================================================================
# DiT decoder
# ==================================================================


def _timestep_embed(p: TimestepEmbedding, t: torch.Tensor, dtype):
    emb = timestep_sinusoidal(t, 256).to(dtype)
    temb = linear(p.linear_2, F.silu(linear(p.linear_1, emb)))
    proj = linear(p.time_proj, F.silu(temb))
    return temb, proj.reshape(t.shape[0], 6, -1)


def decoder_cross_kv(model: AceStepDiT, cfg: DiTConfig, enc: torch.Tensor):
    """Per-layer cross-attention K/V for a fixed condition sequence:
    stacked (n_layers, B, Lk, Hkv, D) k and v. Applies the decoder's
    condition_embedder first."""
    enc = linear(model.decoder.condition_embedder, enc)
    ks, vs = zip(*[cross_kv(lp.cross_attn, enc,
                            num_kv_heads=cfg.num_key_value_heads,
                            head_dim=cfg.head_dim, eps=cfg.rms_norm_eps)
                   for lp in model.decoder.layers])
    return torch.stack(ks), torch.stack(vs)


ATTENTION_IMPLS = ("auto", "flash", "dense")


def resolve_attention_impl(cfg: DiTConfig) -> str:
    """The decoder's self-attention for `cfg.attention_impl`: "flash" (the
    flash kernel on a CUDA device, its plain version on the CPU) for
    "auto" and "flash", "dense" (the plain masked attention, as the JAX
    package's "dense") only when the config names it."""
    if cfg.attention_impl not in ATTENTION_IMPLS:
        raise ValueError(f"attention_impl {cfg.attention_impl!r}: expected "
                         f"one of {ATTENTION_IMPLS}")
    return "dense" if cfg.attention_impl == "dense" else "flash"


def layer_window(cfg: DiTConfig, i: int) -> Optional[int]:
    """Layer i's self-attention band W (|i-j| <= W), None when full."""
    return cfg.sliding_window if cfg.layer_is_sliding(i) else None


def self_attention_core(cfg: DiTConfig, L: int, device):
    """fn(q, k, v, window) -> the decoder's self-attention (B, L, Hq, D),
    by `resolve_attention_impl(cfg)`; the dense masks are built once."""
    if resolve_attention_impl(cfg) == "flash":
        return lambda q, k, v, window: fa.flash_attention(q, k, v,
                                                          window=window)
    masks = {w: bidirectional_mask(L, window=w, device=device)
             for w in (None, cfg.sliding_window)}
    return lambda q, k, v, window: _sdpa(q, k, v, masks[window])


def decoder_rope(cfg: DiTConfig, L: int, dtype, device):
    return rope_cos_sin(L, cfg.head_dim, cfg.rope_theta, dtype=dtype,
                        device=device)


# A decoder step is cut into segments at the two places where per-call
# data enters each layer: its self-attention core (the flash kernel) and
# its cross-attention core over the trajectory's K/V. `dit_decoder` runs
# them in order; `models/dit_graphs.py` captures them as CUDA graphs and
# replays them between the two cores, which stay eager.


def _modulation(lp: DiTLayer, tproj: torch.Tensor, dtype):
    """Layer lp's AdaLN rows (B, 1, H): shift, scale and gate of its
    self-attention, then of its MLP."""
    mods = lp.scale_shift_table[None].to(dtype) + tproj     # (B, 6, H)
    return [mods[:, j:j + 1] for j in range(6)]


def decoder_in(p: Decoder, cfg: DiTConfig, xt: torch.Tensor,
               timestep: torch.Tensor, timestep_r: torch.Tensor,
               context_latents: torch.Tensor):
    """The timestep embeddings and the patched input: (h (B, L, H),
    tproj (B, 6, H), temb (B, H)) for (B, T, 64) noisy latents, T padded
    to a multiple of the patch size."""
    dtype = xt.dtype
    temb_t, proj_t = _timestep_embed(p.time_embed, timestep, dtype)
    temb_r, proj_r = _timestep_embed(p.time_embed_r, timestep - timestep_r,
                                     dtype)
    h = torch.cat([context_latents.to(dtype), xt], dim=-1)
    pad = (-xt.shape[1]) % cfg.patch_size
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
    h = conv1d(p.proj_in, h, stride=cfg.patch_size)
    return h, proj_t + proj_r, temb_t + temb_r


def self_attn_in(lp: DiTLayer, cfg: DiTConfig, h: torch.Tensor,
                 tproj: torch.Tensor, rope):
    """The self-attention core's inputs (q, k, v): modulation, norm,
    projections, QK-norm, RoPE."""
    shift, scale = _modulation(lp, tproj, h.dtype)[:2]
    x = rms_norm(lp.self_attn_norm, h, cfg.rms_norm_eps) * (1 + scale) \
        + shift
    return self_qkv(lp.self_attn, x.to(h.dtype),
                    num_heads=cfg.num_attention_heads,
                    num_kv_heads=cfg.num_key_value_heads,
                    head_dim=cfg.head_dim, rope=rope, eps=cfg.rms_norm_eps)


def self_attn_out(lp: DiTLayer, cfg: DiTConfig, h: torch.Tensor,
                  a: torch.Tensor, tproj: torch.Tensor):
    """(h, cq): the self-attention core's output `a` projected, gated and
    added to h, then the cross-attention's norm and query."""
    gate = _modulation(lp, tproj, h.dtype)[2]
    B, L = h.shape[:2]
    h = h + linear(lp.self_attn.o_proj, a.reshape(B, L, -1)) * gate
    cq = cross_q(lp.cross_attn, rms_norm(lp.cross_attn_norm, h,
                                         cfg.rms_norm_eps),
                 num_heads=cfg.num_attention_heads, head_dim=cfg.head_dim,
                 eps=cfg.rms_norm_eps)
    return h, cq


def cross_out(lp: DiTLayer, cfg: DiTConfig, h: torch.Tensor,
              ca: torch.Tensor, tproj: torch.Tensor) -> torch.Tensor:
    """The cross-attention core's output `ca` projected and added to h,
    then the modulated MLP and its gated residual: the layer's output."""
    c_shift, c_scale, c_gate = _modulation(lp, tproj, h.dtype)[3:]
    dtype = h.dtype
    B, L = h.shape[:2]
    h = h + linear(lp.cross_attn.o_proj, ca.reshape(B, L, -1))
    x = rms_norm(lp.mlp_norm, h, cfg.rms_norm_eps) * (1 + c_scale) + c_shift
    return (h + mlp(lp.mlp, x.to(dtype)) * c_gate).to(dtype)


def decoder_out(p: Decoder, cfg: DiTConfig, h: torch.Tensor,
                temb: torch.Tensor, frames: int) -> torch.Tensor:
    """norm_out, modulated by temb, and proj_out: (B, frames, 64)."""
    dtype = h.dtype
    mods = p.scale_shift_table[None].to(dtype) + temb[:, None]
    shift, scale = mods[:, 0:1], mods[:, 1:2]
    h = rms_norm(p.norm_out, h, cfg.rms_norm_eps) * (1 + scale) + shift
    h = conv1d_transpose(p.proj_out, h.to(dtype), stride=cfg.patch_size)
    return h[:, :frames]


def _cross_core(lp: DiTLayer, cfg: DiTConfig, cq: torch.Tensor, kv,
                return_weights: bool = False):
    """The cross-attention core, unmasked, over `kv`: the layer's (k, v)
    or the condition sequence to project them from."""
    if not isinstance(kv, tuple):
        kv = cross_kv(lp.cross_attn, kv, num_kv_heads=cfg.num_key_value_heads,
                      head_dim=cfg.head_dim, eps=cfg.rms_norm_eps)
    return _sdpa(cq, *kv, None, return_weights=return_weights)


def dit_decoder(model: AceStepDiT, cfg: DiTConfig, xt: torch.Tensor,
                timestep: torch.Tensor, timestep_r: torch.Tensor,
                context_latents: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor] = None,
                cross_kv_cache=None, remat: bool = False) -> torch.Tensor:
    """One denoising forward: (B, T, 64) noisy latents -> (B, T, 64)
    velocity. Self-attention uses geometry-only full/banded attention
    through the flash kernel (the plain masked attention when
    `cfg.attention_impl` is "dense"); cross-attention is unmasked.

    remat=True checkpoints each layer (`torch.utils.checkpoint`,
    non-reentrant): its activations are recomputed in the backward, as the
    JAX package rematerialises each scan step. The recompute reads the
    layer's parameters again, so a caller that swaps them for one forward
    (`torch.func.functional_call`) runs the backward inside the swap.

    With `cross_kv_cache` (the samplers' call) on a CUDA device in
    inference, the step runs as CUDA graph replays between its eager
    attention cores (`models/dit_graphs.py`), with the same result."""
    if cross_kv_cache is not None and not remat:
        from acestep_torch.models import dit_graphs

        out = dit_graphs.replay_step(model, cfg, xt, timestep, timestep_r,
                                     context_latents, cross_kv_cache)
        if out is not None:
            return out
    p = model.decoder
    h, tproj, temb = decoder_in(p, cfg, xt, timestep, timestep_r,
                                context_latents)
    L = h.shape[1]
    if cross_kv_cache is None:
        enc = linear(p.condition_embedder, encoder_hidden_states.to(xt.dtype))
    rope = decoder_rope(cfg, L, xt.dtype, h.device)
    self_core = self_attention_core(cfg, L, h.device)

    def layer(i: int, lp: DiTLayer, h: torch.Tensor) -> torch.Tensor:
        q, k, v = self_attn_in(lp, cfg, h, tproj, rope)
        h, cq = self_attn_out(lp, cfg, h,
                              self_core(q, k, v, layer_window(cfg, i)), tproj)
        kv = enc if cross_kv_cache is None else (cross_kv_cache[0][i],
                                                 cross_kv_cache[1][i])
        return cross_out(lp, cfg, h, _cross_core(lp, cfg, cq, kv), tproj)

    for i, lp in enumerate(p.layers):
        if remat:
            h = checkpoint(layer, i, lp, h, use_reentrant=False)
        else:
            h = layer(i, lp, h)
    return decoder_out(p, cfg, h, temb, xt.shape[1])


def dit_decoder_attn_capture(model: AceStepDiT, cfg: DiTConfig,
                             xt: torch.Tensor, timestep: torch.Tensor,
                             timestep_r: torch.Tensor,
                             context_latents: torch.Tensor,
                             encoder_hidden_states: torch.Tensor,
                             capture: dict,
                             early_exit: Optional[int] = None) -> dict:
    """Run the decoder's first layers capturing cross-attention
    probabilities: {layer: (B, len(heads), Tq, Tk) fp32} for `capture`'s
    {layer: [heads]} (the LRC alignment's early-exit pass). Cross-attention
    takes the plain path, whose probabilities are the output;
    self-attention is `dit_decoder`'s."""
    if not capture:
        raise ValueError("capture must map at least one layer -> heads")
    n_layers = early_exit if early_exit is not None else max(capture) + 1
    if max(capture) >= n_layers:
        raise ValueError(
            f"capture layer {max(capture)} is not run under "
            f"early_exit={early_exit} — it would be silently skipped")
    p = model.decoder
    h, tproj, _ = decoder_in(p, cfg, xt, timestep, timestep_r,
                             context_latents)
    L = h.shape[1]
    enc = linear(p.condition_embedder, encoder_hidden_states.to(xt.dtype))
    rope = decoder_rope(cfg, L, xt.dtype, h.device)
    self_core = self_attention_core(cfg, L, h.device)

    captured = {}
    for i in range(n_layers):
        lp = p.layers[i]
        q, k, v = self_attn_in(lp, cfg, h, tproj, rope)
        h, cq = self_attn_out(lp, cfg, h,
                              self_core(q, k, v, layer_window(cfg, i)), tproj)
        ca, probs = _cross_core(lp, cfg, cq, enc, return_weights=True)
        if i in capture:
            captured[i] = probs[:, list(capture[i])].float()
        h = cross_out(lp, cfg, h, ca, tproj)
    return captured


# ==================================================================
# Condition preparation
# ==================================================================


def prepare_condition(model: AceStepDiT, cfg: DiTConfig, *,
                      text_hidden_states, text_attention_mask,
                      lyric_hidden_states, lyric_attention_mask,
                      refer_audio_packed, refer_order_mask,
                      src_latents, chunk_masks, is_covers,
                      silence_latent=None,
                      tokenize_latents=None,
                      precomputed_lm_hints_25hz=None,
                      audio_codes=None,
                      audio_codes_valid_frames=None,
                      max_refer_count: int = 1):
    """(encoder_hidden_states, encoder_attention_mask, context_latents).

    LM-hint source precedence: precomputed 25 Hz hints > audio codes >
    tokenize(src) -> detokenize round trip (the text2music path, which
    tokenizes the silence latent padded to the pool window)."""
    enc, enc_mask = condition_encoder(
        model, cfg,
        text_hidden_states=text_hidden_states,
        text_attention_mask=text_attention_mask,
        lyric_hidden_states=lyric_hidden_states,
        lyric_attention_mask=lyric_attention_mask,
        refer_audio_packed=refer_audio_packed,
        refer_order_mask=refer_order_mask,
        max_refer_count=max_refer_count)
    T = src_latents.shape[1]

    def fit_to_T(hints):
        hints = hints[:, :T, :]
        short = T - hints.shape[1]
        if short > 0:
            hints = F.pad(hints, (0, 0, 0, short))
        return hints

    if precomputed_lm_hints_25hz is not None:
        lm_hints = fit_to_T(precomputed_lm_hints_25hz)
    elif audio_codes is not None:
        q = audio_codes_to_quantized(model, cfg, audio_codes)
        lm_hints = fit_to_T(audio_detokenize(model, cfg, q))
        if audio_codes_valid_frames is not None and silence_latent is not None:
            valid = (torch.arange(T, device=lm_hints.device)[None, :]
                     < audio_codes_valid_frames[:, None])          # (B, T)
            sil = silence_latent[:1, :T, :].to(lm_hints.dtype).expand_as(
                lm_hints)
            lm_hints = torch.where(valid[..., None], lm_hints, sil)
    else:
        x = src_latents if tokenize_latents is None else tokenize_latents
        pad = (-x.shape[1]) % cfg.pool_window_size
        if pad:
            filler = (silence_latent[:1, :pad, :].to(x.dtype)
                      if silence_latent is not None
                      else torch.zeros_like(x[:1, :pad]))
            x = torch.cat([x, filler.expand(x.shape[0], pad, x.shape[2])],
                          dim=1)
        q, _ = audio_tokenize(model, cfg, x)
        lm_hints = audio_detokenize(model, cfg, q)[:, :T, :]

    is_c = is_covers.reshape(-1, 1, 1).to(src_latents.dtype)
    src = torch.where(is_c > 0, lm_hints.to(src_latents.dtype), src_latents)
    context_latents = torch.cat([src, chunk_masks.to(src.dtype)], dim=-1)
    return enc, enc_mask, context_latents


# ==================================================================
# Flow-matching training loss
# ==================================================================


def sample_t_r(batch_size: int, *, generator: torch.Generator,
               data_proportion: float = 0.0, timestep_mu: float = -0.4,
               timestep_sigma: float = 1.0, use_meanflow: bool = True):
    """Logit-normal (t, r) with t >= r, drawn from `generator`; the first
    `batch_size * data_proportion` rows get r = t (all rows without
    meanflow). The JAX function's law on another generator."""
    dev = generator.device
    t = torch.sigmoid(torch.randn(batch_size, generator=generator, device=dev)
                      * timestep_sigma + timestep_mu)
    r = torch.sigmoid(torch.randn(batch_size, generator=generator, device=dev)
                      * timestep_sigma + timestep_mu)
    t, r = torch.maximum(t, r), torch.minimum(t, r)
    if not use_meanflow:
        data_proportion = 1.0
    data_size = int(batch_size * data_proportion)
    zero_mask = torch.arange(batch_size, device=dev) < data_size
    return t, torch.where(zero_mask, t, r)


def training_draws(cfg: DiTConfig, x0: torch.Tensor, *,
                   generator: Optional[torch.Generator] = None,
                   cfg_ratio: float = 0.15,
                   discrete_timesteps: Optional[Sequence[float]] = None,
                   keep: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None,
                   t: Optional[torch.Tensor] = None):
    """`training_loss`'s three draws for the batch `x0` (B, T, C): the
    keep mask (B,) bool, the noise shaped like x0 and the timesteps (B,),
    each taken from `generator` in the JAX function's order unless
    given."""
    bsz, dev = x0.shape[0], x0.device
    if keep is None:
        keep = torch.rand(bsz, generator=generator, device=dev) >= cfg_ratio
    if noise is None:
        noise = torch.randn(x0.shape, generator=generator, device=dev,
                            dtype=x0.dtype)
    if t is None:
        if discrete_timesteps is not None:
            pool = torch.as_tensor(discrete_timesteps, dtype=torch.float32,
                                   device=dev)
            idx = torch.randint(0, pool.shape[0], (bsz,),
                                generator=generator, device=dev)
            t = pool[idx]
        else:
            t, _ = sample_t_r(bsz, generator=generator,
                              data_proportion=cfg.data_proportion,
                              timestep_mu=cfg.timestep_mu,
                              timestep_sigma=cfg.timestep_sigma,
                              use_meanflow=False)
    return keep, noise, t


def training_loss(model: AceStepDiT, cfg: DiTConfig, *,
                  hidden_states, attention_mask,
                  text_hidden_states, text_attention_mask,
                  lyric_hidden_states, lyric_attention_mask,
                  refer_audio_packed, refer_order_mask,
                  src_latents, chunk_masks, is_covers,
                  silence_latent=None, cfg_ratio: float = 0.15,
                  max_refer_count: int = 1,
                  discrete_timesteps: Optional[Sequence[float]] = None,
                  generator: Optional[torch.Generator] = None,
                  keep: Optional[torch.Tensor] = None,
                  noise: Optional[torch.Tensor] = None,
                  t: Optional[torch.Tensor] = None,
                  count: Optional[float] = None,
                  remat: bool = True) -> torch.Tensor:
    """Flow-matching MSE with CFG condition dropout (fp32 scalar).

    Timesteps: continuous logit-normal by default, or drawn uniformly from
    `discrete_timesteps` (the turbo shift-3 schedule). The three random
    draws are taken from `generator` in the JAX function's order (keep
    mask, noise x1, timesteps), unless given: `keep` (B,) bool (True keeps
    the condition), `noise` shaped like `hidden_states`, `t` (B,). JAX keys
    and torch generators draw different numbers, so parity tests pass the
    JAX draws here (`training_draws`). Padded frames (attention_mask 0)
    are left out of the mean. `count` replaces the mean's denominator (the
    batch's valid frames x channels): a dp rank of a mesh passes the whole
    batch's, so the ranks' losses, and their gradients, sum to the
    unsplit batch's."""
    enc, _enc_mask, context_latents = prepare_condition(
        model, cfg,
        text_hidden_states=text_hidden_states,
        text_attention_mask=text_attention_mask,
        lyric_hidden_states=lyric_hidden_states,
        lyric_attention_mask=lyric_attention_mask,
        refer_audio_packed=refer_audio_packed,
        refer_order_mask=refer_order_mask,
        src_latents=src_latents, chunk_masks=chunk_masks, is_covers=is_covers,
        silence_latent=silence_latent, max_refer_count=max_refer_count)
    x0 = hidden_states
    bsz = x0.shape[0]
    dev = x0.device
    keep, noise, t = training_draws(
        cfg, x0, generator=generator, cfg_ratio=cfg_ratio,
        discrete_timesteps=discrete_timesteps, keep=keep, noise=noise, t=t)
    null = model.null_condition_emb.to(enc.dtype)
    enc = torch.where(keep.to(dev).reshape(bsz, 1, 1), enc, null.expand_as(enc))

    x1 = noise.to(x0.dtype)
    t = t.to(device=dev, dtype=x0.dtype)
    tb = t[:, None, None]
    xt = tb * x1 + (1.0 - tb) * x0

    v = dit_decoder(model, cfg, xt, t, t, context_latents,
                    encoder_hidden_states=enc, remat=remat)
    flow = x1 - x0
    sq = (v.float() - flow.float()) ** 2
    m = attention_mask.to(torch.float32)[:, :, None]
    denom = m.sum() * sq.shape[-1] if count is None else \
        torch.tensor(float(count), device=dev)
    return (sq * m).sum() / torch.clamp(denom, min=1.0)
