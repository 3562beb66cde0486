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
  full attention.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from acestep_torch.config import DiTConfig
from acestep_torch.ops.basic import (
    MLP, Attention, RMSNorm, attention, attention_flash, attention_kv,
    cross_kv, linear, mlp, rms_norm, rope_cos_sin, seeded_init_,
    timestep_sinusoidal,
)
from acestep_torch.ops.conv import conv1d, conv1d_transpose
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
    """5 Hz code ids (B, T5) -> quantized hidden (B, T5, H)."""
    codes = fsq_indices_to_codes(indices, cfg.fsq_levels)
    proj = model.tokenizer.fsq.project_out
    return linear(proj, codes.to(proj.weight.dtype))


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


def dit_decoder(model: AceStepDiT, cfg: DiTConfig, xt: torch.Tensor,
                timestep: torch.Tensor, timestep_r: torch.Tensor,
                context_latents: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor] = None,
                cross_kv_cache=None) -> torch.Tensor:
    """One denoising forward: (B, T, 64) noisy latents -> (B, T, 64)
    velocity. Self-attention uses geometry-only full/banded attention
    through the flash kernel; cross-attention is unmasked."""
    p = model.decoder
    eps = cfg.rms_norm_eps
    dtype = xt.dtype
    B, T0, _ = xt.shape

    temb_t, proj_t = _timestep_embed(p.time_embed, timestep, dtype)
    temb_r, proj_r = _timestep_embed(p.time_embed_r, timestep - timestep_r,
                                     dtype)
    temb = temb_t + temb_r
    tproj = proj_t + proj_r                                   # (B, 6, H)

    h = torch.cat([context_latents.to(dtype), xt], dim=-1)
    pad = (-T0) % cfg.patch_size
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
    h = conv1d(p.proj_in, h, stride=cfg.patch_size)           # (B, L, H)
    L = h.shape[1]

    if cross_kv_cache is None:
        enc = linear(p.condition_embedder, encoder_hidden_states.to(dtype))
    rope = rope_cos_sin(L, cfg.head_dim, cfg.rope_theta, dtype=dtype,
                        device=h.device)

    for i, lp in enumerate(p.layers):
        mods = lp.scale_shift_table[None].to(dtype) + tproj   # (B, 6, H)
        shift_msa, scale_msa, gate_msa, c_shift, c_scale, c_gate = [
            mods[:, j:j + 1] for j in range(6)]
        norm_h = rms_norm(lp.self_attn_norm, h, eps) * (1 + scale_msa) \
            + shift_msa
        window = cfg.sliding_window if cfg.layer_is_sliding(i) else None
        a = attention_flash(lp.self_attn, norm_h.to(dtype),
                            num_heads=cfg.num_attention_heads,
                            num_kv_heads=cfg.num_key_value_heads,
                            head_dim=cfg.head_dim, rope=rope, window=window,
                            eps=eps)
        h = h + a * gate_msa

        norm_h = rms_norm(lp.cross_attn_norm, h, eps)
        if cross_kv_cache is None:
            ca = attention(lp.cross_attn, norm_h,
                           num_heads=cfg.num_attention_heads,
                           num_kv_heads=cfg.num_key_value_heads,
                           head_dim=cfg.head_dim, kv_src=enc, eps=eps)
        else:
            ca = attention_kv(lp.cross_attn, norm_h, cross_kv_cache[0][i],
                              cross_kv_cache[1][i],
                              num_heads=cfg.num_attention_heads,
                              head_dim=cfg.head_dim, eps=eps)
        h = h + ca

        norm_h = rms_norm(lp.mlp_norm, h, eps) * (1 + c_scale) + c_shift
        h = (h + mlp(lp.mlp, norm_h.to(dtype)) * c_gate).to(dtype)

    mods = p.scale_shift_table[None].to(dtype) + temb[:, None]
    shift, scale = mods[:, 0:1], mods[:, 1:2]
    h = rms_norm(p.norm_out, h, eps) * (1 + scale) + shift
    h = conv1d_transpose(p.proj_out, h.to(dtype), stride=cfg.patch_size)
    return h[:, :T0]


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
