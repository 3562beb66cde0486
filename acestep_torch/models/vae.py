"""Oobleck audio VAE (48 kHz stereo <-> 25 Hz x 64-dim latents).

Port of `acestep_tpu/models/vae.py`: Snake1d -> residual unit (k=7 dilated
+ k=1, residual) -> encoder block (3 res units dil 1/3/9 -> snake -> strided
conv down) / decoder block (snake -> strided conv-transpose up -> 3 res
units) -> diagonal Gaussian (softplus scale). Public tensors are NLC
(batch, length, channels). Weight norm is fused before the weights arrive.

On a CUDA device the residual stacks with C <= 256 (the decoder's three
finest levels) run as one fused kernel each (ops/snake_conv.py).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from acestep_torch.config import VAEConfig
from acestep_torch.ops.basic import seeded_init_
from acestep_torch.ops.conv import conv1d, conv1d_transpose
from acestep_torch.ops.snake_conv import _sin2, res_unit_stack

FUSED_MAX_CHANNELS = 256   # stacks this narrow go through the fused kernel

# ------------------------------------------------------------------
# Modules (attribute names follow the JAX parameter tree)
# ------------------------------------------------------------------


class Snake(nn.Module):
    """x + (1/exp(beta)) * sin(exp(alpha) * x)^2, alpha/beta stored in log."""

    def __init__(self, dim: int, *, device=None, dtype=None):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))
        self.beta = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))

    @torch.no_grad()
    def init_own_(self, generator):
        self.alpha.zero_()
        self.beta.zero_()


class ResUnit(nn.Module):
    def __init__(self, dim: int, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.snake1 = Snake(dim, **kw)
        self.conv1 = nn.Conv1d(dim, dim, 7, **kw)
        self.snake2 = Snake(dim, **kw)
        self.conv2 = nn.Conv1d(dim, dim, 1, **kw)


class EncoderBlock(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, stride: int, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.res1 = ResUnit(in_dim, **kw)
        self.res2 = ResUnit(in_dim, **kw)
        self.res3 = ResUnit(in_dim, **kw)
        self.snake = Snake(in_dim, **kw)
        self.down = nn.Conv1d(in_dim, out_dim, 2 * stride, **kw)


class DecoderBlock(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, stride: int, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.snake = Snake(in_dim, **kw)
        self.up = nn.ConvTranspose1d(in_dim, out_dim, 2 * stride, **kw)
        self.res1 = ResUnit(out_dim, **kw)
        self.res2 = ResUnit(out_dim, **kw)
        self.res3 = ResUnit(out_dim, **kw)


class OobleckEncoder(nn.Module):
    def __init__(self, cfg: VAEConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        cm = [1] + list(cfg.channel_multiples)
        h = cfg.encoder_hidden_size
        self.conv1 = nn.Conv1d(cfg.audio_channels, h, 7, **kw)
        self.blocks = nn.ModuleList(
            EncoderBlock(h * cm[i], h * cm[i + 1], s, **kw)
            for i, s in enumerate(cfg.downsampling_ratios))
        self.snake = Snake(h * cm[-1], **kw)
        self.conv2 = nn.Conv1d(h * cm[-1], 2 * cfg.decoder_input_channels, 3,
                               **kw)


class OobleckDecoder(nn.Module):
    def __init__(self, cfg: VAEConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        cm = [1] + list(cfg.channel_multiples)
        n = len(cfg.downsampling_ratios)
        dch = cfg.decoder_channels
        up = list(cfg.downsampling_ratios)[::-1]
        self.conv1 = nn.Conv1d(cfg.decoder_input_channels, dch * cm[-1], 7,
                               **kw)
        self.blocks = nn.ModuleList(
            DecoderBlock(dch * cm[n - i], dch * cm[n - i - 1], up[i], **kw)
            for i in range(n))
        self.snake = Snake(dch, **kw)
        self.conv2 = nn.Conv1d(dch, cfg.audio_channels, 7, bias=False, **kw)


class OobleckVAE(nn.Module):
    def __init__(self, cfg: VAEConfig, *, device=None, dtype=None):
        super().__init__()
        self.encoder = OobleckEncoder(cfg, device=device, dtype=dtype)
        self.decoder = OobleckDecoder(cfg, device=device, dtype=dtype)


def init_vae_params(cfg: VAEConfig, generator: torch.Generator, *,
                    dtype=torch.float32) -> OobleckVAE:
    """Seeded VAE on `generator`'s device: conv weights N(0, 0.02), zero
    biases, zero snake alpha and beta (the JAX init's distributions)."""
    vae = OobleckVAE(cfg, device="meta", dtype=dtype)
    vae = vae.to_empty(device=generator.device)
    seeded_init_(vae, generator)
    return vae.requires_grad_(False)


# ------------------------------------------------------------------
# Forward functions
# ------------------------------------------------------------------


def snake1d(p: Snake, x: torch.Tensor) -> torch.Tensor:
    """Snake in fp32 with the `_sin2` polynomial (the fused kernel's)."""
    alpha = p.alpha.float().exp()
    beta = p.beta.float().exp()
    xf = x.float()
    out = xf + (1.0 / (beta + 1e-9)) * _sin2(alpha * xf)
    return out.to(x.dtype)


def _res_unit(p: ResUnit, x: torch.Tensor, dilation: int) -> torch.Tensor:
    pad = ((7 - 1) * dilation) // 2
    y = conv1d(p.conv1, snake1d(p.snake1, x), padding=pad, dilation=dilation)
    y = conv1d(p.conv2, snake1d(p.snake2, y))
    return x + y


def _res_stack(units, x: torch.Tensor) -> torch.Tensor:
    """The 3-unit residual stack (dilations 1/3/9). Stacks with
    C <= FUSED_MAX_CHANNELS go through ops/snake_conv.res_unit_stack (the
    fused kernel on a CUDA device); wider ones compose the plain ops."""
    if x.shape[-1] <= FUSED_MAX_CHANNELS:
        return res_unit_stack(units, x.contiguous())
    for u, d in zip(units, (1, 3, 9)):
        x = _res_unit(u, x, d)
    return x


def _encoder_block(p: EncoderBlock, x: torch.Tensor,
                   stride: int) -> torch.Tensor:
    x = _res_stack((p.res1, p.res2, p.res3), x)
    x = snake1d(p.snake, x)
    return conv1d(p.down, x, stride=stride, padding=math.ceil(stride / 2))


def _decoder_block(p: DecoderBlock, x: torch.Tensor,
                   stride: int) -> torch.Tensor:
    x = conv1d_transpose(p.up, snake1d(p.snake, x), stride=stride,
                         padding=math.ceil(stride / 2))
    return _res_stack((p.res1, p.res2, p.res3), x)


def vae_encode_moments(params: OobleckVAE, cfg: VAEConfig,
                       audio: torch.Tensor):
    """audio (B, L, audio_channels) -> (mean, std), each (B, L', latent).
    std = softplus(scale) + 1e-4."""
    p = params.encoder
    x = conv1d(p.conv1, audio, padding=3)
    for blk, stride in zip(p.blocks, cfg.downsampling_ratios):
        x = _encoder_block(blk, x, stride)
    x = snake1d(p.snake, x)
    x = conv1d(p.conv2, x, padding=1)
    mean, scale = x.chunk(2, dim=-1)
    sf = scale.float()
    std = torch.where(sf > 20.0, sf,
                      torch.log1p(torch.exp(torch.clamp(sf, max=20.0)))) + 1e-4
    return mean, std.to(mean.dtype)


def vae_decode(params: OobleckVAE, cfg: VAEConfig,
               latents: torch.Tensor) -> torch.Tensor:
    """latents (B, T, latent_dim) -> audio (B, T*hop, audio_channels)."""
    p = params.decoder
    x = conv1d(p.conv1, latents, padding=3)
    for blk, stride in zip(p.blocks, list(cfg.downsampling_ratios)[::-1]):
        x = _decoder_block(blk, x, stride)
    x = snake1d(p.snake, x)
    return conv1d(p.conv2, x, padding=3)
