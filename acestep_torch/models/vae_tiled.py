"""Tiled VAE decode/encode with the uniform-window overlap-trim.

Port of `acestep_tpu/models/vae_tiled.py`. The signal is padded with
`overlap` zeros on the left and to a whole number of strides plus `overlap`
on the right, so every window is exactly `stride + 2*overlap` long; each
window's core is kept and its context trimmed. Windows are decoded in groups
folded into the batch axis (the group axis is padded with zero windows to a
whole number of groups), one group after another. A signal no longer than
one chunk is decoded untiled.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from acestep_torch.config import VAEConfig
from acestep_torch.models.vae import vae_decode, vae_encode_moments

DEFAULT_DECODE_CHUNK = 256   # latent frames per window
DEFAULT_DECODE_OVERLAP = 16  # latent frames of context each side
DEFAULT_ENCODE_CHUNK = 1024
DEFAULT_ENCODE_OVERLAP = 8


def _fit_overlap(chunk_size: int, overlap: int) -> int:
    """Halve the overlap until the stride (chunk - 2*overlap) is positive."""
    while chunk_size - 2 * overlap <= 0 and overlap > 0:
        overlap //= 2
    return overlap


def _windows(x: torch.Tensor, stride: int, overlap: int):
    """Pad (B, L, C) along axis 1 and return (n, B, stride + 2*overlap, C)."""
    B, L, C = x.shape
    n = -(-L // stride)
    pad_r = n * stride - L + overlap
    xp = F.pad(x, (0, 0, overlap, pad_r))
    win = stride + 2 * overlap
    return torch.stack([xp[:, i * stride: i * stride + win]
                        for i in range(n)]), n


def _grouped_map(wins: torch.Tensor, n: int, parallel_windows: int,
                 fn: Callable):
    """Run `fn` over (G, B, win, C) groups of windows, padding the window
    axis with zero windows to whole groups; returns `fn`'s outputs (a
    tensor or a tuple of tensors) concatenated and trimmed to n windows."""
    groups = max(1, min(parallel_windows, n))
    pad_n = (-n) % groups
    if pad_n:
        wins = torch.cat([wins, torch.zeros_like(wins[:pad_n])], dim=0)
    outs = [fn(wins[i:i + groups]) for i in range(0, n + pad_n, groups)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts, dim=0)[:n] for parts in zip(*outs))
    return torch.cat(outs, dim=0)[:n]


def tiled_decode(params, cfg: VAEConfig, latents: torch.Tensor, *,
                 chunk_size: int = DEFAULT_DECODE_CHUNK,
                 overlap: int = DEFAULT_DECODE_OVERLAP,
                 parallel_windows: int = 16) -> torch.Tensor:
    """latents (B, T, C) -> audio (B, T*hop, audio_channels)."""
    B, T, _ = latents.shape
    hop = cfg.hop_length
    overlap = _fit_overlap(chunk_size, overlap)
    stride = chunk_size - 2 * overlap
    if T <= chunk_size:
        return vae_decode(params, cfg, latents)
    wins, n = _windows(latents, stride, overlap)

    def decode_group(group):                          # (G, B, win, C)
        G = group.shape[0]
        audio = vae_decode(params, cfg, group.reshape(G * B, *group.shape[2:]))
        audio = audio.reshape(G, B, *audio.shape[1:])
        return audio[:, :, overlap * hop: audio.shape[2] - overlap * hop]

    cores = _grouped_map(wins, n, parallel_windows, decode_group)
    audio = cores.transpose(0, 1).reshape(B, n * stride * hop, -1)
    return audio[:, : T * hop]


def tiled_encode(params, cfg: VAEConfig, audio: torch.Tensor, *,
                 chunk_size: int = DEFAULT_ENCODE_CHUNK,
                 overlap: int = DEFAULT_ENCODE_OVERLAP,
                 parallel_windows: int = 8,
                 generator: torch.Generator = None) -> torch.Tensor:
    """audio (B, L, ch) -> latents (B, ceil(L/hop), latent_dim); the mean,
    or a sample when `generator` is given."""
    B, L, _ = audio.shape
    hop = cfg.hop_length
    T = -(-L // hop)
    if T * hop > L:
        audio = F.pad(audio, (0, 0, 0, T * hop - L))
    if T <= chunk_size:
        mean, std = vae_encode_moments(params, cfg, audio)
        return _sample(mean, std, generator)
    overlap = _fit_overlap(chunk_size, overlap)
    wins, n = _windows(audio, (chunk_size - 2 * overlap) * hop, overlap * hop)

    def encode_group(group):                          # (G, B, win_s, ch)
        G = group.shape[0]
        mean, std = vae_encode_moments(
            params, cfg, group.reshape(G * B, *group.shape[2:]))
        mean = mean.reshape(G, B, *mean.shape[1:])
        std = std.reshape(G, B, *std.shape[1:])
        end = mean.shape[2] - overlap
        return mean[:, :, overlap:end], std[:, :, overlap:end]

    means, stds = _grouped_map(wins, n, parallel_windows, encode_group)
    stride_t = chunk_size - 2 * overlap
    mean = means.transpose(0, 1).reshape(B, n * stride_t, -1)[:, :T]
    std = stds.transpose(0, 1).reshape(B, n * stride_t, -1)[:, :T]
    return _sample(mean, std, generator)


def _sample(mean, std, generator):
    if generator is None:
        return mean
    noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                        dtype=mean.dtype)
    return mean + std * noise
