"""Plain float32 reference of the Oobleck VAE decoder (25 Hz x 64 latents
-> 48 kHz stereo) and of the serving path's decode plan around it: time
segments with a 16-frame margin for long songs, overlapping windows
inside each, the int16 + peak transfer to the host and the -1 dBFS peak
normalisation.

Decoder: conv(k7) -> per level [snake -> transposed conv (k = 2 x stride)
-> 3 residual units (snake -> dilated conv k7 -> snake -> conv k1, +x,
dilations 1/3/9)] -> snake -> conv(k7, no bias). Snake is
x + sin(exp(alpha) x)^2 / (exp(beta) + 1e-9). Weight norm is fused in the
checkpoint layout the benchmark loads.

Imports nothing but torch and numpy.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor

DECODE_OVERLAP = 16       # latent frames of context each side of a window
SEGMENT_FRAMES = 768      # latent frames a decode segment covers at most
MAX_SEGMENTS = 8


def _res_shapes(p: str, c: int) -> Dict[str, tuple]:
    out = {}
    for s in ("snake1", "snake2"):
        out[f"{p}.{s}.alpha"] = (c,)
        out[f"{p}.{s}.beta"] = (c,)
    out.update({f"{p}.conv1.weight": (c, c, 7), f"{p}.conv1.bias": (c,),
                f"{p}.conv2.weight": (c, c, 1), f"{p}.conv2.bias": (c,)})
    return out


def param_shapes(vae: dict) -> Dict[str, tuple]:
    """Every tensor of the VAE checkpoint (encoder and decoder)."""
    cm = [1] + list(vae["channel_multiples"])
    ratios = list(vae["downsampling_ratios"])
    n = len(ratios)
    h, dch = vae["encoder_hidden_size"], vae["decoder_channels"]
    lat, ach = vae["decoder_input_channels"], vae["audio_channels"]
    out: Dict[str, tuple] = {
        "encoder.conv1.weight": (h, ach, 7), "encoder.conv1.bias": (h,),
        "encoder.snake.alpha": (h * cm[-1],), "encoder.snake.beta": (h * cm[-1],),
        "encoder.conv2.weight": (2 * lat, h * cm[-1], 3),
        "encoder.conv2.bias": (2 * lat,)}
    for i, s in enumerate(ratios):
        p, cin, cout = f"encoder.blocks.{i}", h * cm[i], h * cm[i + 1]
        for r in ("res1", "res2", "res3"):
            out.update(_res_shapes(f"{p}.{r}", cin))
        out.update({f"{p}.snake.alpha": (cin,), f"{p}.snake.beta": (cin,),
                    f"{p}.down.weight": (cout, cin, 2 * s),
                    f"{p}.down.bias": (cout,)})
    out.update({"decoder.conv1.weight": (dch * cm[-1], lat, 7),
                "decoder.conv1.bias": (dch * cm[-1],),
                "decoder.snake.alpha": (dch,), "decoder.snake.beta": (dch,),
                "decoder.conv2.weight": (ach, dch, 7)})
    for i, s in enumerate(ratios[::-1]):
        p, cin, cout = f"decoder.blocks.{i}", dch * cm[n - i], dch * cm[n - i - 1]
        out.update({f"{p}.snake.alpha": (cin,), f"{p}.snake.beta": (cin,),
                    f"{p}.up.weight": (cin, cout, 2 * s), f"{p}.up.bias": (cout,)})
        for r in ("res1", "res2", "res3"):
            out.update(_res_shapes(f"{p}.{r}", cout))
    return out


def hop(vae: dict) -> int:
    return math.prod(vae["downsampling_ratios"])


def _snake(W: dict, p: str, x: Tensor) -> Tensor:
    """x (B, C, L)."""
    a = W[f"{p}.alpha"].exp()[None, :, None]
    b = W[f"{p}.beta"].exp()[None, :, None]
    return x + torch.sin(a * x).pow(2) / (b + 1e-9)


def _conv(W: dict, p: str, x: Tensor, **kw) -> Tensor:
    return F.conv1d(x, W[f"{p}.weight"], W.get(f"{p}.bias"), **kw)


def decode(W: dict, vae: dict, z: Tensor) -> Tensor:
    """z (B, T, 64) -> audio (B, T * hop, 2), whole, no tiling."""
    x = _conv(W, "decoder.conv1", z.transpose(1, 2), padding=3)
    for i, s in enumerate(list(vae["downsampling_ratios"])[::-1]):
        p = f"decoder.blocks.{i}"
        x = F.conv_transpose1d(_snake(W, f"{p}.snake", x), W[f"{p}.up.weight"],
                               W[f"{p}.up.bias"], stride=s,
                               padding=math.ceil(s / 2))
        for r, dil in (("res1", 1), ("res2", 3), ("res3", 9)):
            rp = f"{p}.{r}"
            y = _conv(W, f"{rp}.conv1", _snake(W, f"{rp}.snake1", x),
                      padding=3 * dil, dilation=dil)
            x = x + _conv(W, f"{rp}.conv2", _snake(W, f"{rp}.snake2", y))
    x = _conv(W, "decoder.conv2", _snake(W, "decoder.snake", x), padding=3)
    return x.transpose(1, 2)


def tiled_decode(W: dict, vae: dict, z: Tensor, chunk: int) -> Tensor:
    """Windows of `chunk` frames, `DECODE_OVERLAP` of context each side
    (zero-padded at the ends), each decoded alone and trimmed to its core;
    a signal no longer than one chunk is decoded whole."""
    B, T, _ = z.shape
    if T <= chunk:
        return decode(W, vae, z)
    ov = DECODE_OVERLAP
    while chunk - 2 * ov <= 0 and ov > 0:
        ov //= 2
    stride, hp = chunk - 2 * ov, hop(vae)
    n = -(-T // stride)
    zp = F.pad(z, (0, 0, ov, n * stride - T + ov))
    cores = [decode(W, vae, zp[:, i * stride: i * stride + stride + 2 * ov])
             [:, ov * hp: (ov + stride) * hp] for i in range(n)]
    return torch.cat(cores, 1)[:, : T * hp]


def _to_host(audio: Tensor) -> np.ndarray:
    """The int16 + per-item peak transfer: round to 1/32767 of the peak."""
    peak = audio.abs().amax(dim=(1, 2), keepdim=True)
    scale = peak.clamp_min(1e-8) / 32767.0
    i16 = torch.clamp(torch.round(audio / scale), -32768, 32767)
    return (i16 * (peak / 32767.0)).cpu().numpy().astype(np.float32)


def decode_plan_chunk(T: int, tier_chunk: int) -> int:
    """Window length of a T-frame decode: 256 frames up to 2048, else 512,
    capped by the card tier's decode chunk."""
    return min(512 if T > 2048 else 256, tier_chunk)


def decode_song(W: dict, vae: dict, z: Tensor, tier_chunk: int) -> np.ndarray:
    """One song's latents (1, T, 64) -> host audio (1, T * hop, 2) as the
    serving path decodes it: a long song in up to 8 equal time segments,
    each with a 16-frame margin both sides, each tiled."""
    B, T, _ = z.shape
    segs = min(MAX_SEGMENTS, max(1, -(-T // SEGMENT_FRAMES)))
    if segs == 1:
        return _to_host(tiled_decode(W, vae, z, decode_plan_chunk(T, tier_chunk)))
    hp, m = hop(vae), DECODE_OVERLAP
    core = -(-T // segs)
    zp = F.pad(z, (0, 0, m, segs * core - T + m))
    seg_len = core + 2 * m
    parts = [_to_host(tiled_decode(W, vae, zp[:, i * core: i * core + seg_len],
                                   decode_plan_chunk(seg_len, tier_chunk)))
             [:, m * hp: (m + core) * hp] for i in range(segs)]
    return np.concatenate(parts, axis=1)[:, : T * hp]


def peak_normalize(audio: np.ndarray, target_dbfs: float = -1.0) -> np.ndarray:
    peak = float(np.max(np.abs(audio)))
    if peak <= 1e-8:
        return audio
    return (audio * (10.0 ** (target_dbfs / 20.0) / peak)).astype(np.float32)


def tier_decode_chunk(device_gib: float) -> int:
    """The decode chunk of the serving tier a device of `device_gib`
    (0 for the CPU) falls in: 128 on the CPU, 64 under 8 GiB, then 128,
    256 and, from 32 GiB up, 512."""
    if device_gib <= 0:
        return 128
    for floor, chunk in ((32, 512), (16, 256), (8, 128)):
        if device_gib >= floor:
            return chunk
    return 64
