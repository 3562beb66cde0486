"""Core building blocks: parameter modules and the functions that apply them.

Parameters live in small `nn.Module`s whose attribute names follow the JAX
package's parameter tree (`q_proj`, `q_norm`, `gate`, ...). Linear weights
use PyTorch's (out, in) layout; `utils/weights.py` transposes the JAX
package's (in, out) storage once when weights are carried across.

Numerical conventions match `acestep_tpu/ops/basic.py`: Qwen3-style RMSNorm
(float32 variance, scale applied after the downcast), HF rotate-half RoPE,
GQA with per-head Q/K RMSNorm and a float32 softmax, SwiGLU MLP.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# ------------------------------------------------------------------
# Parameter modules
# ------------------------------------------------------------------


class RMSNorm(nn.Module):
    def __init__(self, dim: int, *, device=None, dtype=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))


class Attention(nn.Module):
    def __init__(self, hidden: int, num_heads: int, num_kv_heads: int,
                 head_dim: int, *, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        self.q_proj = nn.Linear(hidden, num_heads * head_dim, **kw)
        self.k_proj = nn.Linear(hidden, num_kv_heads * head_dim, **kw)
        self.v_proj = nn.Linear(hidden, num_kv_heads * head_dim, **kw)
        self.o_proj = nn.Linear(num_heads * head_dim, hidden, **kw)
        self.q_norm = RMSNorm(head_dim, device=device, dtype=dtype)
        self.k_norm = RMSNorm(head_dim, device=device, dtype=dtype)


class MLP(nn.Module):
    def __init__(self, hidden: int, intermediate: int, *, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        self.gate = nn.Linear(hidden, intermediate, **kw)
        self.up = nn.Linear(hidden, intermediate, **kw)
        self.down = nn.Linear(intermediate, hidden, **kw)


@torch.no_grad()
def seeded_init_(module: nn.Module, generator: torch.Generator,
                 std: float = 0.02) -> None:
    """The JAX package's init distributions, drawn from `generator`:
    linear and conv weights N(0, std), zero biases, unit RMSNorm scales.
    A module with tables of its own (snake, AdaLN, special tokens) draws
    them in an `init_own_(generator)` method, called here."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.ConvTranspose1d)):
            m.weight.normal_(0.0, std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, RMSNorm):
            m.scale.fill_(1.0)
        if hasattr(m, "init_own_"):
            m.init_own_(generator)


# ------------------------------------------------------------------
# Primitives
# ------------------------------------------------------------------


def linear(p: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    y = F.linear(x, p.weight.to(x.dtype))
    if p.bias is not None:
        y = y + p.bias.to(x.dtype)
    return y


def rms_norm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Qwen3RMSNorm: float32 variance, scale applied AFTER the downcast."""
    dtype = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return xf.to(dtype) * p.scale.to(dtype)


def mlp(p: MLP, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: down(silu(gate(x)) * up(x))."""
    return linear(p.down, F.silu(linear(p.gate, x)) * linear(p.up, x))


# ------------------------------------------------------------------
# RoPE (HF rotate-half convention)
# ------------------------------------------------------------------


def rope_cos_sin(seq_len: Optional[int], head_dim: int, theta: float,
                 dtype=torch.float32, positions: Optional[torch.Tensor] = None,
                 *, device=None):
    """(cos, sin), each (*positions.shape, head_dim); frequencies duplicated
    across both halves of the head dim. `positions` defaults to
    arange(seq_len)."""
    if positions is not None:
        device = positions.device
    half = head_dim // 2
    inv_freq = 1.0 / (theta ** (
        torch.arange(0, half, dtype=torch.float32, device=device) / half))
    if positions is None:
        positions = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, L, H, D); cos/sin: (L, D) or (B, L, D)."""
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return x * cos.to(x.dtype) + _rotate_half(x) * sin.to(x.dtype)


# ------------------------------------------------------------------
# Attention (dense path; the decoder's self-attention goes through the
# flash kernel in ops/flash_attention.py)
# ------------------------------------------------------------------


def _qkv(p: Attention, x: torch.Tensor, kv_src: torch.Tensor, num_heads: int,
         num_kv_heads: int, head_dim: int, eps: float):
    B, Lq, _ = x.shape
    Lk = kv_src.shape[1]
    q = linear(p.q_proj, x).reshape(B, Lq, num_heads, head_dim)
    k = linear(p.k_proj, kv_src).reshape(B, Lk, num_kv_heads, head_dim)
    v = linear(p.v_proj, kv_src).reshape(B, Lk, num_kv_heads, head_dim)
    q = rms_norm(p.q_norm, q, eps)
    k = rms_norm(p.k_norm, k, eps)
    return q, k, v


def _sdpa(q, k, v, mask, *, scale: Optional[float] = None):
    """Grouped-query scaled dot-product attention, fp32 logits and softmax.

    q: (B, Lq, Hq, D); k/v: (B, Lk, Hkv, D); mask: bool (B|1, 1, Lq, Lk).
    """
    B, Lq, Hq, D = q.shape
    Hkv = k.shape[2]
    groups = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, Lq, Hkv, groups, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    if mask is not None:
        neg = torch.finfo(torch.float32).min
        logits = logits.masked_fill(~mask[:, :, None, :, :], neg)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(B, Lq, Hq, D)


def attention_kv(p: Attention, x: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, *, num_heads: int, head_dim: int,
                 mask: Optional[torch.Tensor] = None,
                 eps: float = 1e-6) -> torch.Tensor:
    """Attention over precomputed K/V (B, Lk, Hkv, D): the decoder's
    cross-attention with per-trajectory condition K/V."""
    B, Lq, _ = x.shape
    q = linear(p.q_proj, x).reshape(B, Lq, num_heads, head_dim)
    q = rms_norm(p.q_norm, q, eps)
    out = _sdpa(q, k, v, mask)
    return linear(p.o_proj, out.reshape(B, Lq, num_heads * head_dim))


def cross_kv(p: Attention, enc: torch.Tensor, *, num_kv_heads: int,
             head_dim: int, eps: float = 1e-6):
    """Cross-attention K/V from encoder states, once per trajectory."""
    B, Lk, _ = enc.shape
    k = linear(p.k_proj, enc).reshape(B, Lk, num_kv_heads, head_dim)
    v = linear(p.v_proj, enc).reshape(B, Lk, num_kv_heads, head_dim)
    k = rms_norm(p.k_norm, k, eps)
    return k, v


def attention(p: Attention, x: torch.Tensor, *, num_heads: int,
              num_kv_heads: int, head_dim: int,
              kv_src: Optional[torch.Tensor] = None,
              mask: Optional[torch.Tensor] = None,
              rope: Optional[tuple] = None,
              eps: float = 1e-6) -> torch.Tensor:
    """Shared self/cross attention: per-head Q/K RMSNorm, RoPE only on the
    self-attention path, GQA. mask: bool (B|1, 1, Lq, Lk), True = attend."""
    is_cross = kv_src is not None
    src = kv_src if is_cross else x
    q, k, v = _qkv(p, x, src, num_heads, num_kv_heads, head_dim, eps)
    if not is_cross and rope is not None:
        cos, sin = rope
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    out = _sdpa(q, k, v, mask)
    B, Lq = x.shape[:2]
    return linear(p.o_proj, out.reshape(B, Lq, num_heads * head_dim))


def attention_flash(p: Attention, x: torch.Tensor, *, num_heads: int,
                    num_kv_heads: int, head_dim: int,
                    rope: Optional[tuple] = None,
                    window: Optional[int] = None,
                    eps: float = 1e-6) -> torch.Tensor:
    """Self-attention through the flash kernel (full or banded |i-j| <= W).
    Same projections, QK-norm and RoPE as `attention`."""
    from acestep_torch.ops.flash_attention import flash_attention

    q, k, v = _qkv(p, x, x, num_heads, num_kv_heads, head_dim, eps)
    if rope is not None:
        cos, sin = rope
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    out = flash_attention(q, k, v, window=window)
    B, Lq = x.shape[:2]
    return linear(p.o_proj, out.reshape(B, Lq, num_heads * head_dim))


# ------------------------------------------------------------------
# Timestep embedding (scale 1000, [cos, sin] order)
# ------------------------------------------------------------------


def timestep_sinusoidal(t: torch.Tensor, dim: int, *, scale: float = 1000.0,
                        max_period: float = 10_000.0) -> torch.Tensor:
    """t: (B,) fractional timesteps -> (B, dim) float32 embedding."""
    t = t.float() * scale
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None] * freqs[None]
    emb = torch.cat([args.cos(), args.sin()], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb
