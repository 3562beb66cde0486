"""Flash attention (bidirectional, GQA, optional sliding band |i-j| <= W).

`flash_attention` launches the hand-written Hopper kernel
(`csrc/flash_attention.cu`, which replaces
`acestep_tpu/ops/flash_attention.py::_kernel`) for CUDA tensors and runs
`flash_attention_plain`, the dense version with the same semantics, for CPU
tensors. A CUDA tensor the kernel does not take raises; it never falls back.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
HEAD_DIM = 128            # the head dim the kernel is compiled for

launches = 0              # kernel launches since the last reset


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          window: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense reference: q (B, Lq, Hq, D), k/v (B, Lk, Hkv, D) ->
    (out (B, Lq, Hq, D) in q's dtype, lse (B, Hq, Lq) fp32).

    fp32 logits and softmax, the band |i-j| <= window, probabilities cast to
    v's dtype for the P.V product (as `flash_attention_reference` does). A
    row with no valid key gets out = 0 and lse = NEG_INF, as in the kernel.
    """
    B, Lq, Hq, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    groups = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Lq, Hkv, groups, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    valid = None
    if window is not None:
        i = torch.arange(Lq, device=q.device)[:, None]
        j = torch.arange(Lk, device=q.device)[None, :]
        valid = (i - j).abs() <= window
        logits = logits.masked_fill(~valid, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)                    # (B,Hkv,G,Lq)
    probs = torch.exp(logits - lse[..., None])
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    out = out.reshape(B, Lq, Hq, D)
    lse = lse.reshape(B, Hq, Lq)
    if valid is not None:
        any_valid = valid.any(dim=-1)                        # (Lq,)
        out = out.masked_fill(~any_valid[None, :, None, None], 0)
        lse = lse.masked_fill(~any_valid[None, None, :], NEG_INF)
    return out.to(q.dtype), lse


def _check_cuda(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be on q's CUDA "
                             f"device, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention: {name} must be bfloat16, got "
                            f"{t.dtype}")
        if t.dim() != 4 or t.shape[-1] != HEAD_DIM:
            raise ValueError(f"flash_attention: {name} must be (B, L, H, "
                             f"{HEAD_DIM}), got {tuple(t.shape)}")
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} needs unit stride on "
                             f"the head dim and 16-byte aligned rows, got "
                             f"strides {t.stride()}")
    B, Lq, Hq, _ = q.shape
    if k.shape != v.shape or k.shape[0] != B:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must match with batch {B}")
    if Hq % k.shape[2]:
        raise ValueError(f"flash_attention: {Hq} query heads are not a "
                         f"multiple of {k.shape[2]} KV heads")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         window: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on `torch.cuda.current_stream()`; returns
    (out (B, Lq, Hq, D) bf16, lse (B, Hq, Lq) fp32)."""
    global launches
    from acestep_torch.ops import _build

    _check_cuda(q, k, v)
    lib = _build.library()
    B, Lq, Hq, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    out = torch.empty((B, Lq, Hq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, Lq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    launches += 1
    err = lib.acestep_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, Lq, Lk, Hq, Hkv,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        -1 if window is None else int(window), 1.0 / math.sqrt(D), stream)
    _build.check(err, "acestep_flash_fwd")
    return out, lse


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, window: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse): the kernel for CUDA tensors, the plain version for CPU."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, window)
    return flash_attention_cuda(q, k, v, window)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: Optional[int] = None) -> torch.Tensor:
    """q (B, Lq, Hq, D), k/v (B, Lk, Hkv, D) -> (B, Lq, Hq, D).
    RoPE and QK-norm are applied by the caller (ops.basic)."""
    return flash_attention_with_lse(q, k, v, window=window)[0]
