"""Flash attention (bidirectional, GQA, optional sliding band |i-j| <= W).

`flash_attention` launches the hand-written Hopper kernels for CUDA tensors
and runs the dense plain versions with the same semantics for CPU tensors:

- forward: `csrc/flash_attention.cu` (replaces
  `acestep_tpu/ops/flash_attention.py::_kernel`) or `flash_attention_plain`;
- backward: `csrc/flash_attention_bwd.cu`, whose dQ kernel replaces
  `_bwd_dq_kernel` and whose dK/dV kernel replaces `_bwd_dkv_kernel`, or
  `flash_attention_bwd_plain`.

`FlashAttention` is the autograd Function over the pair, the counterpart of
the JAX package's `custom_vjp`: it saves (q, k, v, out, lse) and recomputes
P from lse in the backward. A CUDA tensor the kernels do not take raises;
nothing falls back.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
HEAD_DIM = 128            # the head dim the kernel is compiled for

launches = 0              # forward kernel launches since the last reset
launches_bwd_dq = 0       # dQ kernel launches since the last reset
launches_bwd_dkv = 0      # dK/dV kernel launches since the last reset


def _band(Lq: int, Lk: int, window: Optional[int], device):
    """(Lq, Lk) bool band |i - j| <= window, or None for full attention."""
    if window is None:
        return None
    i = torch.arange(Lq, device=device)[:, None]
    j = torch.arange(Lk, device=device)[None, :]
    return (i - j).abs() <= window


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
    valid = _band(Lq, Lk, window, q.device)
    if valid is not None:
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


def _delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, laid out (B, Hq, Lq) like lse."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, dout: torch.Tensor,
                              window: Optional[int] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Dense backward of `flash_attention_plain`, the JAX backward kernels'
    own math: P = exp(scale * q.k - lse) recomputed from lse and selected
    to 0 outside the band, delta = rowsum(dO * O), dS = P * (dO.V^T -
    delta) * scale, dQ = dS K, dK = dS^T Q and dV = P^T dO with the G query
    heads of a group summed into their KV head. Products accumulate in
    fp32; P and dS are cast to the operands' dtype first, as the kernels
    do. Returns (dq, dk, dv) in q's, k's and v's dtypes."""
    B, Lq, Hq, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    groups = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Lq, Hkv, groups, D)
    dog = dout.reshape(B, Lq, Hkv, groups, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    lse = lse.reshape(B, Hkv, groups, Lq, 1)
    p = torch.exp(s - lse)
    valid = _band(Lq, Lk, window, q.device)
    if valid is not None:
        p = torch.where(valid, p, torch.zeros((), device=q.device))
    delta = _delta(out, dout).reshape(B, Hkv, groups, Lq, 1)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog.float(), v.float())
    ds = p * (dp - delta) * scale
    ds_q = ds.to(q.dtype).float()
    p_v = p.to(dout.dtype).float()
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds_q, k.float())
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds_q, qg.float())
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p_v, dog.float())
    return (dq.reshape(B, Lq, Hq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor,
                             window: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Launch the dQ and the dK/dV kernels on `torch.cuda.current_stream()`;
    delta is a plain reduction. Returns (dq, dk, dv) bf16. Inputs are made
    contiguous first (autograd may hand over a strided dO)."""
    global launches_bwd_dq, launches_bwd_dkv
    from acestep_torch.ops import _build

    q, k, v, dout = (t.contiguous() for t in (q, k, v, dout))
    _check_cuda(q, k, v)
    if dout.shape != q.shape or dout.dtype != q.dtype \
            or dout.device != q.device:
        raise ValueError(f"flash_attention backward: dout {tuple(dout.shape)}"
                         f" {dout.dtype} must match q {tuple(q.shape)}")
    B, Lq, Hq, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    if lse.shape != (B, Hq, Lq) or lse.dtype != torch.float32 \
            or lse.device != q.device:
        raise ValueError(f"flash_attention backward: lse must be fp32 "
                         f"{(B, Hq, Lq)} on q's device, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    lse = lse.contiguous()
    delta = _delta(out, dout)
    lib = _build.library()
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    w = -1 if window is None else int(window)
    scale = 1.0 / math.sqrt(D)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    launches_bwd_dq += 1
    err = lib.acestep_flash_bwd_dq(*ptrs, dq.data_ptr(), B, Lq, Lk, Hq, Hkv,
                                   w, scale, stream)
    _build.check(err, "acestep_flash_bwd_dq")
    launches_bwd_dkv += 1
    err = lib.acestep_flash_bwd_dkv(*ptrs, dk.data_ptr(), dv.data_ptr(), B,
                                    Lq, Lk, Hq, Hkv, w, scale, stream)
    _build.check(err, "acestep_flash_bwd_dkv")
    return dq, dk, dv


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, window: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse): the kernel for CUDA tensors, the plain version for CPU.
    Not differentiable; `flash_attention` is."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, window)
    return flash_attention_cuda(q, k, v, window)


def flash_attention_bwd(q, k, v, out, lse, dout, window=None):
    """(dq, dk, dv): the kernels for CUDA tensors, the plain version for
    CPU."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, window)
    return flash_attention_bwd_cuda(q, k, v, out, lse, dout, window)


class FlashAttention(torch.autograd.Function):
    """out = attention(q, k, v); the backward recomputes P from the saved
    logsumexp (the JAX package's `custom_vjp`, `_flash_fwd`/`_flash_bwd`)."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        out, lse = flash_attention_with_lse(q, k, v, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, ctx.window)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: Optional[int] = None) -> torch.Tensor:
    """q (B, Lq, Hq, D), k/v (B, Lk, Hkv, D) -> (B, Lq, Hq, D).
    RoPE and QK-norm are applied by the caller (ops.basic). Differentiable
    through `FlashAttention`; with no gradient to track (`torch.no_grad()`,
    inference) the forward runs alone."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, window)
    return flash_attention_with_lse(q, k, v, window=window)[0]
