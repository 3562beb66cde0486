"""Boolean attention-mask builders (True = attend), shared across layers."""

from __future__ import annotations

from typing import Optional

import torch


def _geometry(seq_len: int, *, is_causal: bool, window: Optional[int],
              device=None) -> torch.Tensor:
    """(L, L) boolean geometry mask."""
    idx = torch.arange(seq_len, device=device)
    diff = idx[:, None] - idx[None, :]
    m = torch.ones((seq_len, seq_len), dtype=torch.bool, device=device)
    if is_causal:
        m &= diff >= 0
        if window is not None:
            m &= diff <= window
    elif window is not None:
        m &= diff.abs() <= window
    return m


def _with_padding(geom: torch.Tensor,
                  padding_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """geom: (L, L); padding_mask: (B, L) with 1 = valid -> (B|1, 1, L, L)."""
    geom = geom[None, None]
    if padding_mask is None:
        return geom
    return geom & padding_mask.bool()[:, None, None, :]   # mask keys only


def bidirectional_mask(seq_len: int,
                       padding_mask: Optional[torch.Tensor] = None,
                       window: Optional[int] = None, *,
                       device=None) -> torch.Tensor:
    """Bidirectional full or sliding-window mask: (B|1, 1, L, L) bool."""
    if padding_mask is not None:
        device = padding_mask.device
    return _with_padding(
        _geometry(seq_len, is_causal=False, window=window, device=device),
        padding_mask)


def causal_mask(seq_len: int, padding_mask: Optional[torch.Tensor] = None,
                window: Optional[int] = None, *, device=None) -> torch.Tensor:
    """Causal full or sliding-window mask: (B|1, 1, L, L) bool."""
    if padding_mask is not None:
        device = padding_mask.device
    return _with_padding(
        _geometry(seq_len, is_causal=True, window=window, device=device),
        padding_mask)


def cross_mask(q_len: int, kv_padding_mask: torch.Tensor) -> torch.Tensor:
    """Queries attend to all valid encoder keys: (B, Lk) -> (B, 1, Lq, Lk)."""
    pad = kv_padding_mask.bool()[:, None, None, :]
    return pad.expand(pad.shape[0], 1, q_len, pad.shape[-1])
