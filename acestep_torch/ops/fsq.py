"""Finite Scalar Quantization (FSQ), inference form.

Semantics of `vector_quantize_pytorch.ResidualFSQ` with num_quantizers=1,
levels (8,8,8,5,5,5) => 64 000 codes, as in `acestep_tpu/ops/fsq.py`.
Rounding is half-to-even on both sides (`torch.round`, `jnp.round`).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _consts(levels: Sequence[int], device):
    lv = np.asarray(levels, dtype=np.float32)
    half_l = (lv - 1) * (1 + 1e-3) / 2
    offset = np.where(lv % 2 == 0, 0.5, 0.0).astype(np.float32)
    shift = np.arctanh(offset / half_l)
    half_width = (np.asarray(levels, dtype=np.int64) // 2).astype(np.float32)
    basis = np.concatenate([[1], np.cumprod(levels[:-1])]).astype(np.int32)

    def t(a):
        return torch.as_tensor(a, device=device)
    return (t(lv), t(half_l.astype(np.float32)), t(offset),
            t(shift.astype(np.float32)), t(half_width), t(basis))


def fsq_quantize(z: torch.Tensor, levels: Sequence[int]):
    """z (..., len(levels)) -> (codes in [-1, 1] like z, int32 indices)."""
    _, half_l, offset, shift, half_width, basis = _consts(levels, z.device)
    bounded = torch.tanh(z.float() + shift) * half_l - offset
    rounded = torch.round(bounded)
    codes = rounded / half_width
    digits = (rounded + half_width).to(torch.int32)
    indices = (digits * basis).sum(dim=-1).to(torch.int32)
    return codes.to(z.dtype), indices


def fsq_indices_to_codes(indices: torch.Tensor,
                         levels: Sequence[int]) -> torch.Tensor:
    """indices (...,) int -> normalized codes (..., len(levels)) float32."""
    _, _, _, _, half_width, basis = _consts(levels, indices.device)
    lv_i = torch.as_tensor(np.asarray(levels, dtype=np.int32),
                           device=indices.device)
    digits = torch.div(indices[..., None].to(torch.int32), basis,
                       rounding_mode="floor") % lv_i
    return (digits.float() - half_width) / half_width


def fsq_codes_to_indices(codes: torch.Tensor,
                         levels: Sequence[int]) -> torch.Tensor:
    """Normalized codes (..., len(levels)) -> flat int32 indices (...,)."""
    _, _, _, _, half_width, basis = _consts(levels, codes.device)
    digits = torch.round(codes.float() * half_width + half_width).to(
        torch.int32)
    return (digits * basis).sum(dim=-1).to(torch.int32)
