"""1D convolutions on NLC tensors (batch, length, channels).

The public layout is the JAX package's NLC; the weights are PyTorch's:
`nn.Conv1d` (out, in, k) and `nn.ConvTranspose1d` (in, out, k). Each call
views the input as NCL for `torch.nn.functional` and views the result back.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from acestep_torch.ops.quant import conv_weight


def conv1d(p: nn.Conv1d, x: torch.Tensor, *, stride: int = 1,
           padding: int = 0, dilation: int = 1) -> torch.Tensor:
    """x: (B, L, Cin) -> (B, L', Cout). `padding` is symmetric."""
    y = F.conv1d(x.transpose(1, 2), conv_weight(p, x.dtype), None,
                 stride=stride, padding=padding, dilation=dilation)
    y = y.transpose(1, 2)
    if p.bias is not None:
        y = y + p.bias.to(x.dtype)
    return y


def conv1d_transpose(p: nn.ConvTranspose1d, x: torch.Tensor, *,
                     stride: int = 1, padding: int = 0,
                     output_padding: int = 0) -> torch.Tensor:
    """ConvTranspose1d: out_len = (L-1)*stride - 2*padding + k
    + output_padding."""
    y = F.conv_transpose1d(x.transpose(1, 2), conv_weight(p, x.dtype), None,
                           stride=stride, padding=padding,
                           output_padding=output_padding)
    y = y.transpose(1, 2)
    if p.bias is not None:
        y = y + p.bias.to(x.dtype)
    return y
