"""Fused Snake+conv residual stack of the Oobleck VAE.

Three residual units with dilations 1/3/9, each
`snake -> conv1d(k=7, dilated) -> snake -> conv1d(k=1) -> +x`, on (B, L, C).
`res_unit_stack` launches the hand-written Hopper kernel
(`csrc/snake_conv.cu`, which replaces `acestep_tpu/ops/snake_conv.py::_kernel`)
for CUDA tensors and runs `res_unit_stack_plain`, the composed chain, for
CPU tensors. A CUDA tensor the kernel does not take raises.
"""

from __future__ import annotations

from typing import Sequence

import torch

DILATIONS = (1, 3, 9)            # fixed by the architecture (res1/res2/res3)
HALO = 3 * sum(DILATIONS)        # receptive halo of the chained stack = 39
KERNEL_CHANNELS = (16, 32, 64, 128, 256)   # C the kernel is compiled for

launches = 0                     # kernel launches since the last reset

# cos(2*pi*r) on r in [-0.5, 0.5] as a degree-6 polynomial in z = r^2
# (max abs error 1.2e-6), the coefficients of acestep_tpu/ops/snake_conv.py
_COS2PI = (9.9999880376e-01, -1.9738972511e+01, 6.4931763898e+01,
           -8.5364105726e+01, 5.9704888277e+01, -2.4793177246e+01,
           5.3783531880e+00)


def _sin2(t: torch.Tensor) -> torch.Tensor:
    """sin(t)^2 = 0.5 - 0.5*cos(2t) on fp32 t, cos by a range-reduced
    polynomial with the Cody-Waite two-constant reduction (pi = 3.140625 +
    9.6765358979e-4): absolute error < 2e-6 out to |t| ~ 1e4."""
    inv_pi = torch.tensor(1.0 / torch.pi, dtype=torch.float32)
    n = torch.round(t * inv_pi)
    r_t = (t - n * 3.140625) - n * 9.6765358979e-4
    r = r_t * inv_pi
    z = r * r
    c = torch.full_like(z, _COS2PI[6])
    for k in (5, 4, 3, 2, 1, 0):
        c = c * z + _COS2PI[k]
    return 0.5 - 0.5 * c


def res_unit_stack_plain(units: Sequence, x: torch.Tensor) -> torch.Tensor:
    """The composed chain: models/vae._res_unit three times."""
    from acestep_torch.models.vae import _res_unit

    for u, d in zip(units, DILATIONS):
        x = _res_unit(u, x, d)
    return x


def pack_params(units: Sequence, device):
    """The three units' parameters in the kernel's layout: conv weights
    bf16, transposed to (out, in) per tap; biases and the snake tables
    exp(alpha), 1/(exp(beta) + 1e-9) in fp32."""
    def f32(t):
        return t.detach().to(device=device, dtype=torch.float32)

    w7t = torch.stack([u.conv1.weight.detach().permute(2, 0, 1)
                       for u in units]).to(device, torch.bfloat16)  # (3,7,C,C)
    wpt = torch.stack([u.conv2.weight.detach()[:, :, 0]
                       for u in units]).to(device, torch.bfloat16)  # (3,C,C)
    b7 = torch.stack([f32(u.conv1.bias) for u in units])
    bp = torch.stack([f32(u.conv2.bias) for u in units])
    ea = torch.stack([torch.stack([f32(u.snake1.alpha).exp(),
                                   f32(u.snake2.alpha).exp()])
                      for u in units])                                # (3,2,C)
    ieb = torch.stack([torch.stack([1.0 / (f32(u.snake1.beta).exp() + 1e-9),
                                    1.0 / (f32(u.snake2.beta).exp() + 1e-9)])
                       for u in units])
    return tuple(t.contiguous() for t in (w7t, wpt, b7, bp, ea, ieb))


def res_unit_stack_cuda(units: Sequence, x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on `torch.cuda.current_stream()`."""
    global launches
    from acestep_torch.ops import _build

    if len(units) != 3:
        raise ValueError("the stack is fixed at 3 units (res1/res2/res3)")
    if x.device.type != "cuda":
        raise ValueError(f"res_unit_stack_cuda: x must be on a CUDA device, "
                         f"got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"res_unit_stack_cuda: x must be bfloat16, got "
                        f"{x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"res_unit_stack_cuda: x must be a contiguous "
                         f"(B, L, C) tensor, got shape {tuple(x.shape)} "
                         f"strides {x.stride()}")
    B, L, C = x.shape
    if C not in KERNEL_CHANNELS:
        raise ValueError(f"res_unit_stack_cuda: C={C} not in "
                         f"{KERNEL_CHANNELS}")
    params = pack_params(units, x.device)
    for p in params:
        if p.shape[-1] != C:
            raise ValueError(f"res_unit_stack_cuda: parameters of width "
                             f"{p.shape[-1]} for C={C}")
    lib = _build.library()
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    launches += 1
    err = lib.acestep_snake_conv(x.data_ptr(), out.data_ptr(),
                                 *[p.data_ptr() for p in params],
                                 B, L, C, stream)
    _build.check(err, "acestep_snake_conv")
    return out


def res_unit_stack(units: Sequence, x: torch.Tensor) -> torch.Tensor:
    """Fused 3-unit stack on (B, L, C): the kernel for CUDA tensors, the
    composed chain for CPU tensors."""
    if x.device.type == "cpu":
        return res_unit_stack_plain(units, x)
    return res_unit_stack_cuda(units, x)
