"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`; without a GPU every test skips (the `cuda_device` fixture
decides, at run time). On a machine with one:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

This file imports no JAX, so it runs where only PyTorch is installed.

Tolerances. Both kernels take bf16 operands and accumulate in fp32; the
reference is the plain version computed in fp32 from the same bf16 inputs.
- K1 (flash attention): P is rounded to bf16 before the P.V product and
  `out` is stored as bf16 (~4e-3 relative), so out is held to
  2e-2 * max(1, max|ref|); lse is pure fp32 from the same logits, held to
  2e-3.
- K4 (snake + conv stack): every unit rounds its two snake outputs to bf16
  before the products (~4e-3 relative per operand, over 7*C-term sums) and
  the output is stored as bf16, so the stack is held to
  2e-2 * max(1, max|ref|).
"""

import pytest
import torch

from acestep_torch.ops import flash_attention as fa
from acestep_torch.ops import snake_conv as sc

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(device, B, Lq, Lk, Hq, Hkv, seed, strided=False):
    g = torch.Generator(device).manual_seed(seed)
    D = fa.HEAD_DIM
    if strided:
        # q/k/v as head slices of one fused projection buffer (Lq == Lk)
        buf = torch.randn((B, Lq, Hq + 2 * Hkv, D), generator=g, device=device)
        buf = buf.to(torch.bfloat16)
        return buf[:, :, :Hq], buf[:, :, Hq:Hq + Hkv], buf[:, :, Hq + Hkv:]
    return tuple(torch.randn((B, L, h, D), generator=g, device=device)
                 .to(torch.bfloat16)
                 for L, h in ((Lq, Hq), (Lk, Hkv), (Lk, Hkv)))


def _scaled_err(got, ref):
    return ((got.float() - ref).abs().max() / max(1.0, ref.abs().max())).item()


@pytest.mark.parametrize("B,Lq,Lk,Hq,Hkv,window,strided", [
    (1, 37, 37, 4, 2, None, False),       # one ragged tile
    (2, 130, 130, 16, 8, 16, False),      # GQA, narrow band, ragged
    (1, 200, 200, 8, 8, 128, True),       # strided head slices, band > tile
    (1, 1001, 1001, 16, 8, 128, False),   # main-path heads, ragged L
    (2, 257, 257, 16, 8, None, False),
    (1, 70, 130, 4, 2, None, False),      # Lq != Lk
])
def test_flash_kernel_matches_plain(cuda_device, B, Lq, Lk, Hq, Hkv, window,
                                    strided):
    q, k, v = _qkv(cuda_device, B, Lq, Lk, Hq, Hkv, seed=Lq + Lk,
                   strided=strided)
    before = fa.launches
    out, lse = fa.flash_attention_with_lse(q, k, v, window=window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ref, ref_lse = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                            window)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert _scaled_err(out, ref) < 2e-2
    assert (lse - ref_lse).abs().max().item() < 2e-3


def test_flash_kernel_rejects_what_it_does_not_take(cuda_device):
    q, k, v = _qkv(cuda_device, 1, 16, 16, 2, 2, seed=0)
    with pytest.raises(TypeError):
        fa.flash_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError):
        fa.flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError):
        fa.flash_attention(q[..., :64], k[..., :64], v[..., :64])


def _units(device, C, seed, std=0.05):
    from acestep_torch.models.vae import ResUnit

    g = torch.Generator(device).manual_seed(seed)
    units = []
    for _ in range(3):
        u = ResUnit(C, device=device, dtype=torch.float32)
        with torch.no_grad():
            for p in u.parameters():
                p.normal_(0.0, std, generator=g)
            for sn in (u.snake1, u.snake2):
                sn.alpha.normal_(0.0, 0.3, generator=g)
                sn.beta.normal_(0.0, 0.3, generator=g)
        units.append(u.to(torch.bfloat16))
    return units


@pytest.mark.parametrize("B,L,C", [
    (2, 300, 128), (1, 1000, 256), (3, 77, 64), (1, 5, 16), (1, 197, 32)])
def test_snake_kernel_matches_plain(cuda_device, B, L, C):
    units = _units(cuda_device, C, seed=C + L)
    g = torch.Generator(cuda_device).manual_seed(L)
    x = torch.randn((B, L, C), generator=g, device=cuda_device).to(
        torch.bfloat16)
    before = sc.launches
    got = sc.res_unit_stack(units, x)
    torch.cuda.synchronize()
    assert sc.launches == before + 1
    ref = sc.res_unit_stack_plain([u.float() for u in units], x.float())
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert _scaled_err(got, ref) < 2e-2


def test_snake_kernel_rejects_what_it_does_not_take(cuda_device):
    units = _units(cuda_device, 128, seed=1)
    x = torch.zeros((1, 64, 128), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        sc.res_unit_stack(units, x.float())
    with pytest.raises(ValueError):
        sc.res_unit_stack_cuda(units, x.cpu())
    with pytest.raises(ValueError):
        sc.res_unit_stack(units, x.transpose(1, 2).contiguous()[:, :, :64])
