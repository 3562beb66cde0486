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
- K2/K3 (flash backward): P and dS are rounded to bf16 before their
  products (the forward's rule) and dq/dk/dv are stored as bf16, over sums
  of up to L terms, so each is held to 2e-2 * max(1, max|ref|) and to
  ||err|| / ||ref|| < 1e-2 (chip_smoke's limit, which it holds above
  controls that leave delta or a query head out).
- Gradients through `flash_attention` (K1 then K2/K3) against autograd
  through the plain forward in fp32 from the same bf16 inputs: the same
  2e-2 rule, as the forward's bf16 `out` enters delta. Gradients through
  `res_unit_stack` (K4 forward, composed-chain backward) against autograd
  through the composed chain on the same bf16 inputs: the backward is that
  chain, so only the forward's kernel-vs-chain rounding differs, 2e-2.
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


def _norm_err(got, ref):
    return ((got.float() - ref).norm() / ref.norm()).item()


@pytest.mark.parametrize("B,Lq,Lk,Hq,Hkv,window,strided", [
    (1, 37, 37, 4, 2, None, False),       # one ragged tile
    (2, 130, 130, 16, 8, 16, False),      # GQA, narrow band, ragged
    (1, 200, 200, 8, 8, 128, True),       # strided head slices, band > tile
    (1, 1001, 1001, 16, 8, 128, False),   # main-path heads, ragged L
    (2, 257, 257, 16, 8, None, False),
    (1, 70, 130, 4, 2, None, False),      # Lq < Lk
    (1, 130, 70, 4, 2, None, False),      # Lq > Lk
    (1, 130, 70, 4, 2, 16, False),        # Lq > Lk + W: rows with no valid key
    # tile edges: one row, one short of / exactly / one past 64 and 128
    (1, 1, 1, 4, 2, None, False),
    (1, 63, 63, 2, 2, None, False),       # G = 1
    (2, 64, 64, 4, 2, 16, False),
    (1, 65, 65, 4, 4, None, False),       # G = 1
    (1, 127, 127, 4, 2, None, False),
    (2, 128, 128, 16, 8, 128, False),
    (1, 129, 129, 2, 1, None, False),
    (1, 300, 300, 16, 8, None, True),     # strided, G = 2
    (1, 200, 200, 6, 2, 64, False),       # G = 3: a block spans two row tiles
    # the main path's shapes
    (1, 750, 750, 16, 8, None, False),
    (1, 750, 750, 16, 8, 128, False),
    (2, 1500, 1500, 16, 8, None, False),
    (1, 1500, 1500, 16, 8, 128, False),
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


def test_flash_kernel_batches_are_independent(cuda_device):
    """Each batch of a B = 2 call equals that batch run alone, bit for bit
    (the kernel is deterministic), and the two batches differ."""
    q, k, v = _qkv(cuda_device, 2, 300, 300, 16, 8, seed=11)
    for window in (None, 128):
        out, lse = fa.flash_attention_with_lse(q, k, v, window=window)
        for i in range(2):
            one, one_lse = fa.flash_attention_with_lse(
                q[i:i + 1], k[i:i + 1], v[i:i + 1], window=window)
            assert torch.equal(out[i:i + 1], one)
            assert torch.equal(lse[i:i + 1], one_lse)
        assert not torch.equal(out[0], out[1])


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


@pytest.mark.parametrize("B,Lq,Lk,Hq,Hkv,window", [
    (1, 37, 37, 4, 2, None),        # one ragged tile
    (2, 130, 130, 16, 8, 16),       # GQA, narrow band, ragged
    (1, 200, 200, 8, 8, 128),       # band wider than a tile
    (1, 1001, 1001, 16, 8, 128),    # main-path heads, ragged L
    (2, 257, 257, 16, 8, None),
    (1, 70, 130, 4, 2, None),       # Lq < Lk
    (1, 130, 70, 4, 2, None),       # Lq > Lk
    (1, 130, 70, 4, 2, 16),         # Lq > Lk + W: rows with no valid key
    # tile edges: one row, one short of / exactly / one past 64 and 128
    (1, 1, 1, 4, 2, None),
    (1, 63, 63, 2, 2, None),        # G = 1
    (2, 64, 64, 4, 2, 16),
    (1, 65, 65, 4, 4, None),        # G = 1
    (1, 127, 127, 4, 2, None),
    (2, 128, 128, 16, 8, 128),
    (1, 129, 129, 2, 1, None),
    # the training shapes
    (1, 750, 750, 16, 8, None),
    (1, 1500, 1500, 16, 8, None),
    (1, 1500, 1500, 16, 8, 128),
])
def test_flash_bwd_kernels_match_plain(cuda_device, B, Lq, Lk, Hq, Hkv,
                                       window):
    q, k, v = _qkv(cuda_device, B, Lq, Lk, Hq, Hkv, seed=Lq * 7 + Lk)
    g = torch.Generator(cuda_device).manual_seed(Lq)
    dout = torch.randn(q.shape, generator=g, device=cuda_device).to(
        torch.bfloat16)
    out, lse = fa.flash_attention_with_lse(q, k, v, window=window)
    before = (fa.launches_bwd_dq, fa.launches_bwd_dkv)
    got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout, window)
    torch.cuda.synchronize()
    assert (fa.launches_bwd_dq, fa.launches_bwd_dkv) == (before[0] + 1,
                                                         before[1] + 1)
    ref = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                       out.float(), lse, dout.float(), window)
    for name, a, r, like in zip(("dq", "dk", "dv"), got, ref, (q, k, v)):
        assert a.dtype == torch.bfloat16 and a.shape == like.shape, name
        assert torch.isfinite(a).all(), name
        assert _scaled_err(a, r) < 2e-2, (name, _scaled_err(a, r))
        if r.norm() > 1e-3 * r.numel() ** 0.5:   # not ~0 (L = 1: dS = 0)
            assert _norm_err(a, r) < 1e-2, (name, _norm_err(a, r))


def test_flash_bwd_strided_inputs(cuda_device):
    """Head slices of one fused buffer through the backward (the wrapper
    makes them contiguous) give the contiguous inputs' gradients."""
    q, k, v = _qkv(cuda_device, 1, 200, 200, 16, 8, seed=5, strided=True)
    g = torch.Generator(cuda_device).manual_seed(6)
    dout = torch.randn(q.shape, generator=g, device=cuda_device).to(
        torch.bfloat16)
    out, lse = fa.flash_attention_with_lse(q, k, v, window=64)
    got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout, 64)
    want = fa.flash_attention_bwd_cuda(q.contiguous(), k.contiguous(),
                                       v.contiguous(), out, lse, dout, 64)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_flash_bwd_dkv_is_deterministic(cuda_device):
    """K3 sums the G query heads of a KV head inside one block, in a fixed
    order and without atomics: two runs give the same bits."""
    q, k, v = _qkv(cuda_device, 2, 1500, 1500, 16, 8, seed=8)
    g = torch.Generator(cuda_device).manual_seed(9)
    dout = torch.randn(q.shape, generator=g, device=cuda_device).to(
        torch.bfloat16)
    for window in (None, 128):
        out, lse = fa.flash_attention_with_lse(q, k, v, window=window)
        _, dk1, dv1 = fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout,
                                                  window)
        _, dk2, dv2 = fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout,
                                                  window)
        assert torch.equal(dk1, dk2) and torch.equal(dv1, dv2)


def test_flash_attention_gradients_on_card(cuda_device):
    """requires_grad inputs on the card get gradients through K1 + K2/K3."""
    q, k, v = _qkv(cuda_device, 1, 300, 300, 16, 8, seed=3)
    g = torch.Generator(cuda_device).manual_seed(4)
    w = torch.randn(q.shape, generator=g, device=cuda_device)
    for window in (None, 128):
        qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
        before = (fa.launches, fa.launches_bwd_dq, fa.launches_bwd_dkv)
        (fa.flash_attention(qg, kg, vg, window=window).float() * w).sum() \
            .backward()
        torch.cuda.synchronize()
        assert (fa.launches, fa.launches_bwd_dq, fa.launches_bwd_dkv) == \
            tuple(n + 1 for n in before)
        qr, kr, vr = (x.float().requires_grad_() for x in (q, k, v))
        (fa.flash_attention_plain(qr, kr, vr, window)[0] * w).sum().backward()
        for a, r in ((qg, qr), (kg, kr), (vg, vr)):
            assert a.grad is not None and a.grad.dtype == torch.bfloat16
            assert _scaled_err(a.grad, r.grad) < 2e-2


def test_res_unit_stack_gradients_on_card(cuda_device):
    """requires_grad inputs and parameters on the card get gradients: the
    kernel runs the forward, the composed chain the backward."""
    units = _units(cuda_device, 128, seed=9)
    g = torch.Generator(cuda_device).manual_seed(5)
    x = torch.randn((2, 300, 128), generator=g, device=cuda_device).to(
        torch.bfloat16)
    w = torch.randn(x.shape, generator=g, device=cuda_device)
    for u in units:
        u.requires_grad_(True)
    xg = x.clone().requires_grad_()
    before = sc.launches
    (sc.res_unit_stack(units, xg).float() * w).sum().backward()
    torch.cuda.synchronize()
    assert sc.launches == before + 1
    got = [xg.grad] + [p.grad.clone() for u in units for p in u.parameters()]
    for u in units:
        u.zero_grad(set_to_none=True)
    xr = x.clone().requires_grad_()
    (sc.res_unit_stack_plain(units, xr).float() * w).sum().backward()
    ref = [xr.grad] + [p.grad for u in units for p in u.parameters()]
    for a, r in zip(got, ref):
        assert a is not None and _scaled_err(a, r.float()) < 2e-2
