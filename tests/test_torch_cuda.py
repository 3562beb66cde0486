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
    (2, 300, 128), (1, 1000, 256), (3, 77, 64), (1, 5, 16), (1, 197, 32),
    # block edges: BL = 256 output samples at C = 128, 128 at C = 256; L
    # inside one halo (39) and L = 1
    (1, 255, 128), (1, 256, 128), (2, 257, 128), (1, 20, 128), (1, 1, 128),
    (1, 127, 256), (1, 128, 256), (2, 129, 256), (1, 30, 256), (1, 1, 256),
    (2, 1, 64), (1, 38, 32)])
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


@pytest.mark.parametrize("C", [64, 128, 256])
def test_snake_kernel_repacks_after_an_update(cuda_device, C):
    """The wrapper packs the weights once per stack; an in-place update of
    a parameter (what an optimizer step does) packs them anew."""
    units = _units(cuda_device, C, seed=3)
    g = torch.Generator(cuda_device).manual_seed(4)
    x = torch.randn((1, 300, C), generator=g, device=cuda_device).to(
        torch.bfloat16)
    first = sc.res_unit_stack(units, x)
    assert torch.equal(sc.res_unit_stack(units, x), first)
    with torch.no_grad():
        units[2].conv2.weight.mul_(-1.0)
    got = sc.res_unit_stack(units, x)
    ref = sc.res_unit_stack_plain([u.float() for u in units], x.float())
    assert not torch.equal(got, first)
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
    # K2's and K3's 64-row tiles with Lq != Lk at their edges, G = 1 and 2
    (1, 64, 129, 2, 2, None),
    (1, 129, 63, 4, 2, None),
    (2, 65, 128, 4, 2, 16),
    (1, 128, 65, 2, 2, None),
    (1, 200, 63, 4, 2, 64),         # rows past Lk + W: no valid key
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
    if window is not None and Lq > Lk + window:
        # query rows with no key in the band get exactly 0
        assert (got[0][:, Lk + window:] == 0).all()


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


@pytest.mark.parametrize("Hq,Hkv", [(16, 8), (4, 4)])
def test_flash_bwd_dq_is_deterministic(cuda_device, Hq, Hkv):
    """K2 owns each dQ tile in one block and sums in a fixed order: two
    runs give the same bits, with G = 2 and G = 1, full and banded."""
    q, k, v = _qkv(cuda_device, 2, 1500, 1500, Hq, Hkv, seed=10)
    g = torch.Generator(cuda_device).manual_seed(11)
    dout = torch.randn(q.shape, generator=g, device=cuda_device).to(
        torch.bfloat16)
    for window in (None, 128):
        out, lse = fa.flash_attention_with_lse(q, k, v, window=window)
        dq1 = fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout, window)[0]
        dq2 = fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout, window)[0]
        assert torch.equal(dq1, dq2)


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


# ------------------------------------------------------------------
# The 5 Hz planner and checkpoint loading on the card
# ------------------------------------------------------------------


def _planner_lm(device, dtype, seed=4, vocab_size=None):
    """A 2-layer LM at the planner's head geometry (32/8 heads of 128)
    over the SimpleTokenizer with 64 audio codes; the vocab is the
    tokenizer's unless `vocab_size` pads it (as a real planner's is)."""
    import dataclasses

    from acestep_torch.config import LMConfig
    from acestep_torch.llm.tokenizer import SimpleTokenizer
    from acestep_torch.models.lm import init_lm_params

    tok = SimpleTokenizer(num_audio_codes=64)
    cfg = dataclasses.replace(LMConfig.qwen3_4b(),
                              vocab_size=vocab_size or tok.vocab_size,
                              hidden_size=256, intermediate_size=512,
                              num_hidden_layers=2)
    model = init_lm_params(cfg, torch.Generator(device).manual_seed(seed),
                           dtype=dtype)
    return cfg, tok, model


def _forced_logits(engine, prompt, forced):
    logits, cache, lens, _ = engine._prefill_prompts([prompt], len(forced))
    row_lens = torch.as_tensor(lens, device=engine.device)
    step = engine.decode_step(cache, row_lens, 0, engine.vocab_use)
    out = [logits.clone()]
    for t in forced:
        logits = step(torch.tensor([t], device=engine.device), row_lens)
        row_lens = row_lens + 1
        out.append(logits.clone())
    return torch.cat(out).float().cpu()


def test_lm_teacher_forced_logits_card_vs_cpu(cuda_device):
    """Prefill + 32 teacher-forced decode steps (graph replays) in bf16 on
    the card against the same weights in fp32 on the CPU: the logits within
    5e-2 of the largest CPU logit (the head is taken in bf16, as in JAX)."""
    from acestep_torch.llm.generator import LMEngine
    from acestep_torch.models.lm import build_lm

    cfg, tok, card = _planner_lm(cuda_device, torch.bfloat16)
    cpu = build_lm(cfg, "cpu", torch.float32)
    cpu.load_state_dict(card.state_dict())
    forced = tok.encode("<think>\nbpm: 96\ncaption: slow soul ballad\n")[:32]
    prompt = "<|im_start|>user\n# Caption\nsoul\n<|im_end|>\n"
    got = _forced_logits(LMEngine(card, cfg, tok), prompt, forced)
    want = _forced_logits(LMEngine(cpu, cfg, tok, dtype=torch.float32),
                          prompt, forced)
    assert got.shape == want.shape == (len(forced) + 1, tok.vocab_size)
    assert float((got - want).abs().max() / want.abs().max()) < 5e-2


def test_graph_decode_equals_eager_greedy(cuda_device):
    """Greedy CoT (device FSM, CFG pair) and codes: the CUDA-graph decode
    step and the eager step give identical tokens."""
    from acestep_torch.llm.handler import LLMHandler

    cfg, tok, model = _planner_lm(cuda_device, torch.bfloat16)
    h = LLMHandler(dtype=torch.bfloat16)
    h.initialize(cfg=cfg, tokenizer=tok, params=model)
    h.engine.cross_prefix_enabled = False
    plans = []
    for graphs in (True, False):
        h.engine.cuda_graphs = graphs
        plans.append(h.plan("dark techno", "", target_duration=10, seed=0,
                            cfg_scale=2.0, metadata_temperature=0.0,
                            codes_temperature=0.0))
    assert h.engine.graph_captures > 0
    assert plans[0] == plans[1]
    assert plans[0]["audio_codes"].count("<|audio_code_") == 50


# ------------------------------------------------------------------
# The DiT decoder step as CUDA graphs (models/dit_graphs.py)
# ------------------------------------------------------------------


@pytest.fixture(scope="module")
def turbo_dit():
    """The turbo DiT at its published widths, seeded, bf16, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs replay only on the card")
    from acestep_torch.config import DiTConfig
    from acestep_torch.models.dit import init_dit_params

    dev = torch.device("cuda")
    cfg = DiTConfig.turbo()
    model = init_dit_params(cfg, torch.Generator(dev).manual_seed(20),
                            dtype=torch.bfloat16)
    yield cfg, model
    del model
    torch.cuda.empty_cache()


@pytest.mark.parametrize("rows,frames", [(4, 750), (1, 6000)])
def test_dit_graph_replay_equals_eager(turbo_dit, monkeypatch, rows, frames):
    """The turbo step at the REST cell's shape (4 fused 30 s songs) and the
    long cell's (one 240 s song): a capture, then replays, each equal bit
    for bit to the eager step on the same inputs, and still equal when
    the later steps have run; K1 launches 24 times a step, replayed or
    not; what the graphs hold after the steps (their arena, RoPE tables
    and the capturing stream's cuBLAS workspace) stays under 0.1 GiB."""
    from acestep_torch.models import dit_graphs
    from acestep_torch.models.dit import decoder_cross_kv, dit_decoder
    from acestep_torch.utils import trace

    cfg, model = turbo_dit
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(rows * 7 + frames)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    names = ("dit_graph_captures", "dit_graph_replays")
    with torch.no_grad():
        ctx = randn(rows, frames, 128)
        kv = decoder_cross_kv(model, cfg, randn(rows, 160, cfg.hidden_size))
        dit_graphs._graphs.pop(model.decoder, None)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        counts = [trace.counters[n] for n in names]
        results = []
        for i, t in enumerate((1.0, 0.75, 0.3)):
            xt = randn(rows, frames, 64)
            tv = torch.full((rows,), t, device=dev, dtype=torch.bfloat16)
            with monkeypatch.context() as eager:
                eager.setattr(dit_graphs, "engages", lambda *a: False)
                want = dit_decoder(model, cfg, xt, tv, tv, ctx,
                                   cross_kv_cache=kv)
            before = fa.launches
            got = dit_decoder(model, cfg, xt, tv, tv, ctx, cross_kv_cache=kv)
            assert fa.launches - before == cfg.num_hidden_layers
            err = (got.float() - want.float()).abs().max().item()
            assert torch.equal(got, want), (i, err)
            results.append((got, want))
        assert all(torch.equal(got, want) for got, want in results)
        del xt, tv, want, got, results
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - held
    assert [trace.counters[n] - c for n, c in zip(names, counts)] == [1, 2]
    assert held < 0.1 * 2 ** 30, held


def test_dit_graph_steps_on_two_streams_keep_their_order(turbo_dit):
    """Two replayed steps of one key on two streams, both held back on
    the card and the second let go while the first runs: the second
    waits for the first to end before it writes the shared buffers, so
    each result is the one its inputs give on a single stream."""
    from acestep_torch.models.dit import decoder_cross_kv, dit_decoder

    cfg, model = turbo_dit
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(31)
    rows, frames = 4, 1500      # ~50 ms a step on the card

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    with torch.no_grad():
        ctx = randn(rows, frames, 128)
        kv = decoder_cross_kv(model, cfg, randn(rows, 160, cfg.hidden_size))
        xs = [randn(rows, frames, 64) for _ in range(3)]
        tv = torch.full((rows,), 0.6, device=dev, dtype=torch.bfloat16)
        want = [dit_decoder(model, cfg, x, tv, tv, ctx, cross_kv_cache=kv)
                for x in xs]       # the first captures, the others replay
        a, b = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
        torch.cuda.synchronize()
        # each stream spins ~50 ms from when its step is enqueued: the
        # second is enqueued ~10 ms (the first's host time) after the
        # first, so it would start ~10 ms into the first's ~50 ms
        with torch.cuda.stream(a):
            torch.cuda._sleep(100_000_000)
            got_a = dit_decoder(model, cfg, xs[1], tv, tv, ctx,
                                cross_kv_cache=kv)
        with torch.cuda.stream(b):
            torch.cuda._sleep(100_000_000)
            got_b = dit_decoder(model, cfg, xs[2], tv, tv, ctx,
                                cross_kv_cache=kv)
        torch.cuda.synchronize()
    assert torch.equal(got_a, want[1]) and torch.equal(got_b, want[2])


@pytest.mark.parametrize("guided", [False, True])
def test_dit_graph_trajectories_equal_eager(cuda_device, monkeypatch,
                                            guided):
    """Whole trajectories at a narrow width (head_dim 128, the kernel's):
    turbo with a cover switch at 3 rows and T = 201, not a multiple of the
    patch; base under CFG (6 rows, APG between the steps) with both
    conditions switching sides. Twice as graphs, then eagerly: equal."""
    from acestep_torch.config import DiTConfig
    from acestep_torch.models import dit_graphs, sampler
    from acestep_torch.models.dit import init_dit_params

    cfg = DiTConfig.tiny(head_dim=128, fsq_dim=64,
                         model_version="base" if guided else "turbo")
    dev = cuda_device
    model = init_dit_params(cfg, torch.Generator(dev).manual_seed(4),
                            dtype=torch.bfloat16)
    rows, frames = 3, 201

    def cond(seed, lk):
        g = torch.Generator(dev).manual_seed(seed)
        enc = torch.randn((rows, lk, cfg.hidden_size), generator=g,
                          device=dev).to(torch.bfloat16)
        ctx = torch.randn((rows, frames, 128), generator=g,
                          device=dev).to(torch.bfloat16)
        return sampler.ConditionSet.build(model, cfg, enc, ctx)

    x = torch.randn((rows, frames, 64), generator=torch.Generator(
        dev).manual_seed(9), device=dev).to(torch.bfloat16)

    def render():
        with torch.no_grad():
            if not guided:
                return sampler.sample_turbo(
                    model, cfg, x_init=x,
                    schedule=sampler.build_turbo_schedule(3.0),
                    cond=cond(1, 40), cond_non_cover=cond(2, 30),
                    cover_steps=3)
            return sampler.sample_guided(
                model, cfg, x_init=x,
                schedule=sampler.build_continuous_schedule(8, 3.0),
                cond=cond(1, 40), null_cond=cond(3, 40),
                cond_non_cover=cond(2, 30), null_cond_non_cover=cond(4, 30),
                cover_steps=3, guidance_scale=5.0)

    got, again = render(), render()
    assert len(dit_graphs.graphs_of(model).steps) == 1
    monkeypatch.setattr(dit_graphs, "engages", lambda *a: False)
    want = render()
    assert torch.equal(got, want) and torch.equal(again, want)


def test_checkpoint_on_card_equals_cpu(cuda_device, tmp_path):
    """An upstream-named checkpoint (written from a seeded DiT / VAE) loads
    to the card in bf16 exactly as it loads to the CPU, cast."""
    import chip_smoke
    from acestep_torch.config import DiTConfig, VAEConfig
    from acestep_torch.pipeline.handler import AceStepHandler

    geom = dict(frame_bucket=20, min_frames=20, refer_frames=10)
    cfgs = (DiTConfig.tiny(fsq_dim=64), VAEConfig.tiny(
        decoder_input_channels=64))
    src = AceStepHandler(*cfgs, dtype=torch.float32, device="cpu", **geom)
    src.initialize_service(seed=0)
    dit, vae = str(tmp_path / "dit"), str(tmp_path / "vae")
    chip_smoke._write_checkpoint(dit, dict(
        chip_smoke._upstream_dit_name(k, t)
        for k, t in src.model.state_dict().items()), shards=2)
    chip_smoke._write_checkpoint(vae, dict(
        chip_smoke._upstream_vae_name(k, t)
        for k, t in src.vae.state_dict().items()), shards=1)
    loaded = {}
    for device, dtype in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
        h = AceStepHandler(*cfgs, dtype=dtype, device=device, **geom)
        h.initialize_service(checkpoint_dir=dit, vae_dir=vae)
        loaded[device] = h
    for mod in ("model", "vae"):
        card = getattr(loaded["cuda"], mod).state_dict()
        cpu = getattr(loaded["cpu"], mod).state_dict()
        assert set(card) == set(cpu)
        for k, t in cpu.items():
            assert torch.equal(card[k].cpu(), t.to(torch.bfloat16)), k


# ------------------------------------------------------------------
# Quantization and the LRC capture pass on the card
# ------------------------------------------------------------------


@pytest.mark.parametrize("rows", [2, 17, 1500])
def test_int8_product_on_card_equals_cpu(cuda_device, rows):
    """The w8a8 product, int8 x int8 -> int32 (`torch._int_mm`; fewer than
    17 rows padded with zero rows on the card), at the planner's decode
    rows and a 60 s song's 1500 patches: exactly the CPU's sums."""
    from acestep_torch.ops.quant import int8_mm

    g = torch.Generator().manual_seed(rows)
    a = torch.randint(-127, 128, (rows, 2560), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (1024, 2560), generator=g, dtype=torch.int8)
    got = int8_mm(a.to(cuda_device), w.to(cuda_device).t())
    assert got.dtype == torch.int32 and got.shape == (rows, 1024)
    assert torch.equal(got.cpu(), int8_mm(a, w.t()))


def test_int8_product_rejects_what_it_does_not_take(cuda_device):
    """In-features that are not a multiple of 8 raise; nothing falls back
    to a float product."""
    from acestep_torch.ops.quant import int8_mm

    a = torch.ones((32, 12), dtype=torch.int8, device=cuda_device)
    w = torch.ones((64, 12), dtype=torch.int8, device=cuda_device)
    with pytest.raises(RuntimeError):
        int8_mm(a, w.t())


def test_quantized_graph_decode_equals_eager(cuda_device):
    """A w8a8 planner (int8 trunk products, `head_q`, int8 KV cache): the
    CUDA-graph decode step and the eager step give identical greedy
    tokens. The vocab is padded to 256 rows, as a real planner's is, so
    the head windows' widths are multiples of 8 (`torch._int_mm`'s rule
    on the card)."""
    from acestep_torch.llm.handler import LLMHandler

    cfg, tok, model = _planner_lm(cuda_device, torch.bfloat16,
                                  vocab_size=256)
    h = LLMHandler(dtype=torch.bfloat16)
    h.initialize(cfg=cfg, tokenizer=tok, params=model, quantization="w8a8")
    assert h.engine.kv_quant and hasattr(h.engine.model, "head_q")
    h.engine.cross_prefix_enabled = False
    plans = []
    for graphs in (True, False):
        h.engine.cuda_graphs = graphs
        plans.append(h.plan("dark techno", "", target_duration=10, seed=0,
                            cfg_scale=2.0, metadata_temperature=0.0,
                            codes_temperature=0.0))
    assert h.engine.graph_captures > 0
    assert plans[0] == plans[1]
    assert plans[0]["audio_codes"].count("<|audio_code_") == 50


def test_attn_capture_card_vs_cpu(cuda_device):
    """The LRC capture pass of a 2-layer DiT at the kernels' head width:
    bf16 on the card (self-attention through K1) against fp32 on the CPU,
    same weights and inputs; probabilities within 5e-2 of the largest CPU
    probability (the card-vs-CPU references' limit)."""
    from acestep_torch.config import DiTConfig
    from acestep_torch.models.dit import build_dit, dit_decoder_attn_capture
    from acestep_torch.models.dit import init_dit_params

    cfg = DiTConfig.tiny(fsq_dim=64, head_dim=128)
    card = init_dit_params(cfg, torch.Generator(cuda_device).manual_seed(0),
                           dtype=torch.bfloat16)
    cpu = build_dit(cfg, "cpu", torch.float32)
    cpu.load_state_dict(card.state_dict())
    g = torch.Generator().manual_seed(1)
    B, T, Lk = 1, 250, 40
    xt = torch.randn((B, T, 64), generator=g)
    ctx = torch.randn((B, T, cfg.in_channels - 64), generator=g)
    enc = torch.randn((B, Lk, cfg.hidden_size), generator=g)
    tt = torch.full((B,), 0.125)
    capture = {0: [0, 1], 1: [2]}
    before = fa.launches
    got = dit_decoder_attn_capture(
        card, cfg, *(x.to(cuda_device, torch.bfloat16)
                     for x in (xt, tt, tt, ctx, enc)), capture)
    assert fa.launches - before == 2
    want = dit_decoder_attn_capture(cpu, cfg, xt, tt, tt, ctx, enc, capture)
    for layer, w in want.items():
        g_ = got[layer].cpu()
        assert g_.shape == w.shape == (B, len(capture[layer]), T // 2, Lk)
        assert float((g_ - w).abs().max() / w.abs().max()) < 5e-2


# ------------------------------------------------------------------
# serving on the card: a tiny DiT at the kernels' head width
# ------------------------------------------------------------------


def _tiny_service(device):
    from acestep_torch.config import DiTConfig, VAEConfig
    from acestep_torch.pipeline.handler import AceStepHandler

    h = AceStepHandler(DiTConfig.tiny(fsq_dim=64, head_dim=128),
                       VAEConfig.tiny(decoder_input_channels=64),
                       dtype=torch.bfloat16, frame_bucket=25, min_frames=25,
                       refer_frames=10, device=device)
    h.initialize_service(seed=0)
    return h


def _serve(state):
    import threading

    from acestep_torch.serving.server import create_server

    server = create_server(state, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, server.server_address[1]


def _call(port, method, route, body=None):
    import http.client
    import json

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, route, None if body is None else json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    return resp.status, raw


def _run_task(port, body, timeout=300.0):
    import json
    import time

    _, raw = _call(port, "POST", "/release_task", body)
    tid = json.loads(raw)["data"]["task_id"]
    deadline = time.time() + timeout
    while time.time() < deadline:
        _, raw = _call(port, "POST", "/query_result", {"task_id_list": [tid]})
        entry = json.loads(raw)["data"][0]
        if entry["status"]:
            return entry
        time.sleep(0.02)
    raise TimeoutError(tid)


def test_tiny_server_serves_a_render_on_card(cuda_device, tmp_path):
    """One REST text2music request on the card: K1 and K4 launch, the
    result is a flac that decodes, /v1/metrics reports the allocator."""
    import json

    from acestep_torch.serving.server import AppState
    from acestep_torch.utils.flac import decode_flac

    h = _tiny_service(cuda_device)
    state = AppState({"tiny": h}, None, output_dir=str(tmp_path / "out"),
                     persist_dir=str(tmp_path / "persist"))
    server, port = _serve(state)
    try:
        k1, k4 = fa.launches, sc.launches
        entry = _run_task(port, {"prompt": "x", "thinking": False,
                                 "audio_duration": 2, "seed": 3,
                                 "use_random_seed": False,
                                 "audio_format": "flac"})
        status, metrics = _call(port, "GET", "/v1/metrics")
    finally:
        state.shutdown()
        server.shutdown()
        server.server_close()
    assert entry["status"] == 1, entry
    path = json.loads(entry["result"])[0]["file"]
    with open(path, "rb") as f:
        pcm, sr = decode_flac(f.read())
    assert sr == 48000 and pcm.shape == (50 * 8, 2)
    assert fa.launches > k1 and sc.launches > k4
    assert status == 200 and b"acestep_hbm_bytes_in_use" in metrics


def test_metrics_polled_while_the_planner_captures(cuda_device, tmp_path):
    """A thinking request over REST whose planner captures its decode
    graphs on a worker thread while another thread polls /v1/metrics and
    /v1/stats: the request succeeds, the graphs were captured, every poll
    answered 200."""
    import threading

    from acestep_torch.llm.handler import LLMHandler
    from acestep_torch.serving.server import AppState

    cfg, tok, model = _planner_lm(cuda_device, torch.bfloat16)
    llm = LLMHandler(dtype=torch.bfloat16)
    llm.initialize(cfg=cfg, tokenizer=tok, params=model)
    h = _tiny_service(cuda_device)
    state = AppState({"tiny": h}, llm, output_dir=str(tmp_path / "out"),
                     persist_dir=str(tmp_path / "persist"))
    server, port = _serve(state)
    stop, polls = threading.Event(), []

    def poll():
        while not stop.is_set():
            for route in ("/v1/metrics", "/v1/stats"):
                polls.append(_call(port, "GET", route)[0])
            stop.wait(0.02)

    poller = threading.Thread(target=poll)
    try:
        poller.start()
        entry = _run_task(port, {"prompt": "dark techno", "thinking": True,
                                 "audio_duration": 10, "seed": 1,
                                 "use_random_seed": False})
    finally:
        stop.set()
        poller.join()
        state.shutdown()
        server.shutdown()
        server.server_close()
    assert entry["status"] == 1, entry
    assert llm.engine.graph_captures > 0
    assert len(polls) > 4 and set(polls) == {200}


def test_fused_group_launches_k1_as_one_render(cuda_device, tmp_path):
    """A fused group of 3 jobs launches K1 as often as one single render
    (once per decoder layer per step): launches do not grow with the
    batch."""
    from acestep_torch import inference

    h = _tiny_service(cuda_device)

    def job(i):
        return (inference.GenerationParams(caption=f"song {i}", duration=2.0,
                                           seed=i, thinking=False),
                inference.GenerationConfig(batch_size=1,
                                           output_dir=str(tmp_path)))

    before = fa.launches
    solo = inference.generate_music(h, None, *job(0))
    single = fa.launches - before
    before = fa.launches
    group = inference.generate_music_group(h, None, [job(i) for i in range(3)])
    fused = fa.launches - before
    assert solo.success and all(r.success for r in group)
    assert single == fused == h.cfg.num_hidden_layers * 8


# ------------------------------------------------------------------
# Full-parameter training, the estimate and the dataset build on the card
# ------------------------------------------------------------------


def _train_pair(device):
    """A 2-layer DiT (head_dim 128, the kernels' width) in bf16 on the
    card and the same weights in fp32 on the CPU, with one batch and its
    draws (200 frames: the banded layer's band is narrower)."""
    from acestep_torch.config import DiTConfig
    from acestep_torch.models.dit import build_dit, init_dit_params
    from acestep_torch.training.step import tiny_batch

    cfg = DiTConfig.tiny(head_dim=128, fsq_dim=64)
    gpu = init_dit_params(cfg, torch.Generator(device).manual_seed(0),
                          dtype=torch.bfloat16)
    cpu = build_dit(cfg, "cpu", torch.float32)
    cpu.load_state_dict(gpu.state_dict())
    g = torch.Generator().manual_seed(1)
    batch = tiny_batch(cfg, g, batch=2, frames=200)
    draws = dict(keep=torch.tensor([True, False]),
                 noise=torch.randn(batch["hidden_states"].shape, generator=g),
                 t=torch.tensor([0.7, 0.3]))
    return cfg, gpu, cpu, batch, draws


def _global_rel(got, want):
    num = sum(float((got[n] - w).norm() ** 2) for n, w in want.items())
    den = sum(float(w.norm() ** 2) for w in want.values())
    return (num / den) ** 0.5


def test_full_trainer_step_card_vs_cpu(cuda_device):
    """One FullTrainer step (lr 0 at the first update, so the gradients
    stay to be read) through K1 forward and recompute and K2/K3: every
    parameter's gradient, over all of them, within 5e-2 of the fp32 CPU
    step's (chip_smoke's TOL_TRAIN_GRAD); a second step keeps the weights
    finite."""
    from acestep_torch.training.trainer_full import (FullTrainer,
                                                     FullTrainingConfig)

    cfg, gpu, cpu, batch, draws = _train_pair(cuda_device)
    grads = {}
    for name, model in (("gpu", gpu), ("cpu", cpu)):
        t = FullTrainer(model, cfg, FullTrainingConfig(
            warmup_steps=1, max_steps=2, checkpoint_every=0, log_every=1))
        before = (fa.launches, fa.launches_bwd_dq, fa.launches_bwd_dkv)
        events = t.train(iter([batch, batch]), draws=iter([draws, draws]))
        loss = next(events)[1]
        grads[name] = (loss, {n: p.grad.float().cpu()
                              for n, p in model.named_parameters()})
        assert list(events)[-1][0] == 2
        ran = [a - b for a, b in zip((fa.launches, fa.launches_bwd_dq,
                                      fa.launches_bwd_dkv), before)]
        if name == "gpu":
            assert all(r >= 2 * cfg.num_hidden_layers for r in ran), ran
            assert all(torch.isfinite(p).all() for p in model.parameters())
    (gl, gg), (cl, cg) = grads["gpu"], grads["cpu"]
    assert abs(gl - cl) / abs(cl) < 1e-3
    assert _global_rel(gg, cg) < 5e-2


def test_estimate_card_vs_cpu(cuda_device):
    """The gradient-sensitivity estimate on the card (bf16, K1-K3)
    against fp32 on the CPU: every target's value within 5e-2."""
    from acestep_torch.training.presets import estimate_gradient_sensitivity

    cfg, gpu, cpu, batch, draws = _train_pair(cuda_device)
    before = fa.launches_bwd_dkv
    got = dict(estimate_gradient_sensitivity(gpu, cfg, [batch],
                                             draws=[draws]))
    assert fa.launches_bwd_dkv - before >= cfg.num_hidden_layers
    want = dict(estimate_gradient_sensitivity(cpu, cfg, [batch],
                                              draws=[draws]))
    assert set(got) == set(want) and len(got) == 11
    for name, v in want.items():
        assert abs(got[name] - v) < 5e-2 * v, (name, got[name], v)


def test_dataset_encode_launches_k4_three_times_a_song(cuda_device,
                                                       tmp_path):
    """The dataset build's encode stage on the full-width VAE: K4 runs the
    encoder's three C <= 256 stacks once per song; the tensors stage
    reuses the encoded latents and launches no K4."""
    import wave

    import numpy as np

    from acestep_torch.config import DiTConfig, VAEConfig
    from acestep_torch.pipeline.handler import AceStepHandler
    from acestep_torch.training.dataset_builder import DatasetBuildPipeline

    h = AceStepHandler(DiTConfig.tiny(fsq_dim=64, head_dim=128), VAEConfig(),
                       dtype=torch.bfloat16, device=cuda_device)
    h.initialize_service(seed=0)
    audio = tmp_path / "audio"
    audio.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        with wave.open(str(audio / f"s{i}.wav"), "wb") as f:
            f.setnchannels(2)
            f.setsampwidth(2)
            f.setframerate(48000)
            f.writeframes((0.2 * rng.standard_normal((96000, 2)) * 32767)
                          .astype("<i2").tobytes())
    pipe = DatasetBuildPipeline(str(audio), str(tmp_path / "ds"), h,
                                external_labelers=[])
    pipe.stage_scan()
    before = sc.launches
    assert pipe.stage_encode() == 2
    assert sc.launches - before == 2 * 3
    pipe.stage_label()
    pipe.stage_manifest()
    before = sc.launches
    assert pipe.stage_tensors() == {"tensors": 2}
    assert sc.launches == before
    lat = np.load(next((tmp_path / "ds" / "latents").glob("*.npy")))
    assert lat.shape == (50, 64) and np.isfinite(lat).all()


def test_tp2_gloo_world_on_one_card_matches_unsharded(cuda_device,
                                                      tmp_path):
    """A tp=2 mesh of two ranks sharing the card (gloo; NCCL refuses two
    ranks on one device) at the tiny size with 128-wide heads: each rank
    runs K1 at 2 query / 1 KV heads, and the render's latents are within
    2e-2 (relative L2, bf16 halves summed over the group) of the unsharded
    render of the same seed; the follower's K1 launches come back in the
    command replies."""
    import numpy as np

    from acestep_torch.parallel import make_mesh
    from torch_mesh_helpers import store_under

    h = _tiny_service(cuda_device)
    kw = dict(audio_duration=2, seeds=[3], normalize=False)
    want = h.generate_music("x", "la", **kw)
    with store_under(tmp_path):
        world = make_mesh(2, 1, devices=[cuda_device] * 2, backend="gloo")
    try:
        h.enable_mesh(dp=1, tp=2)
        before = h.mesh.launches()["K1"]
        got = h.generate_music("x", "la", **kw)
        ranks = [a - b for a, b in zip(h.mesh.launches()["K1"], before)]
    finally:
        h.release_mesh()
        world.close()
    rel = np.linalg.norm(got.pred_latents - want.pred_latents) / \
        np.linalg.norm(want.pred_latents)
    assert rel < 2e-2, rel
    need = h.cfg.num_hidden_layers * 8
    assert min(ranks) >= need, ranks


def test_default_mesh_counts_each_card_once(cuda_device, tmp_path):
    """`enable_mesh()` with its defaults, on a handler on the bare `cuda`
    device (the default of the server, the CLI and the facades): one NCCL
    rank on each visible card, so one card gives a 1-rank mesh whose render
    equals the unsharded render bit for bit."""
    import numpy as np

    from torch_mesh_helpers import store_under

    h = _tiny_service(cuda_device)
    kw = dict(audio_duration=2, seeds=[3], normalize=False)
    want = h.generate_music("x", "la", **kw)
    cards = torch.cuda.device_count()
    with store_under(tmp_path):
        h.enable_mesh()
    try:
        assert (h.mesh.dp, h.mesh.tp, h.mesh.backend) == (cards, 1, "nccl")
        assert h.mesh.devices == [torch.device("cuda", i)
                                  for i in range(cards)]
        got = h.generate_music("x", "la", **kw)
    finally:
        h.release_mesh()
    if cards == 1:
        np.testing.assert_array_equal(got.pred_latents, want.pred_latents)


def test_full_trainer_one_rank_nccl_mesh_equals_plain(cuda_device, tmp_path):
    """Two full-parameter updates over a 1-rank NCCL mesh (`make_mesh(1,
    1)` with its defaults) are the plain trainer's bit for bit: the same
    losses, gradients and weights; the rank's K1-K3 launches come back in
    the command replies."""
    from acestep_torch.parallel import make_mesh
    from acestep_torch.training.trainer_full import (FullTrainer,
                                                     FullTrainingConfig)
    from torch_mesh_helpers import store_under

    cfg, gpu, _cpu, batch, draws = _train_pair(cuda_device)
    init = {n: p.clone() for n, p in gpu.state_dict().items()}
    tc = FullTrainingConfig(warmup_steps=1, max_steps=2, checkpoint_every=0,
                            log_every=1)
    runs = {}
    with store_under(tmp_path):
        mesh = make_mesh(1, 1)
    try:
        assert (mesh.backend, mesh.devices) == (
            "nccl", [torch.device("cuda", 0)])
        for name in ("plain", "mesh"):
            gpu.load_state_dict(init)
            t = FullTrainer(gpu, cfg, tc, mesh=mesh if name == "mesh"
                            else None)
            before = mesh.launches()
            out = []
            for _step, loss, _ in t.train(iter([batch, batch]),
                                          draws=iter([draws, draws])):
                out.append((loss, {n: g.clone()
                                   for n, g in t.gradients().items()}))
            runs[name] = (out, {n: p.detach().clone()
                                for n, p in gpu.named_parameters()})
            if name == "mesh":
                ran = {k: v[0] - before[k][0]
                       for k, v in mesh.launches().items()}
                assert all(ran[k] >= 2 * cfg.num_hidden_layers
                           for k in ("K1", "K2", "K3")), ran
            t.close()
    finally:
        mesh.close()
    (plain, pw), (got, gw) = runs["plain"], runs["mesh"]
    for (pl, pg), (gl, gg) in zip(plain, got):
        assert pl == gl
        assert all(torch.equal(pg[n], gg[n]) for n in pg)
    assert all(torch.equal(pw[n], gw[n]) for n in pw)


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 1)])
def test_full_trainer_gloo_mesh_on_one_card_matches_plain(cuda_device,
                                                          tmp_path, dp, tp):
    """A full-parameter update over two ranks sharing the card (gloo) at
    tp=2 (K1-K3 at 2 query / 1 KV heads) and at dp=2 (one row a rank):
    the loss and the gradient the optimizer took within 2e-2 (relative
    L2 over all parameters, chip_smoke's TOL_FULL_MESH) of the plain
    update's; every rank launches K1-K3."""
    from acestep_torch.parallel import make_mesh
    from acestep_torch.training.trainer_full import (FullTrainer,
                                                     FullTrainingConfig)
    from torch_mesh_helpers import store_under

    cfg, gpu, _cpu, batch, draws = _train_pair(cuda_device)
    init = {n: p.clone() for n, p in gpu.state_dict().items()}
    runs = {}
    with store_under(tmp_path):
        world = make_mesh(2, 1, devices=[cuda_device] * 2, backend="gloo")
    try:
        for name, (d, t) in (("plain", (1, 1)), ("mesh", (dp, tp))):
            gpu.load_state_dict(init)
            trainer = FullTrainer(gpu, cfg, FullTrainingConfig(
                warmup_steps=1, max_steps=1, checkpoint_every=0,
                log_every=1, mesh_dp=d, mesh_tp=t))
            before = world.launches()
            loss = next(trainer.train(iter([batch]),
                                      draws=iter([draws])))[1]
            runs[name] = (loss, {n: g.float().cpu() for n, g in
                                 trainer.gradients().items()})
            ran = {k: [a - b for a, b in zip(v, before[k])]
                   for k, v in world.launches().items()}
            trainer.close()
    finally:
        world.close()
    (pl, pg), (ml, mg) = runs["plain"], runs["mesh"]
    assert abs(ml - pl) / abs(pl) < 2e-2
    assert _global_rel(mg, pg) < 2e-2
    need = {"K1": 2 * cfg.num_hidden_layers, "K2": cfg.num_hidden_layers,
            "K3": cfg.num_hidden_layers}
    assert all(min(ran[k]) >= n for k, n in need.items()), ran
