"""Gradients of the port's kernels' plain versions and of FSQ against the
JAX package, float32 on the CPU.

- The flash-attention backward (`flash_attention_bwd_plain`, the CPU
  counterpart of the dQ and dK/dV kernels) against `jax.grad` of the
  Pallas flash attention in interpret mode (its custom_vjp runs the two
  Pallas backward kernels). Tolerance 2e-4 absolute, the JAX backward
  tests' own: float32 on both sides, summation order differs.
- `FlashAttention` (the autograd Function) on CPU tensors against autograd
  through `flash_attention_plain`: the same dense math, 1e-5.
- `res_unit_stack`'s gradient (the `ResUnitStack` Function, which
  recomputes through the composed chain) against `jax.grad` of the Pallas
  stack in interpret mode (its custom_vjp recomputes through
  `_composed_stack`): 1e-4 scaled by max(1, max|grad|), float32 over three
  units of k=7 convs.
- FSQ's straight-through estimator: the gradient is the tanh bound's,
  equal to JAX's to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acestep_tpu.models import dit as jdit
from acestep_tpu.models import vae as jvae
from acestep_tpu.ops import flash_attention as jfa
from acestep_tpu.ops import fsq as jfsq
from acestep_tpu.ops import snake_conv as jsc
from acestep_torch.models import dit as tdit
from acestep_torch.models.vae import ResUnit
from acestep_torch.ops import flash_attention as tfa
from acestep_torch.ops import fsq as tfsq
from acestep_torch.ops import snake_conv as tsc
from acestep_torch.utils.weights import dit_from_jax, vae_from_jax
from torch_parity import (assert_close, highest, np_tree, port_cfg, randn,
                          randomize_snakes, t, tiny_dit_cfg)

BLOCK = 16
FLASH_CASES = [
    (1, 40, 40, 4, 2, 8),        # GQA, ragged L (pads to 48), band edges
    (2, 40, 40, 4, 4, None),     # full, no grouping
    (1, 33, 33, 4, 1, 15),       # band just under the block
    (1, 24, 40, 2, 1, None),     # Lq != Lk
]


def _flash_inputs(B, Lq, Lk, Hq, Hkv, D=16):
    return (randn(0, B, Lq, Hq, D), randn(1, B, Lk, Hkv, D),
            randn(2, B, Lk, Hkv, D), randn(3, B, Lq, Hq, D))


@pytest.mark.parametrize("B,Lq,Lk,Hq,Hkv,window", FLASH_CASES)
def test_flash_bwd_plain_matches_pallas_backward(B, Lq, Lk, Hq, Hkv, window):
    q, k, v, dout = _flash_inputs(B, Lq, Lk, Hq, Hkv)

    def loss(q, k, v):
        out = jfa.flash_attention(q, k, v, window=window, block_q=BLOCK,
                                  block_k=BLOCK, interpret=True)
        return jnp.sum(out * dout)

    with highest():
        want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    out, lse = tfa.flash_attention_plain(t(q), t(k), t(v), window)
    got = tfa.flash_attention_bwd_plain(t(q), t(k), t(v), out, lse, t(dout),
                                        window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert_close(g, w, atol=2e-4, what=name)


@pytest.mark.parametrize("B,Lq,Lk,Hq,Hkv,window", FLASH_CASES)
def test_flash_function_matches_autograd_of_plain(B, Lq, Lk, Hq, Hkv, window):
    q, k, v, dout = _flash_inputs(B, Lq, Lk, Hq, Hkv)
    fn = [t(x).requires_grad_() for x in (q, k, v)]
    ref = [t(x).requires_grad_() for x in (q, k, v)]
    out = tfa.FlashAttention.apply(*fn, window)
    (out * t(dout)).sum().backward()
    out_ref = tfa.flash_attention_plain(*ref, window)[0]
    (out_ref * t(dout)).sum().backward()
    assert_close(out, out_ref.detach(), atol=1e-6, what="out")
    for a, b in zip(fn, ref):
        assert_close(a.grad, b.grad, atol=1e-5)


def test_flash_attention_is_differentiable_only_when_asked():
    q, k, v, _ = _flash_inputs(1, 8, 8, 2, 1)
    out = tfa.flash_attention(t(q).requires_grad_(), t(k), t(v))
    assert out.grad_fn is not None
    with torch.no_grad():
        out = tfa.flash_attention(t(q).requires_grad_(), t(k), t(v))
    assert out.grad_fn is None


@pytest.mark.parametrize("B,L,C", [(2, 100, 16), (1, 53, 32)])
def test_res_stack_gradient_matches_pallas_stack(B, L, C):
    keys = jax.random.split(jax.random.PRNGKey(L), 3)
    units = randomize_snakes(np_tree([
        jvae._init_res_unit(keys[i], C, d)
        for i, d in enumerate(jsc.DILATIONS)]), L)
    x, w = randn(3, B, L, C), randn(4, B, L, C)
    tunits = [ResUnit(C) for _ in range(3)]
    for u, ju in zip(tunits, units):
        u.load_state_dict(vae_from_jax(ju))
    xg = t(x).requires_grad_()
    (tsc.res_unit_stack(tunits, xg) * t(w)).sum().backward()

    def loss(units, x):
        return jnp.sum(jsc.res_unit_stack(units, x, block=64,
                                          interpret=True) * w)

    with highest():
        gu, gx = jax.grad(loss, argnums=(0, 1))(
            jax.tree.map(jnp.asarray, units), jnp.asarray(x))
    scale = max(1.0, float(np.abs(np.asarray(gx)).max()))
    assert_close(xg.grad, gx, atol=1e-4 * scale, what="dx")
    for u, ju in zip(tunits, gu):
        want = vae_from_jax(np_tree(ju))
        for name, p in u.named_parameters():
            s = max(1.0, float(want[name].abs().max()))
            assert_close(p.grad, want[name], atol=1e-4 * s, what=name)


def test_fsq_straight_through_gradient_matches_jax():
    levels = (8, 8, 8, 5, 5, 5)
    z, w = randn(0, 2, 7, 6, scale=2.0), randn(1, 2, 7, 6)

    def loss(z):
        codes, _ = jfsq.fsq_quantize(z, levels)
        return jnp.sum(codes * w)

    want = jax.grad(loss)(jnp.asarray(z))
    zt = t(z).requires_grad_()
    codes, idx = tfsq.fsq_quantize(zt, levels)
    (codes * t(w)).sum().backward()
    assert np.abs(np.asarray(want)).max() > 0
    assert_close(zt.grad, want, atol=1e-6, what="STE gradient")
    jcodes, jidx = jfsq.fsq_quantize(jnp.asarray(z), levels)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert_close(codes, jcodes, atol=0.0, what="codes")
    codes, _ = tfsq.fsq_quantize(zt, levels, ste=False)
    (grad,) = torch.autograd.grad((codes * t(w)).sum(), zt)
    assert (grad == 0).all()


def test_audio_codes_to_quantized_bf16_matches_jax():
    """bf16 weights: both sides multiply float32 codes by the weights cast
    to float32 (the port used to round the codes to bf16 first)."""
    cfg = tiny_dit_cfg()
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                           jdit.init_dit_params(jax.random.PRNGKey(1), cfg))
    tmodel = dit_from_jax(np_tree(jparams),
                          tdit.build_dit(port_cfg(cfg), "cpu", torch.bfloat16))
    codes = np.random.default_rng(0).integers(0, 64000, (2, 6)).astype(
        np.int32)
    with highest():
        want = jdit.audio_codes_to_quantized(jparams, cfg, jnp.asarray(codes))
    got = tdit.audio_codes_to_quantized(tmodel, port_cfg(cfg), t(codes))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert_close(got, want, atol=1e-6)
