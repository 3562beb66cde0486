"""The plain versions of the port's two kernels against the JAX package's
Pallas kernels (run in interpret mode, as the JAX package's own tests run
them on the CPU) and dense references, float32 on the CPU.

On the CPU, `flash_attention` and `res_unit_stack` run these plain
versions; on the card the same functions launch the CUDA kernels, which
tests/test_torch_cuda.py holds against these plain versions.

Tolerance 2e-5 absolute, the JAX kernel tests' own: float32 on both sides,
summation order differs (blockwise online softmax vs dense softmax).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from acestep_tpu.models import vae as jvae
from acestep_tpu.ops import flash_attention as jfa
from acestep_tpu.ops import snake_conv as jsc
from acestep_torch.ops import flash_attention as tfa
from acestep_torch.ops import snake_conv as tsc
from acestep_torch.utils.weights import vae_from_jax
from torch_parity import (assert_close, highest, np_tree, randn,
                          randomize_snakes, t)

ATOL = 2e-5
BLOCK = 16


def _jax_lse(lse, B, Hq, Hkv, Lq):
    """The Pallas kernel's per-block (rows, 1) lse layout -> (B, Hq, Lq)."""
    G = Hq // Hkv
    n_q = lse.shape[2]
    lse = np.asarray(lse).reshape(B, Hkv, n_q, G, BLOCK)
    return lse.transpose(0, 1, 3, 2, 4).reshape(B, Hq, n_q * BLOCK)[:, :, :Lq]


@pytest.mark.parametrize("B,Lq,Lk,Hq,Hkv,window", [
    (1, 40, 40, 4, 2, 8),        # GQA, ragged L (pads to 48), band edges
    (2, 40, 40, 4, 4, None),     # full, no grouping
    (1, 33, 33, 4, 1, 15),       # band just under the block
    (1, 24, 40, 2, 1, None),     # Lq != Lk
])
def test_flash_plain_matches_pallas_kernel(B, Lq, Lk, Hq, Hkv, window):
    D = 16
    q, k, v = randn(0, B, Lq, Hq, D), randn(1, B, Lk, Hkv, D), randn(2, B, Lk, Hkv, D)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    with highest():
        want = jfa.flash_attention(jq, jk, jv, window=window, block_q=BLOCK,
                                   block_k=BLOCK, interpret=True)
        _, jlse = jfa._flash_forward(jq, jk, jv, window, BLOCK, BLOCK, True)
        dense = jfa.flash_attention_reference(jq, jk, jv, window=window)
    out, lse = tfa.flash_attention_with_lse(t(q), t(k), t(v), window=window)
    assert_close(out, want, atol=ATOL, what="out vs Pallas kernel")
    assert_close(out, dense, atol=ATOL, what="out vs dense reference")
    assert_close(lse, _jax_lse(jlse, B, Hq, Hkv, Lq), atol=ATOL, what="lse")


def test_flash_plain_row_without_keys_is_zero():
    """A query row whose band holds no key (Lq > Lk + W) gives out = 0 and
    lse = NEG_INF, the kernel's rule."""
    q, k, v = randn(0, 1, 12, 2, 8), randn(1, 1, 4, 2, 8), randn(2, 1, 4, 2, 8)
    out, lse = tfa.flash_attention_plain(t(q), t(k), t(v), window=2)
    assert (out[:, 6:] == 0).all() and (lse[:, :, 6:] == tfa.NEG_INF).all()
    assert (out[:, :6].abs().sum(-1) > 0).all()


def _units(C, seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), 3)
    units = [jvae._init_res_unit(keys[i], C, d)
             for i, d in enumerate(jsc.DILATIONS)]
    return randomize_snakes(np_tree(units), seed)


@pytest.mark.parametrize("B,L,C", [(2, 100, 16), (1, 53, 32)])
def test_res_stack_plain_matches_pallas_kernel(B, L, C):
    units = _units(C, seed=L)
    x = randn(3, B, L, C)
    from acestep_torch.models.vae import ResUnit

    tunits = [ResUnit(C) for _ in range(3)]
    for u, ju in zip(tunits, units):
        u.load_state_dict(vae_from_jax(ju))
    jx = jnp.asarray(x)
    with highest():
        want = jsc.res_unit_stack(units, jx, block=64, interpret=True)
        composed = jsc._composed_stack(units, jx)
    got = tsc.res_unit_stack(tunits, t(x))
    assert_close(got, want, atol=ATOL, what="vs Pallas kernel")
    assert_close(got, composed, atol=ATOL, what="vs composed chain")


def test_sin2_polynomial_matches_jax():
    """`_sin2` is the JAX package's polynomial, not torch.sin: identical
    float32 arithmetic up to fused multiply-adds (a few ulp)."""
    x = np.linspace(-2000.0, 2000.0, 40001, dtype=np.float32)
    got = tsc._sin2(t(x))
    assert_close(got, jsc._sin2(jnp.asarray(x)), atol=1e-6)
    assert np.abs(got.double().numpy() - np.sin(x.astype(np.float64)) ** 2).max() < 2e-6
