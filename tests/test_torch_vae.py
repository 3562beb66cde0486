"""The port's Oobleck VAE and tiled decode/encode against the JAX package,
weights carried across by acestep_torch/utils/weights.py (snake alpha and
beta randomised so the snake terms matter), seeded numpy inputs, float32 on
the CPU (VAEConfig.tiny with 64 latent channels).

Tolerance 1e-4 absolute on O(1) audio: float32 both sides with
full-precision convs; summation order differs per conv, over ~25 convs.
"""

import jax
import jax.numpy as jnp
import pytest

from acestep_tpu.models import vae as jvae
from acestep_tpu.models import vae_tiled as jtiled
from acestep_torch.models import vae as tvae
from acestep_torch.models import vae_tiled as ttiled
from acestep_torch.utils.weights import vae_from_jax
from torch_parity import (assert_close, highest, np_tree, port_cfg, randn,
                          randomize_snakes, t, tiny_vae_cfg)

ATOL = 1e-4


@pytest.fixture(scope="module")
def vaes():
    cfg = tiny_vae_cfg()
    jparams = randomize_snakes(
        np_tree(jvae.init_vae_params(jax.random.PRNGKey(1), cfg)), seed=3)
    tcfg = port_cfg(cfg)
    tmodel = vae_from_jax(jparams, tvae.OobleckVAE(tcfg))
    return cfg, jparams, tcfg, tmodel


def test_vae_decode(vaes):
    cfg, jparams, tcfg, tmodel = vaes
    z = randn(0, 2, 13, 64)
    with highest():
        want = jvae.vae_decode(jparams, cfg, jnp.asarray(z))
    got = tvae.vae_decode(tmodel, tcfg, t(z))
    assert got.shape == (2, 13 * cfg.hop_length, 2)
    assert_close(got, want, atol=ATOL)


def test_vae_encode_moments(vaes):
    cfg, jparams, tcfg, tmodel = vaes
    audio = randn(1, 2, 10 * cfg.hop_length, 2, scale=0.3)
    with highest():
        jm, js = jvae.vae_encode_moments(jparams, cfg, jnp.asarray(audio))
    tm, ts = tvae.vae_encode_moments(tmodel, tcfg, t(audio))
    assert_close(tm, jm, atol=ATOL, what="mean")
    assert_close(ts, js, atol=ATOL, what="std")


@pytest.mark.parametrize("T,chunk,overlap,groups", [
    (70, 32, 4, 3),      # 3 windows per group, zero-window padded last group
    (45, 32, 4, 16),     # one group
    (30, 32, 4, 4),      # T <= chunk: untiled
])
def test_tiled_decode(vaes, T, chunk, overlap, groups):
    cfg, jparams, tcfg, tmodel = vaes
    z = randn(2, 2, T, 64)
    kw = dict(chunk_size=chunk, overlap=overlap, parallel_windows=groups)
    with highest():
        want = jtiled.tiled_decode(jparams, cfg, jnp.asarray(z), **kw)
    assert_close(ttiled.tiled_decode(tmodel, tcfg, t(z), **kw), want, atol=ATOL)


def test_tiled_encode(vaes):
    cfg, jparams, tcfg, tmodel = vaes
    audio = randn(3, 1, 50 * cfg.hop_length + 5, 2, scale=0.3)
    kw = dict(chunk_size=24, overlap=4, parallel_windows=2)
    with highest():
        want = jtiled.tiled_encode(jparams, cfg, jnp.asarray(audio), **kw)
    assert_close(ttiled.tiled_encode(tmodel, tcfg, t(audio), **kw), want,
                 atol=ATOL)


def test_seeded_vae_init():
    import torch

    cfg = port_cfg(tiny_vae_cfg())
    m = tvae.init_vae_params(cfg, torch.Generator().manual_seed(0))
    w = m.decoder.blocks[0].res1.conv1.weight
    assert abs(w.std().item() - 0.02) < 0.004
    assert (m.decoder.blocks[0].res1.snake1.alpha == 0).all()
    assert (m.decoder.blocks[0].up.bias == 0).all()
