"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: seeded numpy inputs, weights carried across, float32 on the CPU.

Every comparison runs in float32. JAX calls run under
`jax.default_matmul_precision("highest")` (scoped, never global: the test
workers share one process across files), so both sides do full float32
products and the tolerances only cover summation order (~1e-6 relative per
product, compounding through the layers of a model).
"""

from __future__ import annotations

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acestep_tpu.config import DiTConfig, VAEConfig
from acestep_tpu.models import dit as jdit

B, T, LT, LL, RF = 2, 20, 7, 9, 10      # training batch geometry

def tiny_dit_cfg() -> DiTConfig:
    return DiTConfig.tiny(fsq_dim=64)


def tiny_vae_cfg() -> VAEConfig:
    return VAEConfig.tiny(decoder_input_channels=64)


def highest():
    """JAX products in full float32 for the duration of a block."""
    return jax.default_matmul_precision("highest")


@pytest.fixture()
def port_safe_root(tmp_path):
    """The port's safe root at the test's directory for one test, as
    conftest scopes the JAX package's (the same `tmp_path`): both servers
    then resolve user paths under the same root."""
    from acestep_torch.utils.path_safety import get_safe_root, set_safe_root

    old = get_safe_root()
    set_safe_root(str(tmp_path))
    yield str(tmp_path)
    set_safe_root(old)


def rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def randn(seed: int, *shape, scale: float = 1.0) -> np.ndarray:
    return (rng(seed).standard_normal(shape) * scale).astype(np.float32)


def t(a) -> torch.Tensor:
    """numpy (or JAX) array -> CPU torch tensor, same dtype."""
    return torch.from_numpy(np.array(a))


def np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def randomize_snakes(vae_tree, seed: int):
    """Non-trivial snake alpha/beta (init is zeros) in a numpy VAE tree."""
    g = rng(seed)

    def walk(node):
        if isinstance(node, dict):
            if set(node) == {"alpha", "beta"}:
                for k in ("alpha", "beta"):
                    node[k] = (0.3 * g.standard_normal(node[k].shape)).astype(
                        np.float32)
                return
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)
    walk(vae_tree)
    return vae_tree


def port_cfg(cfg):
    """The port's twin of a JAX-package config (same field values)."""
    import dataclasses

    from acestep_torch import config as tc

    cls = getattr(tc, type(cfg).__name__)
    return cls(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def assert_close(got, want, *, atol: float, rtol: float = 0.0, what=""):
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{what}: {got.shape} != {want.shape}"
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=what)


def batch_inputs(cfg, seed=0):
    """A training batch with padding in every mask; row 0 is a cover row,
    so its hints (and the tokenizer's STE) reach the loss."""
    text_m = np.ones((B, LT), np.int32)
    text_m[1, 5:] = 0
    lyric_m = np.ones((B, LL), np.int32)
    lyric_m[0, 6:] = 0
    att = np.ones((B, T), np.int32)
    att[1, 15:] = 0
    return dict(
        hidden_states=randn(seed, B, T, 64),
        attention_mask=att,
        text_hidden_states=randn(seed + 1, B, LT, cfg.text_hidden_dim),
        text_attention_mask=text_m,
        lyric_hidden_states=randn(seed + 2, B, LL, cfg.text_hidden_dim),
        lyric_attention_mask=lyric_m,
        refer_audio_packed=randn(seed + 3, B, RF, 64, scale=0.5),
        refer_order_mask=np.arange(B, dtype=np.int32),
        src_latents=randn(seed + 4, B, T, 64, scale=0.5),
        chunk_masks=np.ones((B, T, 64), np.float32),
        is_covers=np.array([1, 0], np.int32),
    )


def jax_draws(cfg, key, bsz, shape, cfg_ratio, discrete):
    """The draws `acestep_tpu.models.dit.training_loss` takes from `key`."""
    k_drop, k_noise, k_t = jax.random.split(key, 3)
    keep = jax.random.uniform(k_drop, (bsz, 1, 1)) >= cfg_ratio
    x1 = jax.random.normal(k_noise, shape, jnp.float32)
    if discrete is not None:
        pool = jnp.asarray(discrete, jnp.float32)
        tt = pool[jax.random.randint(k_t, (bsz,), 0, pool.shape[0])]
    else:
        tt, _ = jdit.sample_t_r(k_t, bsz, data_proportion=cfg.data_proportion,
                                timestep_mu=cfg.timestep_mu,
                                timestep_sigma=cfg.timestep_sigma,
                                use_meanflow=False)
    return dict(keep=t(np.asarray(keep).reshape(bsz)), noise=t(x1),
                t=t(np.asarray(tt)))


def capped(h, cot: int = 48, gen: int = 24):
    """Cap the engine's decode budgets for one block: the modes' own
    budgets (512-1024 tokens, which random weights never stop early) would
    dominate the file's time; the caps apply to both packages alike."""
    eng = h.engine
    g, c = eng.generate, eng.generate_cot_device

    def gen_(*a, **kw):
        return g(*a, **{**kw, "max_new_tokens": min(
            kw.get("max_new_tokens", 512), gen)})

    def cot_(*a, **kw):
        return c(*a, **{**kw, "max_tokens": min(kw.get("max_tokens", 256),
                                                 cot)})

    return mock.patch.multiple(eng, generate=gen_, generate_cot_device=cot_)


def one_torch_thread():
    """Generator for a module fixture: run the module's torch ops on one
    thread, then restore the count. Token-by-token decoding of a tiny LM
    is a stream of small ops; with several test workers on the machine,
    each spreading them over every core, they mostly wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
