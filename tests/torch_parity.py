"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: seeded numpy inputs, weights carried across, float32 on the CPU.

Every comparison runs in float32. JAX calls run under
`jax.default_matmul_precision("highest")` (scoped, never global: the test
workers share one process across files), so both sides do full float32
products and the tolerances only cover summation order (~1e-6 relative per
product, compounding through the layers of a model).
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from acestep_tpu.config import DiTConfig, VAEConfig

def tiny_dit_cfg() -> DiTConfig:
    return DiTConfig.tiny(fsq_dim=64)


def tiny_vae_cfg() -> VAEConfig:
    return VAEConfig.tiny(decoder_input_channels=64)


def highest():
    """JAX products in full float32 for the duration of a block."""
    return jax.default_matmul_precision("highest")


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
