"""The port's flow-matching training loss and full-parameter step against
the JAX package, weights carried across, float32 on the CPU
(DiTConfig.tiny).

JAX keys and torch generators draw different numbers, so each test
reproduces the JAX function's own draws from its key (`k_drop, k_noise,
k_t = jax.random.split(key, 3)` and the lines that use them) and hands
them to the port's `training_loss` as `keep`, `noise` and `t`.

Tolerances. The loss: 1e-5 relative (float32, summation order). Each
parameter gradient: 2e-4 of the largest |gradient| of that parameter, as
the differences of the forward (~1e-6 relative) compound through the
backward of the encoders, the tokenizer's straight-through FSQ and two
decoder layers. One AdamW step: the first update of Adam is about
lr * sign(gradient), so a gradient entry near 0 can flip the sign of its
update on a tiny difference; the updated parameters are held to 5e-2 * lr
on all but 1e-3 of the entries, and every entry to 2 * lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from acestep_tpu.models import dit as jdit
from acestep_tpu.models.sampler import build_turbo_schedule
from acestep_tpu.training import step as jstep
from acestep_torch.models import dit as tdit
from acestep_torch.training import step as tstep
from acestep_torch.utils.weights import dit_from_jax
from torch_parity import (B, T, assert_close, batch_inputs, highest,
                          jax_draws, np_tree, port_cfg, t, tiny_dit_cfg)


@pytest.fixture(scope="module")
def models():
    cfg = tiny_dit_cfg()
    jparams = np_tree(jdit.init_dit_params(jax.random.PRNGKey(0), cfg))
    tcfg = port_cfg(cfg)
    return cfg, jparams, tcfg


def _port_model(tcfg, jparams):
    return dit_from_jax(jparams, tdit.build_dit(tcfg, "cpu")).requires_grad_()


def _mixed_key(cfg, cfg_ratio, discrete):
    """A key whose CFG draw keeps one row and drops the other."""
    for seed in range(64):
        key = jax.random.PRNGKey(seed)
        d = jax_draws(cfg, key, B, (B, T, 64), cfg_ratio, discrete)
        if d["keep"].any() and not d["keep"].all():
            return key, d
    raise AssertionError("no mixed CFG draw in 64 keys")


@pytest.mark.parametrize("mode", ["discrete", "continuous"])
def test_training_loss_and_gradients_match_jax(models, mode):
    cfg, jparams, tcfg = models
    discrete = build_turbo_schedule(shift=3.0) if mode == "discrete" else None
    cfg_ratio = 0.5
    key, draws = _mixed_key(cfg, cfg_ratio, discrete)
    batch = batch_inputs(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with highest():
        jloss, jgrads = jax.jit(jax.value_and_grad(
            lambda p: jdit.training_loss(p, cfg, key, cfg_ratio=cfg_ratio,
                                         discrete_timesteps=discrete,
                                         **jb)))(jparams)
    model = _port_model(tcfg, jparams)
    loss = tdit.training_loss(model, tcfg, cfg_ratio=cfg_ratio,
                              remat=False, **draws,
                              **{k: t(v) for k, v in batch.items()})
    loss.backward()
    assert_close(loss, jloss, atol=0.0, rtol=1e-5, what="loss")
    want = dit_from_jax(np_tree(jgrads))
    nonzero = 0
    for name, p in model.named_parameters():
        w = want[name]
        scale = float(w.abs().max())
        nonzero += scale > 0
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        assert_close(got, w, atol=2e-4 * scale + 1e-9, what=name)
    assert model.tokenizer.fsq.project_in.weight.grad.abs().max() > 0
    assert nonzero > 0.9 * len(want)


def test_remat_gives_the_same_gradients(models):
    cfg, jparams, tcfg = models
    _key, draws = _mixed_key(cfg, 0.5, None)
    batch = {k: t(v) for k, v in batch_inputs(cfg, seed=3).items()}
    grads = []
    for remat in (False, True):
        model = _port_model(tcfg, jparams)
        tdit.training_loss(model, tcfg, cfg_ratio=0.5, remat=remat, **draws,
                           **batch).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        assert_close(grads[1][name], g, atol=1e-7, what=name)


def test_train_step_matches_jax(models):
    cfg, jparams, tcfg = models
    lr = 1e-3
    key = jax.random.PRNGKey(7)
    batch = batch_inputs(cfg, seed=5)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    opt = optax.chain(optax.clip_by_global_norm(1.0),
                      optax.adamw(lr, weight_decay=0.01))
    jp = jax.tree.map(jnp.asarray, jparams)
    with highest():
        jnew, _, jloss = jstep.make_train_step(cfg, opt, donate=False)(
            jp, opt.init(jp), jb, key)
    model = _port_model(tcfg, jparams)
    step = tstep.make_train_step(
        model, tcfg, torch.optim.AdamW(model.parameters(), lr=lr,
                                       weight_decay=0.01),
        grad_clip=1.0)
    loss = step({k: t(v) for k, v in batch.items()},
                **jax_draws(cfg, key, B, (B, T, 64), 0.15, None))
    assert_close(loss, jloss, atol=0.0, rtol=1e-5, what="loss")
    want = dit_from_jax(np_tree(jnew))
    off, total = 0, 0
    for name, p in model.named_parameters():
        diff = (p.detach() - want[name]).abs()
        assert diff.max() <= 2 * lr, name
        off += int((diff > 5e-2 * lr).sum())
        total += diff.numel()
    assert off <= 1e-3 * total, (off, total)


def test_sample_t_r_law():
    g = torch.Generator().manual_seed(0)
    tt, r = tdit.sample_t_r(20000, generator=g, data_proportion=0.25,
                            timestep_mu=-0.4, timestep_sigma=1.0)
    assert (tt >= r).all() and torch.equal(tt[:5000], r[:5000])
    jt, _ = jdit.sample_t_r(jax.random.PRNGKey(0), 20000, data_proportion=0.25)
    # same law on another generator: the quantiles agree to sampling noise
    qs = torch.tensor([0.1, 0.5, 0.9])
    assert_close(torch.quantile(tt, qs), np.quantile(np.asarray(jt), qs),
                 atol=0.02)


def test_tiny_batch_feeds_the_loss(models):
    _cfg, jparams, tcfg = models
    batch = tstep.tiny_batch(tcfg, torch.Generator().manual_seed(0))
    model = _port_model(tcfg, jparams)
    loss = tdit.training_loss(model, tcfg, generator=torch.Generator()
                              .manual_seed(1), **batch)
    assert torch.isfinite(loss) and loss.item() > 0
