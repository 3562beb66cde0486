"""The port's guided sampler (base/sft) against `acestep_tpu.models.sampler`:
the continuous schedule, APG and ADG, and `sample_guided` under the ODE and
the SDE, with the JAX init's weights carried across and the same `x_init`,
float32 on the CPU (DiTConfig.tiny).

Tolerances: schedules exact; `apg_step` and `adg_step` 1e-5 absolute
(float32 elementwise arithmetic and norms over at most 64 terms);
`sample_guided` 2e-4 absolute (float32 both sides, summation order
compounding over 4 doubled-batch decoder passes and the guidance). The SDE
draws its noise from a `torch.Generator`, which JAX cannot reproduce, so
the JAX side is given the noise the port drew.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acestep_tpu.models import dit as jdit
from acestep_tpu.models import sampler as jsam
from acestep_torch.models import dit as tdit
from acestep_torch.models import sampler as tsam
from acestep_torch.utils.weights import dit_from_jax
from torch_parity import (assert_close, highest, np_tree, port_cfg, randn, t,
                          tiny_dit_cfg)

B, T, LK = 2, 20, 12
ATOL_STEP = 1e-5
ATOL_SAMPLER = 2e-4


@pytest.fixture(scope="module")
def models():
    cfg = tiny_dit_cfg()
    jparams = np_tree(jdit.init_dit_params(jax.random.PRNGKey(0), cfg))
    tcfg = port_cfg(cfg)
    tmodel = dit_from_jax(jparams, tdit.build_dit(tcfg, "cpu"))
    return cfg, jparams, tcfg, tmodel


@pytest.mark.parametrize("steps,shift", [(8, 1.0), (8, 3.0), (50, 3.0),
                                         (27, 2.5)])
def test_continuous_schedule_is_exact(steps, shift):
    got = tsam.build_continuous_schedule(steps, shift=shift)
    assert got == jsam.build_continuous_schedule(steps, shift=shift)
    assert len(got) == steps + 1 and got[0] == 1.0 and got[-1] == 0.0


@pytest.mark.parametrize("norm_threshold", [2.5, 0.0])
def test_apg_step_carries_momentum_over_three_steps(norm_threshold):
    """Three chained updates; column (0, :, 3) of pred_cond is all zero,
    which the 1e-12 floor on its norm keeps finite."""
    jrun = jnp.zeros((B, T, 64), jnp.float32)
    trun = torch.zeros((B, T, 64))
    for step in range(3):
        cond = randn(10 + step, B, T, 64)
        cond[0, :, 3] = 0.0
        uncond = cond + randn(20 + step, B, T, 64, scale=0.5)
        jg, jrun = jsam.apg_step(jnp.asarray(cond), jnp.asarray(uncond), jrun,
                                 guidance_scale=7.0,
                                 norm_threshold=norm_threshold)
        tg, trun = tsam.apg_step(t(cond), t(uncond), trun, guidance_scale=7.0,
                                 norm_threshold=norm_threshold)
        assert torch.isfinite(tg).all()
        assert_close(tg, jg, atol=ATOL_STEP, what=f"guided, step {step}")
        assert_close(trun, jrun, atol=ATOL_STEP, what=f"momentum, step {step}")


@pytest.mark.parametrize("apply_norm,apply_clip,scale", [
    (False, True, 7.0), (True, True, 7.0), (False, False, 3.0),
    (False, True, 0.5)])
def test_adg_step_with_parallel_frames(apply_norm, apply_clip, scale):
    """Frames 0-5 of row 0 have pred_cond = pred_uncond = 0 and latents of
    +-1/8, so both x0 estimates are the same vector and every product and
    sum in their cosine is exact: cos = 1, sin theta = 0, and the guard
    takes `weight` as the ratio on both sides. (Nearly parallel frames
    cannot be compared at 1e-5: arccos near 1 turns the last-bit
    difference that summation order leaves in the cosine into ~1e-5.) The
    other frames are far from parallel. Scale 0.5 gives weight = 1e-3."""
    x = randn(1, B, T, 64)
    cond = randn(2, B, T, 64)
    uncond = cond + randn(3, B, T, 64)
    x[0, :6] = np.where(randn(4, 6, 64) > 0, 0.125, -0.125)
    cond[0, :6] = uncond[0, :6] = 0.0
    sigma = np.float32(0.5)
    want = jsam.adg_step(jnp.asarray(x), jnp.asarray(cond),
                         jnp.asarray(uncond), jnp.asarray(sigma),
                         guidance_scale=scale, apply_norm=apply_norm,
                         apply_clip=apply_clip)
    got = tsam.adg_step(t(x), t(cond), t(uncond), torch.tensor(sigma),
                        guidance_scale=scale, apply_norm=apply_norm,
                        apply_clip=apply_clip)
    assert torch.isfinite(got).all()
    assert_close(got, want, atol=ATOL_STEP)


def _conds(models, seed=0):
    """(jax, port) conditions: cond, null (the null embedding broadcast to
    the condition's shape, with its context latents) and a non-cover
    condition for the cover switch."""
    cfg, jparams, tcfg, tmodel = models
    enc, enc2 = randn(seed, B, LK, cfg.hidden_size), \
        randn(seed + 1, B, LK, cfg.hidden_size)
    ctx, ctx2 = randn(seed + 2, B, T, 128), randn(seed + 3, B, T, 128)
    null = np.broadcast_to(jparams["null_condition_emb"], enc.shape).copy()
    out = []
    for build, p, conv in ((jsam.ConditionSet.build, jparams, jnp.asarray),
                           (tsam.ConditionSet.build, tmodel, t)):
        c = cfg if p is jparams else tcfg
        out.append(dict(cond=build(p, c, conv(enc), conv(ctx)),
                        null_cond=build(p, c, conv(null), conv(ctx)),
                        cond_non_cover=build(p, c, conv(enc2), conv(ctx2))))
    return out


CASES = {
    "apg": dict(),
    "adg": dict(use_adg=True),
    "interval": dict(cfg_interval=(0.3, 0.8)),
    "no_cfg": dict(guidance_scale=1.0),
    "cover_switch": dict(cover_steps=2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sample_guided_ode_matches_jax(models, case):
    cfg, jparams, tcfg, tmodel = models
    kw = {"guidance_scale": 7.0, **CASES[case]}
    jc, tc = _conds(models)
    if "cover_steps" not in kw:
        jc.pop("cond_non_cover")
        tc.pop("cond_non_cover")
    schedule = tsam.build_continuous_schedule(4, shift=3.0)
    x_init = randn(7, B, T, 64)
    with highest():
        want = jsam.sample_guided(jparams, cfg, x_init=jnp.asarray(x_init),
                                  schedule=schedule, **jc, **kw)
    got = tsam.sample_guided(tmodel, tcfg, x_init=t(x_init),
                             schedule=schedule, **tc, **kw)
    assert_close(got, want, atol=ATOL_SAMPLER, what=case)


def test_sample_guided_sde_step_matches_jax_renoise(models):
    """Two SDE steps at shift 3 (schedule 1, 0.75, 0): the first renoises
    at the unshifted 1 - 1/2 = 0.5, not at 0.75, with the port's first
    draw; the second lands on x0. JAX gets the same draw."""
    cfg, jparams, tcfg, tmodel = models
    jc, tc = _conds(models, seed=30)
    jc.pop("cond_non_cover")
    tc.pop("cond_non_cover")
    schedule = tsam.build_continuous_schedule(2, shift=3.0)
    assert schedule[1] == 0.75
    x_init = randn(8, B, T, 64)
    noise = torch.randn((B, T, 64), generator=torch.Generator().manual_seed(5))
    with highest(), mock.patch("jax.random.normal",
                               lambda key, shape, dtype: jnp.asarray(
                                   noise.numpy(), dtype)):
        want = jsam.sample_guided(jparams, cfg, x_init=jnp.asarray(x_init),
                                  schedule=schedule, infer_method="sde", **jc)
    got = tsam.sample_guided(tmodel, tcfg, x_init=t(x_init),
                             schedule=schedule, infer_method="sde",
                             generator=torch.Generator().manual_seed(5), **tc)
    assert_close(got, want, atol=ATOL_SAMPLER)
    # the draw reached the result: the ODE lands elsewhere
    ode = tsam.sample_guided(tmodel, tcfg, x_init=t(x_init),
                             schedule=schedule, **tc)
    assert (got - ode).abs().max() > 1e-3


def test_doubled_condition_built_once_per_side(models):
    """[cond; null] is concatenated once per trajectory without a cover
    switch and once per side with one, not once per step."""
    cfg, jparams, tcfg, tmodel = models
    _, tc = _conds(models, seed=40)
    schedule = tsam.build_continuous_schedule(4)
    x_init = t(randn(9, B, T, 64))
    calls = []
    orig = tsam._select_condition

    def counting(a, b, use_a):
        calls.append(use_a)
        return orig(a, b, use_a)

    with mock.patch.object(tsam, "_select_condition", counting):
        tsam.sample_guided(tmodel, tcfg, x_init=x_init, schedule=schedule,
                           cond=tc["cond"], null_cond=tc["null_cond"])
        assert len(calls) == 2                     # cond + null, once
        calls.clear()
        tsam.sample_guided(tmodel, tcfg, x_init=x_init, schedule=schedule,
                           cover_steps=1, **tc)
        assert calls == [True, True, False, False]
