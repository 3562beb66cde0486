"""The port's DiT stack and turbo sampler against the JAX package, with the
JAX init's weights carried across by acestep_torch/utils/weights.py, on
the same seeded numpy inputs, float32 on the CPU (DiTConfig.tiny).

Tolerance 1e-4 absolute on O(1) activations: float32 on both sides with
full-precision products; summation order differs per product and the
differences compound through the encoder and decoder layers (and, for the
sampler, eight decoder passes).
"""

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

ATOL = 1e-4
B, T, LT, LL, RF = 2, 20, 7, 9, 10


@pytest.fixture(scope="module")
def models():
    cfg = tiny_dit_cfg()
    jparams = np_tree(jdit.init_dit_params(jax.random.PRNGKey(0), cfg))
    tcfg = port_cfg(cfg)
    tmodel = dit_from_jax(jparams, tdit.build_dit(tcfg, "cpu"))
    return cfg, jparams, tcfg, tmodel


def _cond_inputs(cfg, seed=0):
    text_m = np.ones((B, LT), np.int32)
    text_m[1, 5:] = 0
    lyric_m = np.ones((B, LL), np.int32)
    lyric_m[0, 6:] = 0
    return dict(
        text_hidden_states=randn(seed, B, LT, cfg.text_hidden_dim),
        text_attention_mask=text_m,
        lyric_hidden_states=randn(seed + 1, B, LL, cfg.text_hidden_dim),
        lyric_attention_mask=lyric_m,
        refer_audio_packed=randn(seed + 2, B, RF, 64, scale=0.5),
        refer_order_mask=np.arange(B, dtype=np.int32),
        src_latents=randn(seed + 3, B, T, 64, scale=0.5),
        chunk_masks=np.ones((B, T, 64), np.float32),
        is_covers=np.array([1, 0], np.int32),
        silence_latent=randn(seed + 4, 1, T + 5, 64, scale=0.1),
    )


def _both(inputs):
    return ({k: jnp.asarray(v) for k, v in inputs.items()},
            {k: t(v) for k, v in inputs.items()})


def test_weights_carry_every_parameter(models):
    cfg, jparams, tcfg, tmodel = models
    n_jax = sum(np.asarray(x).size for x in jax.tree.leaves(jparams))
    assert sum(p.numel() for p in tmodel.parameters()) == n_jax
    w = jparams["decoder"]["layers"]["self_attn"]["q_proj"]["w"][1]
    assert np.array_equal(tmodel.decoder.layers[1].self_attn.q_proj.weight.numpy(),
                          w.T)


def test_prepare_condition_round_trip_hints(models):
    """The text2music hint path: tokenize (padded to the pool window with
    the silence latent), FSQ, detokenize; row 0 is a cover row and takes
    the hints. FSQ indices are compared on their own: no tie flipped."""
    cfg, jparams, tcfg, tmodel = models
    ji, ti = _both(_cond_inputs(cfg))
    with highest():
        jenc, jmask, jctx = jdit.prepare_condition(jparams, cfg, **ji)
        x2 = jnp.concatenate([ji["src_latents"], jnp.broadcast_to(
            ji["silence_latent"][:1, :5], (B, 5, 64))], axis=1)
        _, jidx = jdit.audio_tokenize(jparams, cfg, x2)
    tenc, tmask, tctx = tdit.prepare_condition(tmodel, tcfg, **ti)
    _, tidx = tdit.audio_tokenize(tmodel, tcfg, torch.cat(
        [ti["src_latents"], ti["silence_latent"][:1, :5].expand(B, 5, 64)], 1))
    assert np.array_equal(tidx.numpy(), np.asarray(jidx))
    assert np.array_equal(tmask.numpy(), np.asarray(jmask))
    assert_close(tenc, jenc, atol=ATOL, what="encoder states")
    assert_close(tctx, jctx, atol=ATOL, what="context latents")


def test_prepare_condition_audio_codes(models):
    cfg, jparams, tcfg, tmodel = models
    inputs = _cond_inputs(cfg, seed=5)
    codes = np.random.default_rng(0).integers(0, 64000, (B, T // 5)).astype(np.int32)
    valid = np.array([T, 10], np.int32)
    ji, ti = _both(inputs)
    with highest():
        _, _, jctx = jdit.prepare_condition(
            jparams, cfg, **ji, audio_codes=jnp.asarray(codes),
            audio_codes_valid_frames=jnp.asarray(valid))
    _, _, tctx = tdit.prepare_condition(
        tmodel, tcfg, **ti, audio_codes=t(codes),
        audio_codes_valid_frames=t(valid))
    assert_close(tctx, jctx, atol=ATOL)


def test_decoder_cross_kv_and_dit_decoder(models):
    cfg, jparams, tcfg, tmodel = models
    enc = randn(0, B, 12, cfg.hidden_size)
    xt, ctx = randn(1, B, 19, 64), randn(2, B, 19, 128)      # odd T: patch pad
    ts, tr = np.array([0.9, 0.4], np.float32), np.array([0.9, 0.1], np.float32)
    with highest():
        jk, jv = jdit.decoder_cross_kv(jparams, cfg, jnp.asarray(enc))
        want = jdit.dit_decoder(jparams, cfg, jnp.asarray(xt), jnp.asarray(ts),
                                jnp.asarray(tr), jnp.asarray(ctx),
                                cross_kv_cache=(jk, jv))
        want_enc = jdit.dit_decoder(jparams, cfg, jnp.asarray(xt),
                                    jnp.asarray(ts), jnp.asarray(tr),
                                    jnp.asarray(ctx),
                                    encoder_hidden_states=jnp.asarray(enc))
    tk, tv = tdit.decoder_cross_kv(tmodel, tcfg, t(enc))
    assert_close(tk, jk, atol=ATOL, what="cross k")
    assert_close(tv, jv, atol=ATOL, what="cross v")
    got = tdit.dit_decoder(tmodel, tcfg, t(xt), t(ts), t(tr), t(ctx),
                           cross_kv_cache=(tk, tv))
    assert_close(got, want, atol=ATOL, what="decoder, cached K/V")
    got = tdit.dit_decoder(tmodel, tcfg, t(xt), t(ts), t(tr), t(ctx),
                           encoder_hidden_states=t(enc))
    assert_close(got, want_enc, atol=ATOL, what="decoder, encoder states")


def test_decoder_long_sequence_alternates_band_and_full(models):
    """L = 30 patches > window 8: the banded layers differ from full ones,
    so a wrong band (or none) shows."""
    cfg, jparams, tcfg, tmodel = models
    enc, xt, ctx = randn(3, 1, 6, cfg.hidden_size), randn(4, 1, 60, 64), \
        randn(5, 1, 60, 128)
    ts = np.array([0.5], np.float32)
    with highest():
        want = jdit.dit_decoder(jparams, cfg, jnp.asarray(xt), jnp.asarray(ts),
                                jnp.asarray(ts), jnp.asarray(ctx),
                                encoder_hidden_states=jnp.asarray(enc))
    got = tdit.dit_decoder(tmodel, tcfg, t(xt), t(ts), t(ts), t(ctx),
                           encoder_hidden_states=t(enc))
    assert_close(got, want, atol=ATOL)


@pytest.mark.parametrize("cover_steps", [None, 3])
def test_sample_turbo_ode(models, cover_steps):
    cfg, jparams, tcfg, tmodel = models
    enc, enc2 = randn(0, B, 12, cfg.hidden_size), randn(6, B, 12, cfg.hidden_size)
    ctx, ctx2 = randn(1, B, T, 128), randn(7, B, T, 128)
    x_init = randn(2, B, T, 64)
    schedule = jsam.build_turbo_schedule(shift=3.0)
    assert tsam.build_turbo_schedule(shift=3.0) == schedule
    assert tsam.build_turbo_schedule(timesteps=[0.97, 0.5, 0.0]) == \
        jsam.build_turbo_schedule(timesteps=[0.97, 0.5, 0.0])
    with highest():
        jc = jsam.ConditionSet.build(jparams, cfg, jnp.asarray(enc), jnp.asarray(ctx))
        jnc = jsam.ConditionSet.build(jparams, cfg, jnp.asarray(enc2), jnp.asarray(ctx2))
        want = jsam.sample_turbo(jparams, cfg, x_init=jnp.asarray(x_init),
                                 schedule=schedule, cond=jc,
                                 cond_non_cover=jnc if cover_steps else None,
                                 cover_steps=cover_steps)
    tc = tsam.ConditionSet.build(tmodel, tcfg, t(enc), t(ctx))
    tnc = tsam.ConditionSet.build(tmodel, tcfg, t(enc2), t(ctx2))
    got = tsam.sample_turbo(tmodel, tcfg, x_init=t(x_init), schedule=schedule,
                            cond=tc, cond_non_cover=tnc if cover_steps else None,
                            cover_steps=cover_steps)
    assert_close(got, want, atol=ATOL)


def test_sample_turbo_sde_runs_and_is_seeded(models):
    """SDE noise comes from a torch.Generator (not JAX's RNG): the check is
    determinism per seed and a finite result, not parity."""
    cfg, jparams, tcfg, tmodel = models
    cond = tsam.ConditionSet.build(tmodel, tcfg, t(randn(0, 1, 6, cfg.hidden_size)),
                                   t(randn(1, 1, T, 128)))
    schedule = tsam.build_turbo_schedule(shift=3.0)

    def run(seed):
        return tsam.sample_turbo(tmodel, tcfg, x_init=t(randn(2, 1, T, 64)),
                                 schedule=schedule, cond=cond, infer_method="sde",
                                 generator=torch.Generator().manual_seed(seed))
    a, b, c = run(1), run(1), run(2)
    assert torch.isfinite(a).all() and torch.equal(a, b) and not torch.equal(a, c)


def test_schedule_helpers():
    for s in (0.5, 1.0, 2.4, 3.0, 7.0):
        assert tsam.build_turbo_schedule(shift=s) == jsam.build_turbo_schedule(shift=s)
    sched = jsam.build_turbo_schedule(shift=3.0)
    for strength in (0.0, 0.3, 0.8):
        assert tsam.truncate_for_cover_noise(sched, strength) == \
            jsam.truncate_for_cover_noise(sched, strength)


def test_seeded_init_distributions():
    """The port's own seeded init mirrors the JAX init in distribution."""
    cfg = port_cfg(tiny_dit_cfg())
    m = tdit.init_dit_params(cfg, torch.Generator().manual_seed(0))
    q = m.decoder.layers[0].self_attn.q_proj.weight
    assert abs(q.std().item() - 0.02) < 0.003
    assert torch.equal(m.decoder.norm_out.scale, torch.ones(cfg.hidden_size))
    assert (m.decoder.time_embed.linear_1.bias == 0).all()
    sst = m.decoder.layers[0].scale_shift_table
    assert abs(sst.std().item() - cfg.hidden_size ** -0.5) < 0.03
    assert abs(m.tokenizer.pooler.special_token.std().item() - 0.02) < 0.01
