"""The port's Qwen3 LM (models/lm.py) against the JAX package's, float32 on
the CPU, tiny geometry, the same weights (the JAX seeded init carried across
by `lm_from_jax`) and the same seeded numpy token ids.

Tolerances: logits and hidden states 1e-4 absolute (float32 on both sides,
JAX at "highest" matmul precision, so only summation order differs over two
layers); int8 cache values within one quantization step of JAX's (a value
on a rounding boundary may round either way) with scales to 1e-6 relative;
the int8-cache logits 1e-4 like the float path. The samplers' kept sets and
greedy tokens must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acestep_tpu.config import LMConfig
from acestep_tpu.models import lm as jlm
from acestep_torch.models import lm as tlm
from acestep_torch.utils.weights import lm_from_jax
from torch_parity import highest, np_tree, port_cfg, randn, rng

ATOL = 1e-4


@pytest.fixture(scope="module", params=[True, False], ids=["tied", "untied"])
def lm(request):
    cfg = LMConfig.tiny(tie_word_embeddings=request.param)
    params = jlm.init_lm_params(jax.random.PRNGKey(0), cfg)
    tcfg = port_cfg(cfg)
    model = lm_from_jax(np_tree(params), tlm.build_lm(tcfg, "cpu"))
    return cfg, params, tcfg, model


def _ids(seed, B, L, vocab):
    return rng(seed).integers(1, vocab, (B, L)).astype(np.int32)


def _jax_logits(cfg, params, ids, S, start, mask=None, quantized=False):
    with highest():
        cache = jlm.KVCache.create(cfg, ids.shape[0], S, dtype=jnp.float32,
                                   quantized=quantized)
        h, cache = jlm.lm_forward(
            params, cfg, jnp.asarray(ids), cache,
            start_pos=jnp.asarray(start, jnp.int32),
            attention_mask=None if mask is None else jnp.asarray(mask))
        return np.asarray(jlm.lm_logits(params, cfg, h)), cache


@torch.no_grad()
def _torch_logits(tcfg, model, ids, S, start, mask=None, quantized=False,
                  cache=None):
    if cache is None:
        cache = tlm.KVCache.create(tcfg, ids.shape[0], S,
                                   dtype=torch.float32, quantized=quantized)
    h = tlm.lm_forward(model, tcfg, torch.from_numpy(ids).long(), cache,
                       start_pos=torch.as_tensor(start),
                       attention_mask=None if mask is None
                       else torch.from_numpy(mask))
    return tlm.lm_logits(model, tcfg, h).numpy(), cache


def test_prefill_then_decode_matches_full_forward_and_jax(lm):
    cfg, params, tcfg, model = lm
    ids = _ids(1, 2, 6, cfg.vocab_size)
    full, _ = _torch_logits(tcfg, model, ids, 8, 0)
    want, _ = _jax_logits(cfg, params, ids, 8, 0)
    np.testing.assert_allclose(full, want, atol=ATOL)
    step, cache = _torch_logits(tcfg, model, ids[:, :4], 8, 0)
    outs = [step[:, -1]]
    for i in (4, 5):
        step, cache = _torch_logits(tcfg, model, ids[:, i:i + 1], 8, i,
                                    cache=cache)
        outs.append(step[:, -1])
    np.testing.assert_allclose(np.stack(outs, 1), full[:, 3:], atol=ATOL)


def test_ragged_per_row_start_matches_jax(lm):
    """Per-row offsets: each row's K/V, RoPE and causal mask follow its own
    start; the cache contents must match too."""
    cfg, params, tcfg, model = lm
    ids = _ids(2, 3, 5, cfg.vocab_size)
    start = np.array([0, 2, 3], np.int32)
    got, tc = _torch_logits(tcfg, model, ids, 12, start)
    want, jc = _jax_logits(cfg, params, ids, 12, start)
    np.testing.assert_allclose(got, want, atol=ATOL)
    # the port's cache swaps JAX's slot and head axes
    np.testing.assert_allclose(tc.k.transpose(2, 3).numpy(),
                               np.asarray(jc.k), atol=ATOL)
    np.testing.assert_allclose(tc.v.transpose(2, 3).numpy(),
                               np.asarray(jc.v), atol=ATOL)
    # a decode step at ragged lengths on top of the ragged prefill
    nxt = _ids(3, 3, 1, cfg.vocab_size)
    got2, _ = _torch_logits(tcfg, model, nxt, 12, start + 5, cache=tc)
    with highest():
        h, _ = jlm.lm_forward(params, cfg, jnp.asarray(nxt), jc,
                              start_pos=jnp.asarray(start + 5))
        want2 = np.asarray(jlm.lm_logits(params, cfg, h))
    np.testing.assert_allclose(got2, want2, atol=ATOL)


def test_attention_mask_is_authoritative(lm):
    """The mask covers the write window too: a masked leading key written
    in the same call must not reach later positions, as in JAX."""
    cfg, params, tcfg, model = lm
    mask = np.array([[0, 1, 1, 1, 1, 1], [1, 1, 1, 0, 1, 1]], np.int32)
    ids = _ids(4, 2, 6, cfg.vocab_size)
    got, _ = _torch_logits(tcfg, model, ids, 6, 0, mask=mask)
    want, _ = _jax_logits(cfg, params, ids, 6, 0, mask=mask)
    np.testing.assert_allclose(got, want, atol=ATOL)
    ids2 = ids.copy()
    ids2[0, 0] = (ids[0, 0] + 7) % cfg.vocab_size
    got2, _ = _torch_logits(tcfg, model, ids2, 6, 0, mask=mask)
    np.testing.assert_allclose(got2[0, 1:], got[0, 1:], atol=1e-6)


def test_lm_encode_matches_jax(lm):
    cfg, params, tcfg, model = lm
    ids = _ids(5, 2, 7, cfg.vocab_size)
    mask = np.ones((2, 7), np.int32)
    mask[1, :2] = 0                                   # left padding
    with highest():
        want = np.asarray(jlm.lm_encode(params, cfg, jnp.asarray(ids),
                                        jnp.asarray(mask)))
    with torch.no_grad():
        got = tlm.lm_encode(model, tcfg, torch.from_numpy(ids).long(),
                            torch.from_numpy(mask)).numpy()
    assert got.shape == (2, 7, cfg.hidden_size)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_int8_cache_and_graft_match_jax(lm):
    cfg, params, tcfg, model = lm
    ids = _ids(6, 2, 6, cfg.vocab_size)
    got, tc = _torch_logits(tcfg, model, ids, 8, 0, quantized=True)
    want, jc = _jax_logits(cfg, params, ids, 8, 0, quantized=True)
    assert tc.quantized and tc.k.dtype == torch.int8
    np.testing.assert_allclose(got, want, atol=ATOL)
    for a, b in ((tc.k, jc.k), (tc.v, jc.v)):
        assert np.abs(a.transpose(2, 3).numpy().astype(int)
                      - np.asarray(b).astype(int)).max() <= 1
    np.testing.assert_allclose(tc.k_scale.transpose(2, 3).numpy(),
                               np.asarray(jc.k_scale), rtol=1e-5, atol=1e-9)
    # prefill then decode through the int8 cache equals its full forward
    step, cache = _torch_logits(tcfg, model, ids[:, :4], 8, 0,
                                quantized=True)
    step, cache = _torch_logits(tcfg, model, ids[:, 4:5], 8, 4, cache=cache)
    np.testing.assert_allclose(step[:, -1], got[:, 4], atol=2e-3)
    dst = tlm.KVCache.create(tcfg, 2, 12, dtype=torch.float32,
                             quantized=True)
    dst.graft_prefix(tc, 4)
    jdst = jlm.KVCache.create(cfg, 2, 12, dtype=jnp.float32,
                              quantized=True).graft_prefix(jc, 4)
    assert torch.equal(dst.k[:, :, :, :4], tc.k[:, :, :, :4])
    assert torch.equal(dst.v_scale[:, :, :, :4], tc.v_scale[:, :, :, :4])
    assert not dst.k[:, :, :, 4:].any()
    assert not np.asarray(jdst.k[:, :, 4:]).any()


@pytest.mark.parametrize("k", [1, 3, 17])
def test_top_k_matches_jax(k):
    lg = randn(7, 4, 40)
    got = tlm.apply_top_k(torch.from_numpy(lg), k).numpy()
    want = np.asarray(jlm.apply_top_k(jnp.asarray(lg), k))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_array_equal(got[np.isfinite(got)], lg[np.isfinite(got)])


@pytest.mark.parametrize("p", [0.3, 0.7, 0.9, 0.999])
def test_top_p_bisection_keeps_jax_set(p):
    """The bisection's kept set equals JAX's, ties included (rows 2 and 3
    repeat values)."""
    lg = randn(8, 4, 64)
    lg[2, 10:20] = lg[2, 5]
    lg[3] = np.round(lg[3], 1)
    got = tlm.apply_top_p(torch.from_numpy(lg), p).numpy()
    want = np.asarray(jlm.apply_top_p(jnp.asarray(lg), p))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    probs = np.exp(lg - lg.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    assert ((probs * np.isfinite(got)).sum(-1) >= p - 1e-5).all()


def test_greedy_and_masked_sampler_match_jax():
    lg = randn(9, 3, 50)
    allow = rng(10).random((3, 50)) < 0.3
    allow[:, 0] = True
    for mask in (None, allow):
        got = tlm.sample_tokens(None, torch.from_numpy(lg), temperature=0.0,
                                allow_mask=None if mask is None
                                else torch.from_numpy(mask)).numpy()
        want = np.asarray(jlm.sample_tokens(
            jax.random.PRNGKey(0), jnp.asarray(lg), temperature=0.0,
            allow_mask=None if mask is None else jnp.asarray(mask)))
        np.testing.assert_array_equal(got, want)


def test_stochastic_sampler_respects_filters():
    """Draws stay inside the allow mask and the top-k set, and a seeded
    generator reproduces them."""
    lg = torch.from_numpy(randn(11, 4, 30))
    allow = torch.from_numpy(rng(12).random((4, 30)) < 0.5)
    allow[:, 3] = True
    keep = torch.isfinite(tlm.apply_top_k(lg.masked_fill(~allow, -np.inf), 3))
    draws = [tlm.sample_tokens(torch.Generator().manual_seed(s), lg,
                               temperature=0.9, top_k=3, top_p=0.95,
                               allow_mask=allow) for s in range(20)]
    for d in draws:
        assert keep[torch.arange(4), d].all()
    again = tlm.sample_tokens(torch.Generator().manual_seed(0), lg,
                              temperature=0.9, top_k=3, top_p=0.95,
                              allow_mask=allow)
    assert torch.equal(draws[0], again)


def test_penalty_and_cfg_mix_match_jax():
    lg = randn(13, 4, 20)
    seen = rng(14).random((4, 20)) < 0.4
    got = tlm.apply_repetition_penalty(torch.from_numpy(lg),
                                       torch.from_numpy(seen), 1.3).numpy()
    want = np.asarray(jlm.apply_repetition_penalty(
        jnp.asarray(lg), jnp.asarray(seen), 1.3))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    got = tlm.cfg_mix_logits(torch.from_numpy(lg), 2.5).numpy()
    want = np.asarray(jlm.cfg_mix_logits(jnp.asarray(lg), 2.5))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_seeded_init_is_on_device_in_dtype():
    """init_lm_params draws each leaf in the target dtype from the
    generator: same seed, same weights; the JAX init's distributions."""
    cfg = port_cfg(LMConfig.tiny(tie_word_embeddings=False))
    a = tlm.init_lm_params(cfg, torch.Generator().manual_seed(3),
                           dtype=torch.bfloat16)
    b = tlm.init_lm_params(cfg, torch.Generator().manual_seed(3),
                           dtype=torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in a.parameters())
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))
    assert abs(a.embed_tokens.float().std().item() - 0.02) < 2e-3
    assert torch.equal(a.norm.scale, torch.ones_like(a.norm.scale))


def test_qwen_text_embedder_matches_jax(lm):
    """The Qwen3-Embedding text encoder: the trunk's last hidden states
    (encode_text) and the bare table rows (encode_lyrics), same tolerance."""
    from acestep_tpu.llm.tokenizer import SimpleTokenizer
    from acestep_tpu.pipeline.embedder import QwenTextEmbedder as JaxEmb
    from acestep_torch.pipeline.embedder import QwenTextEmbedder

    cfg, params, tcfg, model = lm
    tok = SimpleTokenizer(num_audio_codes=0)
    texts = ["a calm song", "hello world, loud"]
    with highest():
        jemb = JaxEmb(params, cfg, tok, dtype=jnp.float32)
        want = [(np.asarray(h), np.asarray(m)) for h, m in (
            jemb.encode_text(texts), jemb.encode_lyrics(texts))]
    temb = QwenTextEmbedder(model, tcfg, tok, dtype=torch.float32)
    for (h, m), (wh, wm) in zip((temb.encode_text(texts),
                                 temb.encode_lyrics(texts)), want):
        np.testing.assert_array_equal(m, wm)
        np.testing.assert_allclose(h, wh, atol=ATOL)
