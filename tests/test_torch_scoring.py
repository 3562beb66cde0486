"""The port's scoring and LRC alignment against the JAX package's, on the
CPU.

- `scoring/dtw.py`, `alignment.py`, `lyric_score.py` and `utils/lrc.py`
  are numpy on both sides: on the same seeded arrays their outputs must be
  EQUAL (paths, timestamps, LRC and VTT text, scores).
- `dit_decoder_attn_capture` on a tiny DiT, float32 both sides (JAX at
  "highest"), same weights and inputs: probabilities within 1e-5 absolute
  (each is a softmax of float32 logits; summation order only). The
  port's self-attention goes through `ops.flash_attention` (its plain
  version here), JAX's through its dense attention: the same function.
- `generate_lrc` with the noise shared (JAX draws it from
  `jax.random.normal(PRNGKey(seed))`, handed to the port's `noise=`): LRC
  text equal, scores within 1e-4.
- `sequence_logprob` / `calculate_reward_score` on a tiny planner, float32
  and w8a8 (int8 trunk products, `head_q`): log-probabilities within 1e-4
  relative (sums of float32 log-softmaxes over ~100 positions), and in
  bfloat16 (each side rounds its own products) within 2e-2 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acestep_tpu import scoring as js
from acestep_tpu.llm.handler import LLMHandler as JaxLLM
from acestep_tpu.models import dit as jdit
from acestep_tpu.pipeline.handler import AceStepHandler as JaxHandler
from acestep_tpu.utils import lrc as jlrc
from acestep_torch import inference as tinf
from acestep_torch import scoring as ts
from acestep_torch.llm.handler import LLMHandler
from acestep_torch.models import dit as tdit
from acestep_torch.pipeline.handler import AceStepHandler
from acestep_torch.utils import lrc as tlrc
from torch_parity import (highest, np_tree, one_torch_thread, port_cfg,
                          randn, rng, t, tiny_dit_cfg, tiny_vae_cfg)

GEOM = dict(frame_bucket=20, min_frames=20, refer_frames=10)


def _capture_maps(seed, layers=(2, 5), heads=2, frames=40, keys=16):
    """Noisy attention with a monotonic band over the first 10 keys."""
    g = rng(seed)
    out = {}
    for layer in layers:
        a = g.random((1, heads, frames, keys)).astype(np.float32) * 0.3
        for f in range(frames):
            a[:, :, f, min(f * 10 // frames, 9)] += 1.0
        out[layer] = a / a.sum(-1, keepdims=True)
    return out


@pytest.mark.parametrize("shape", [(6, 6), (5, 17), (12, 40), (1, 9)])
def test_dtw_and_median_filter_equal_jax(shape):
    cost = rng(shape[0] * 100 + shape[1]).random(shape).astype(np.float32)
    for got, want in zip(ts.dtw(cost), js.dtw(cost)):
        np.testing.assert_array_equal(got, want)
    for width in (1, 4, 7):
        np.testing.assert_array_equal(ts.median_filter(cost, width),
                                      js.median_filter(cost, width))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_aligner_and_score_equal_jax(seed):
    captured = _capture_maps(seed)
    token_strs = list("# Lyric\n") + list("ab\ncd\n")
    lyric_len = 10
    got = ts.MusicStampsAligner(patch_size=2).get_timestamps_and_lrc(
        captured, token_strs[:lyric_len], lyric_len=lyric_len)
    want = js.MusicStampsAligner(patch_size=2).get_timestamps_and_lrc(
        captured, token_strs[:lyric_len], lyric_len=lyric_len)
    assert [vars(x) for x in got[0]] == [vars(x) for x in want[0]]
    assert [(s.text, s.start, s.end) for s in got[1]] == \
        [(s.text, s.start, s.end) for s in want[1]]
    assert got[2] == want[2]
    assert ts.lyric_alignment_score(captured, lyric_len) == \
        js.lyric_alignment_score(captured, lyric_len)


def test_format_lrc_equal_jax():
    sents = [js.SentenceTimestamp(text=x, start=s, end=s + 1.0)
             for x, s in (("hello", 61.25), ("[Verse]", 3.0), ("en", 4.0),
                          ("# Lyric", 0.0), ("world of song", 125.5))]
    tsents = [ts.SentenceTimestamp(text=x.text, start=x.start, end=x.end)
              for x in sents]
    assert ts.format_lrc(tsents) == js.format_lrc(sents)
    assert ts.format_lrc(tsents).splitlines() == ["[01:01.25]hello",
                                                  "[02:05.50]world of song"]


@pytest.mark.parametrize("total", [None, 8.0, 30.0])
def test_lrc_subtitles_and_vtt_equal_jax(total):
    text = ("[00:01.25]first line\n[00:02.00]close after\n"
            "no tag here\n[00:05.500]third[00:07.00]\n[00:10.00]tail\n")
    assert tlrc.parse_lrc_to_subtitles(text, total_duration=total) == \
        jlrc.parse_lrc_to_subtitles(text, total_duration=total)
    assert tlrc.lrc_to_vtt(text, total_duration=total) == \
        jlrc.lrc_to_vtt(text, total_duration=total)
    assert tlrc.lrc_to_vtt("") is None and jlrc.lrc_to_vtt("") is None


@pytest.fixture(scope="module")
def handlers():
    jh = JaxHandler(dit_config=tiny_dit_cfg(), vae_config=tiny_vae_cfg(),
                    dtype=jnp.float32, **GEOM)
    jh.initialize_service(seed=0)
    th = AceStepHandler(port_cfg(tiny_dit_cfg()), port_cfg(tiny_vae_cfg()),
                        dtype=torch.float32, device="cpu", **GEOM)
    th.initialize_service(params=np_tree(jh.params),
                          vae_params=np_tree(jh.vae_params))
    return jh, th


@pytest.mark.parametrize("capture", [{0: [0, 1], 1: [2]}, {1: [3]}])
def test_attn_capture_equals_jax(handlers, capture):
    jh, th = handlers
    cfg = tiny_dit_cfg()
    B, T, Lk = 2, 30, 11
    xt = randn(1, B, T, 64)
    ctx = randn(2, B, T, cfg.in_channels - 64)
    enc = randn(3, B, Lk, cfg.hidden_size)
    tt = np.full((B,), 0.125, np.float32)
    with highest():
        want = jdit.dit_decoder_attn_capture(
            jh.params, cfg, jnp.asarray(xt), jnp.asarray(tt), jnp.asarray(tt),
            jnp.asarray(ctx), jnp.asarray(enc), capture)
    got = tdit.dit_decoder_attn_capture(
        th.model, port_cfg(cfg), t(xt), t(tt), t(tt), t(ctx), t(enc), capture)
    assert set(got) == set(want) == set(capture)
    for layer in capture:
        assert got[layer].shape == (B, len(capture[layer]), T // 2, Lk)
        np.testing.assert_allclose(got[layer].numpy(),
                                   np.asarray(want[layer]), atol=1e-5)


@pytest.mark.parametrize("capture", [None, {0: [0, 1], 1: [2, 3]}])
def test_generate_lrc_equals_jax(handlers, capture):
    """37 real frames bucket to 40; DEFAULT_CAPTURE (layers 2-6) clips to
    {0: [0]} on the 2-layer model, as in JAX."""
    jh, th = handlers
    pred = randn(5, 37, 64)
    lyrics = "[verse]\nhello bright moon\nsing along\n[chorus]\nla la la"
    kw = dict(metas={"bpm": 100, "duration": 1.5}, vocal_language="en",
              seed=3, capture=capture)
    with highest():
        want = jh.generate_lrc(pred, "a folk song", lyrics, **kw)
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (1, 40, 64),
                                         jnp.float32))
    got = th.generate_lrc(pred, "a folk song", lyrics, noise=noise, **kw)
    assert got["lrc"] == want["lrc"] and got["lrc"]
    assert [x.token for x in got["tokens"]] == \
        [x.token for x in want["tokens"]]
    assert set(got["score"]) == set(want["score"])
    for k, v in want["score"].items():
        assert abs(got["score"][k] - v) <= 1e-4, k
    assert 0.0 <= got["score"]["score"] <= 1.0


def test_facade_want_lrc_entries(handlers, tmp_path):
    """want_lrc: each entry carries `lrc` and `alignment_score` and
    time_costs `auto_lrc_time`; an instrumental request carries neither;
    a failing pass leaves `lrc_error` and the request still succeeds."""
    _, th = handlers
    cfg = tinf.GenerationConfig(batch_size=2, output_dir=str(tmp_path),
                                want_lrc=True, use_random_seed=False)
    res = tinf.generate_music(th, None, tinf.GenerationParams(
        caption="sunny pop", lyrics="[verse]\nhello\nworld", duration=1.2,
        seed=4), cfg)
    assert res.success, res.error
    for entry in res.audios:
        assert isinstance(entry["lrc"], str) and "lrc_error" not in entry
        assert set(entry["alignment_score"]) == {
            "score", "coverage", "monotonicity", "confidence"}
    assert res.extra_outputs["time_costs"]["auto_lrc_time"] > 0
    inst = tinf.generate_music(th, None, tinf.GenerationParams(
        caption="drone", instrumental=True, duration=1.2), cfg)
    assert inst.success and "auto_lrc_time" not in \
        inst.extra_outputs["time_costs"]
    assert all("lrc" not in e for e in inst.audios)
    orig = th.generate_lrc
    th.generate_lrc = lambda *a, **k: (_ for _ in ()).throw(
        RuntimeError("capture failed"))
    try:
        bad = tinf.generate_music(th, None, tinf.GenerationParams(
            caption="x", lyrics="la la", duration=1.2), cfg)
    finally:
        th.generate_lrc = orig
    assert bad.success
    assert all(e["lrc_error"] == "capture failed" for e in bad.audios)


_one_thread = pytest.fixture(scope="module")(one_torch_thread)


@pytest.mark.parametrize("dtype,mode,rtol", [
    ("float32", None, 1e-4), ("float32", "w8a8", 1e-4),
    ("bfloat16", None, 2e-2)])
def test_reward_score_equals_jax(_one_thread, dtype, mode, rtol):
    jh = JaxLLM(dtype=getattr(jnp, dtype))
    jh.initialize(num_fallback_codes=32, seed=0)
    th = LLMHandler(dtype=getattr(torch, dtype), device="cpu")
    th.initialize(cfg=port_cfg(jh.cfg), num_fallback_codes=32,
                  params=np_tree(jh.engine.params), quantization=mode)
    if mode:
        jh.initialize(num_fallback_codes=32, seed=0, quantization=mode)
    codes = "".join(f"<|audio_code_{(i * 7) % 32}|>" for i in range(12))
    with highest():
        want = js.calculate_reward_score(jh, codes, caption="energetic rock",
                                         lyrics="hey hey")
        want_lp = js.sequence_logprob(jh.engine.params, jh.cfg,
                                      np.arange(3, 40), 5,
                                      dtype=jh.engine.dtype)
    got = ts.calculate_reward_score(th, codes, caption="energetic rock",
                                    lyrics="hey hey")
    got_lp = ts.sequence_logprob(th.engine.model, th.cfg, np.arange(3, 40),
                                 5, dtype=th.engine.dtype)
    assert got["num_codes"] == want["num_codes"] == 12
    for k in ("cond_logprob", "uncond_logprob"):
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)
    np.testing.assert_allclose(got_lp, want_lp, rtol=rtol)
    np.testing.assert_allclose(got["pmi"], want["pmi"],
                               atol=rtol * abs(want["cond_logprob"]))
    assert 0.0 < got["score"] < 1.0
    same = ts.calculate_reward_score(th, codes, caption="NO USER INPUT")
    assert abs(same["pmi"]) < 1e-3
