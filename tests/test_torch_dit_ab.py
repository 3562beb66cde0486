"""The decoder's `attention_impl` choice in the port (the plain masked
"dense" attention against the flash path's) held against the JAX
package's "dense" decoder, and scripts/profile_dit_ab_torch.py, the A/B of
the two, at DiTConfig.tiny(), float32 on the CPU, JAX weights carried
across by acestep_torch/utils/weights.py.

Tolerances: the decoder 1e-4 absolute (tests/test_torch_dit.py's: float32
both sides, summation order compounding through the layers); the A/B's
latents 2e-4 absolute (tests/test_torch_pipeline.py's, over the condition
encoders and 8 decoder passes).
"""

import dataclasses
import importlib.util
import json
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_torch
from acestep_tpu.models import dit as jdit
from acestep_torch.models import dit as tdit
from acestep_torch.models.sampler import build_turbo_schedule
from acestep_torch.ops import flash_attention as fa
from acestep_torch.utils.weights import dit_from_jax
from torch_parity import (assert_close, highest, np_tree, port_cfg, randn, t,
                          tiny_dit_cfg)

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-4


def _load_ab():
    spec = importlib.util.spec_from_file_location(
        "profile_dit_ab_torch", ROOT / "scripts" / "profile_dit_ab_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ab = _load_ab()


@pytest.fixture(scope="module")
def models():
    cfg = tiny_dit_cfg()
    jparams = np_tree(jdit.init_dit_params(jax.random.PRNGKey(0), cfg))
    tmodel = dit_from_jax(jparams, tdit.build_dit(port_cfg(cfg), "cpu"))
    return cfg, jparams, tmodel


def _decoder_inputs(B=2, T=60):
    """L = 30 patches > the window of 8: banded layers differ from full
    ones, so a wrong band (or none) shows."""
    return (randn(3, B, 12, 64), randn(4, B, T, 64), randn(5, B, T, 128),
            np.array([0.7, 0.3][:B], np.float32))


@pytest.mark.parametrize("impl", ["dense", "flash", "auto"])
def test_decoder_matches_jax_dense(models, impl):
    """Every port impl against JAX's "dense" decoder (JAX's flash path is
    the TPU kernel); the port's "dense" is the plain masked attention."""
    cfg, jparams, tmodel = models
    jcfg = dataclasses.replace(cfg, attention_impl="dense")
    tcfg = port_cfg(dataclasses.replace(cfg, attention_impl=impl))
    enc, xt, ctx, ts = _decoder_inputs()
    with highest():
        want = jdit.dit_decoder(jparams, jcfg, jnp.asarray(xt),
                                jnp.asarray(ts), jnp.asarray(ts),
                                jnp.asarray(ctx),
                                encoder_hidden_states=jnp.asarray(enc))
    got = tdit.dit_decoder(tmodel, tcfg, t(xt), t(ts), t(ts), t(ctx),
                           encoder_hidden_states=t(enc))
    assert_close(got, want, atol=ATOL, what=impl)


def test_dense_takes_the_plain_attention(models, monkeypatch):
    """Only "dense" leaves the flash path: with the flash function
    refusing, "dense" still runs, and "auto" / "flash" reach it."""
    cfg, _, tmodel = models
    calls = []

    def refuse(q, k, v, window=None):
        calls.append(window)
        raise RuntimeError("flash path taken")

    monkeypatch.setattr(fa, "flash_attention", refuse)
    enc, xt, ctx, ts = _decoder_inputs(B=1)
    args = (t(xt), t(ts), t(ts), t(ctx))
    dense = port_cfg(dataclasses.replace(cfg, attention_impl="dense"))
    out = tdit.dit_decoder(tmodel, dense, *args, encoder_hidden_states=t(enc))
    assert out.shape == xt.shape and not calls
    for impl in ("auto", "flash"):
        tcfg = port_cfg(dataclasses.replace(cfg, attention_impl=impl))
        with pytest.raises(RuntimeError, match="flash path taken"):
            tdit.dit_decoder(tmodel, tcfg, *args,
                             encoder_hidden_states=t(enc))
    assert calls == [cfg.sliding_window] * 2   # layer 0 is banded


def test_unknown_attention_impl_raises(models):
    cfg, _, tmodel = models
    tcfg = port_cfg(dataclasses.replace(cfg, attention_impl="sdpa"))
    enc, xt, ctx, ts = _decoder_inputs(B=1)
    with pytest.raises(ValueError, match="attention_impl 'sdpa'"):
        tdit.dit_decoder(tmodel, tcfg, t(xt), t(ts), t(ts), t(ctx),
                         encoder_hidden_states=t(enc))


def test_dense_capture_pass_matches_flash(models):
    """The LRC capture pass takes the same choice of self-attention."""
    cfg, _, tmodel = models
    enc, xt, ctx, ts = _decoder_inputs(B=1)
    got = {}
    for impl in ("dense", "flash"):
        tcfg = port_cfg(dataclasses.replace(cfg, attention_impl=impl))
        got[impl] = tdit.dit_decoder_attn_capture(
            tmodel, tcfg, t(xt), t(ts), t(ts), t(ctx), t(enc),
            capture={1: [0, 1]})[1]
    assert_close(got["dense"], got["flash"].numpy(), atol=ATOL)


def test_ab_script_prints_both_variants(capsys, monkeypatch, tmp_path):
    monkeypatch.setattr(ab, "REPEATS", 2)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert ab.main(["--device", "cpu", "--tiny", "--geo", "60",
                    "--trace"]) == 0
    rows = [json.loads(x) for x in
            capsys.readouterr().out.strip().splitlines()]
    variants, best = rows[:-1], rows[-1]
    assert [r["variant"] for r in variants] == ["60s impl=dense",
                                                "60s impl=flash"]
    steps = [f"step{i}" for i in range(8)]
    for r in variants:
        assert r["T"] == 1500 and r["device"] == "cpu"
        assert list(r["stages"]) == ["condition", "cross_kv", *steps,
                                     "decode"]
        assert len(r["spread"]) == 2 and r["median_s"] > 0
    assert best["best"] in {r["variant"] for r in variants}
    assert (tmp_path / "dit_trace" / "trace.json").is_file()


def test_ab_variants_agree_and_equal_the_headline_song():
    """Dense and flash latents agree, and the A/B's stage-by-stage steps
    are the headline composition's sample_turbo."""
    device = torch.device("cpu")
    base, _ = bench_torch.headline_configs(True)
    T = 300
    x0s = {}
    for impl in ("dense", "flash"):
        cfg = dataclasses.replace(base, attention_impl=impl)
        model, vae, vae_cfg, inputs, x_init = ab.build(cfg, T, device, True)
        x0s[impl], audio, stages = ab.trajectory(model, vae, cfg, vae_cfg,
                                                 inputs, x_init, device)
        assert audio.shape == (1, T * vae_cfg.hop_length, 2)
        assert len(stages) == 11
    np.testing.assert_allclose(x0s["dense"].numpy(), x0s["flash"].numpy(),
                               atol=2e-4)
    with torch.inference_mode():
        want, _ = bench_torch.song(model, vae, cfg, vae_cfg, inputs, x_init,
                                   build_turbo_schedule(shift=3.0))
    torch.testing.assert_close(x0s["flash"], want, rtol=0, atol=0)


def test_ab_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        ab.main(["--geo", "60"])
