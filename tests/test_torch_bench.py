"""bench_torch.py, the port's benchmark program, against bench.py: the
analytic DiT FLOPs (equal to the FLOP), the median helpers, the card peak
table, the JSON line, the matrix's sections, and the headline's
composition (prepare_condition -> ConditionSet.build -> sample_turbo ->
tiled_decode) at DiTConfig.tiny() with the JAX weights carried across and
the same x_init, float32 on the CPU.

Tolerance (tests/test_torch_pipeline.py's): latents 2e-4 absolute (float32
both sides, summation order compounding over the condition encoders and 8
decoder passes); audio 2e-4 plus two int16 steps of its peak (peak /
32767 each).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import bench_torch
from acestep_tpu.config import DiTConfig as JaxDiTConfig
from acestep_tpu.models import dit as jdit
from acestep_tpu.models import sampler as jsam
from acestep_tpu.models import vae as jvae
from acestep_tpu.models.vae_tiled import tiled_decode as jax_tiled_decode
from acestep_torch.config import DiTConfig
from acestep_torch.models import dit as tdit
from acestep_torch.models.vae import OobleckVAE
from acestep_torch.utils.weights import dit_from_jax, vae_from_jax
from torch_parity import (highest, np_tree, port_cfg, randomize_snakes,
                          tiny_dit_cfg, tiny_vae_cfg)

PAYLOAD_KEYS = {"metric", "value", "unit", "vs_baseline", "extra"}


@pytest.mark.parametrize("duration", [10, 30, 60, 600])
@pytest.mark.parametrize("version", ["turbo", "base", "sft"])
def test_dit_flops_equal_jax(version, duration):
    jcfg = getattr(JaxDiTConfig, version)()
    tcfg = getattr(DiTConfig, version)()
    frames = duration * 25
    for batch in (1, 8):
        for steps, cfg_steps in ((8, 0), (50, 50), (50, 0)):
            want = bench.dit_flops(jcfg, frames, bench_torch.COND_LEN, steps,
                                   batch, cfg_steps)
            got = bench_torch.dit_flops(tcfg, frames, bench_torch.COND_LEN,
                                        steps, batch, cfg_steps)
            assert got == want, (batch, steps, cfg_steps)


def test_stats_and_median_run_equal_jax():
    rng = np.random.default_rng(0)
    for n in range(1, 8):
        walls = list(rng.uniform(0.1, 3.0, n))
        assert bench_torch._stats(walls) == bench._stats(walls)
        assert bench_torch._median_run(walls) == bench._median_run(walls)
    tied = [1.0, 2.0, 2.0, 3.0]
    assert bench_torch._median_run(tied) == bench._median_run(tied)


@pytest.mark.parametrize("name, bf16, int8", [
    ("NVIDIA H100 80GB HBM3", 989.4, 1978.9),
    ("NVIDIA H100 PCIe", 756.0, 1513.0),
    ("NVIDIA H100 NVL", 835.0, 1671.0),
    ("NVIDIA A100-SXM4-80GB", None, None),
    (None, None, None),
])
def test_peak_tflops_by_card_name(name, bf16, int8):
    assert bench_torch.peak_tflops(name) == bf16
    assert bench_torch.peak_tflops(name, "int8") == int8


def test_mfu_fields_by_card():
    cfg = DiTConfig.turbo()
    fl = bench_torch.dit_flops(cfg, 1500, bench_torch.COND_LEN, 8, 1)
    h100 = bench_torch._mfu_fields(cfg, 1500, bench_torch.COND_LEN, 8, 1,
                                   0.5, name="NVIDIA H100 80GB HBM3")
    tf = fl / 0.5 / 1e12
    assert h100 == {"dit_tflops": round(fl / 1e12, 2),
                    "dit_tflops_s": round(tf, 1),
                    "mfu_pct": round(100 * tf / 989.4, 1)}
    int8 = bench_torch._mfu_fields(cfg, 1500, bench_torch.COND_LEN, 8, 1,
                                   0.5, dtype="int8",
                                   name="NVIDIA H100 80GB HBM3")
    assert int8["mfu_pct"] == round(100 * tf / 1978.9, 1)
    # a card without a published peak: no share, and the card is named
    other = bench_torch._mfu_fields(cfg, 1500, bench_torch.COND_LEN, 8, 1,
                                    0.5, name="Some GPU")
    assert other["mfu_pct"] is None and other["mfu_card"] == "Some GPU"
    assert other["dit_tflops_s"] == round(tf, 1)
    # off a card: no device rate at all
    cpu = bench_torch._mfu_fields(cfg, 1500, bench_torch.COND_LEN, 8, 1,
                                  0.5, name=None)
    assert cpu["dit_tflops_s"] is None and cpu["mfu_pct"] is None
    assert bench_torch._mfu_fields(cfg, 1500, 577, 8, 1, 0.0) == {}


def test_headline_only_prints_the_line_twice(capsys):
    assert bench_torch.main(["--device", "cpu", "--tiny",
                             "--headline-only"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2
    first, last = (json.loads(x) for x in lines)
    for payload in (first, last):
        assert set(payload) == PAYLOAD_KEYS
        assert payload["metric"] == "seconds_per_song"
        assert payload["unit"] == "s" and payload["value"] > 0
        assert payload["vs_baseline"] == round(2.0 / payload["value"], 3)
        extra = payload["extra"]
        assert extra["device"] == "cpu" and extra["card"] is None
        assert extra["mfu_pct"] is None and extra["dit_tflops"] >= 0
        assert len(extra["headline_spread"]) == 2
        # the launch counters count kernels only, and the CPU runs none
        assert extra["launches"] == {"K1": 0, "K4": 0}
    assert first["value"] == last["value"]


@pytest.mark.parametrize("argv", [["--headline-only"], []])
def test_bench_raises_without_a_card(monkeypatch, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        bench_torch.main(argv)


def test_matrix_sections_equal_jax_under_an_empty_budget(monkeypatch):
    """With no budget left every section is an explicit `skipped
    (budget)` row, and builds nothing: the rows name bench.py's sections,
    in its order."""
    monkeypatch.setattr(bench, "BUDGET_S", 0.0)
    want_rows, want_trunc = [], []
    bench.matrix(want_rows, want_trunc)
    rows, trunc = [], []
    bench_torch.matrix(rows, trunc, bench_torch.Budget(0.0),
                       torch.device("cpu"), "unused", tiny=True)
    assert rows == want_rows and trunc == want_trunc
    assert len(rows) == 16 and all(r["skipped"] == "budget" for r in rows)


def test_docs_from_matrix(tmp_path, monkeypatch):
    """--docs-from-matrix renders every row kind without a device."""
    matrix = tmp_path / "m.json"
    docs = tmp_path / "docs" / "b.md"
    monkeypatch.setattr(bench_torch, "MATRIX_PATH", str(matrix))
    monkeypatch.setattr(bench_torch, "DOCS_PATH", str(docs))
    payload = {"metric": "seconds_per_song", "value": 0.5, "unit": "s",
               "vs_baseline": 4.0,
               "extra": {"headline_spread": [0.4, 0.6],
                         "card": "NVIDIA H100 80GB HBM3, 700.00 W",
                         "launches": {"K1": 192, "K4": 6}}}
    rows = [{"config": "60s_b1", "duration_s": 60, "batch": 1,
             "thinking": False, "wall_s": 0.7, "mfu_pct": 12.5},
            {"config": "lm1.7B_prefix_reuse", "prompt_tokens": 100,
             "reused_tokens": 50, "lm_prefix_reuse_pct": 50.0},
            {"config": "600s_b1", "skipped": "budget"},
            {"config": "base50_600s_b1", "error": "boom"}]
    matrix.write_text(json.dumps({"headline": payload, "rows": rows,
                                  "env": {"d2h_MBps": 900.0}}))
    assert bench_torch.main(["--docs-from-matrix"]) == 0
    text = docs.read_text()
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in text
    assert "| 60s_b1 | 60 | 1 | off | 0.7 |" in text and "12.5" in text
    assert "50.0% of 100 prompt tokens" in text
    assert "SKIPPED (budget)" in text and "FAILED" in text


@pytest.fixture(scope="module")
def song_models():
    cfg, vae_cfg = tiny_dit_cfg(), tiny_vae_cfg()
    jparams = np_tree(jdit.init_dit_params(jax.random.PRNGKey(0), cfg))
    jvae_params = randomize_snakes(
        np_tree(jvae.init_vae_params(jax.random.PRNGKey(1), vae_cfg)), 3)
    tcfg, tvae_cfg = port_cfg(cfg), port_cfg(vae_cfg)
    tmodel = dit_from_jax(jparams, tdit.build_dit(tcfg, "cpu"))
    tvae = vae_from_jax(jvae_params, OobleckVAE(tvae_cfg, device="cpu"))
    return cfg, vae_cfg, jparams, jvae_params, tcfg, tvae_cfg, tmodel, tvae


def test_headline_song_matches_jax(song_models):
    """The headline's composition at tiny width on a 12 s song (300
    frames: two decode windows), the same numpy inputs and x_init on both
    sides."""
    cfg, vae_cfg, jparams, jvae_params, tcfg, tvae_cfg, tmodel, tvae = \
        song_models
    assert bench_torch.headline_configs(True) == (tcfg, tvae_cfg)
    T, C = 300, cfg.audio_acoustic_hidden_dim
    inputs, x_init = bench_torch.headline_inputs(tcfg, T, torch.device("cpu"),
                                                 torch.float32, seed=3)
    np_inputs = {k: v.numpy() for k, v in inputs.items()}
    x_np = x_init.numpy()
    assert x_np.shape == (1, T, C)
    schedule = jsam.build_turbo_schedule(shift=3.0)
    with highest():
        enc, _mask, ctx = jdit.prepare_condition(
            jparams, cfg, **{k: jnp.asarray(v) for k, v in np_inputs.items()})
        cond = jsam.ConditionSet.build(jparams, cfg, enc, ctx)
        want_x0 = jsam.sample_turbo(jparams, cfg, x_init=jnp.asarray(x_np),
                                    schedule=tuple(schedule), cond=cond)
        want_audio = np.asarray(jax_tiled_decode(jvae_params, vae_cfg,
                                                 want_x0))
    with torch.inference_mode():
        x0, audio = bench_torch.song(
            tmodel, tvae, tcfg, tvae_cfg,
            {k: torch.from_numpy(v) for k, v in np_inputs.items()},
            torch.from_numpy(x_np), schedule)
    np.testing.assert_allclose(x0.numpy(), np.asarray(want_x0), atol=2e-4)
    assert audio.shape == want_audio.shape == (1, T * vae_cfg.hop_length, 2)
    lsb = np.abs(want_audio).max() / 32767.0
    np.testing.assert_allclose(audio.numpy(), want_audio,
                               atol=2e-4 + 2 * lsb)
