"""The port's text2music slice end to end against the JAX handler: both get
the same weights (the JAX handler's seeded init, carried across), captions,
lyrics, duration and `initial_noise`; the predicted latents and the decoded
audio must match. Float32 on the CPU, tiny geometry.

Tolerance: latents 2e-4 absolute (float32 both sides, summation order
compounding over condition encoders + 8 decoder passes); audio 2e-4 + two
steps of the int16 + peak transfer grid (peak / 32767 each), since each
side rounds its own float audio to that grid.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acestep_tpu.pipeline.handler import AceStepHandler as JaxHandler
from acestep_torch import inference as tinf
from acestep_torch.pipeline.handler import AceStepHandler
from torch_parity import highest, np_tree, port_cfg, randn, tiny_dit_cfg, tiny_vae_cfg

GEOM = dict(frame_bucket=20, min_frames=20, refer_frames=10)


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


def _compare(jh, th, *, duration, captions, lyrics, seed):
    B = len(captions)
    T = int(duration * 25)
    noise = randn(seed, B, -(-T // 20) * 20, 64)
    kw = dict(audio_duration=duration, seeds=list(range(B)), normalize=False,
              initial_noise=noise, metas={"bpm": 100, "duration": duration})
    with highest():
        want = jh.generate_music(captions, lyrics, **kw)
    got = th.generate_music(captions, lyrics, **kw)
    np.testing.assert_allclose(got.pred_latents, want.pred_latents, atol=2e-4)
    assert got.extra["frames"] == want.extra["frames"] == T
    for a, b in zip(got.audios, want.audios):
        assert a.shape == b.shape == (T * 8, 2)
        lsb = np.abs(b).max() / 32767.0
        np.testing.assert_allclose(a, b, atol=2e-4 + 2 * lsb)
    return got


def test_text2music_matches_jax_handler(handlers):
    jh, th = handlers
    got = _compare(jh, th, duration=1.6, captions=["an upbeat synthpop song",
                                                  "slow piano ballad"],
                   lyrics=["la la la", "[verse]\nhello"], seed=1)
    assert all(np.isfinite(a).all() and np.abs(a).max() > 0 for a in got.audios)
    assert set(got.time_costs) >= {"diffusion_time_cost", "vae_decode_time_cost",
                                   "total_time_cost"}


def test_long_song_decodes_in_segments_and_matches(handlers):
    """T = 800 frames > 768: decode_latents splits the song into two
    margin-padded segments on both sides, each a tiled decode."""
    jh, th = handlers
    calls = []
    orig = th._decode_segmented
    th._decode_segmented = lambda z, segs: calls.append(segs) or orig(z, segs)
    try:
        _compare(jh, th, duration=32.0, captions=["long ambient drone"],
                 lyrics=["[inst]"], seed=2)
    finally:
        th._decode_segmented = orig
    assert calls == [2]


def test_seeded_noise_is_deterministic(handlers):
    _, th = handlers
    kw = dict(audio_duration=0.8, normalize=False)
    a = th.generate_music("song", "x", seeds=5, **kw)
    b = th.generate_music("song", "x", seeds=5, **kw)
    c = th.generate_music("song", "x", seeds=6, **kw)
    np.testing.assert_array_equal(a.pred_latents, b.pred_latents)
    assert not np.allclose(a.pred_latents, c.pred_latents)


@pytest.mark.parametrize("kwargs", [
    dict(src_audio=np.zeros((16, 2), np.float32)),
    dict(refer_audios=np.zeros((16, 2), np.float32)),
    dict(audio_code_hints="<|audio_code_5|>"),
    dict(repainting_start=0.0),
    dict(audio_cover_strength=0.5),
    dict(task="cover"),
])
def test_later_slices_raise_not_implemented(handlers, kwargs):
    _, th = handlers
    with pytest.raises(NotImplementedError):
        th.generate_music("song", "x", audio_duration=0.8, **kwargs)


def test_facade_generate_music(handlers, tmp_path):
    _, th = handlers
    params = tinf.GenerationParams(caption="lofi beat", lyrics="", instrumental=True,
                                   duration=1.2, seed=11, thinking=False)
    res = tinf.generate_music(th, None, params, tinf.GenerationConfig(
        batch_size=2, output_dir=str(tmp_path)))
    assert res.success, res.error
    assert len(res.audios) == 2 and res.audios[0]["seed"] == 11
    for entry in res.audios:
        # 30 frames pad to the 20-frame bucket (40); the crop to
        # frames * 1920 samples only bites at the real hop
        assert entry["audio"].shape == (40 * 8, 2)
        assert entry["path"].endswith(".wav") and entry["params_path"]
    bad = tinf.generate_music(th, None, tinf.GenerationParams(
        caption="x", duration=1.0, audio_codes="<|audio_code_1|>"),
        tinf.GenerationConfig(batch_size=1, output_dir=str(tmp_path)))
    assert not bad.success and "not ported" in bad.error


def test_cuda_is_the_default_device():
    """Without a GPU, a handler that does not ask for the CPU raises."""
    code = ("import torch, sys\n"
            "from acestep_torch.pipeline.handler import AceStepHandler\n"
            "if torch.cuda.is_available(): sys.exit(0)\n"
            "try:\n    AceStepHandler()\nexcept RuntimeError:\n    sys.exit(0)\n"
            "sys.exit(1)\n")
    root = Path(__file__).resolve().parents[1]
    assert subprocess.run([sys.executable, "-c", code], cwd=root,
                          timeout=120).returncode == 0
