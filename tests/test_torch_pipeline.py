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
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acestep_tpu.pipeline.handler import AceStepHandler as JaxHandler
from acestep_torch import inference as tinf
from acestep_torch.llm.handler import LLMHandler
from acestep_torch.pipeline.handler import AceStepHandler
from torch_mesh_helpers import cpu_world
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


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """4 CPU ranks (gloo) for the mesh cases, started on first use."""
    yield from cpu_world(tmp_path_factory.mktemp("mesh"))


def _jax_planner(**kw):
    from acestep_tpu.llm.handler import LLMHandler as JaxLLM

    jh = JaxLLM(dtype=jnp.float32)
    jh.initialize(seed=0, **kw)
    return jh


def _greedy_codes(engine):
    return engine.generate_codes(["make music"], n_codes=10, seed=5,
                                 temperature=0.0)


def _tiny_for_size(cls, size, audio_vocab=64_000):
    """LMConfig.for_size at the tiny test geometry (same vocabulary)."""
    from acestep_torch.llm.tokenizer import SimpleTokenizer

    return cls.tiny(vocab_size=SimpleTokenizer(
        num_audio_codes=audio_vocab).vocab_size)


@pytest.mark.parametrize("kwargs", [
    dict(lm_tensor_parallel=2, lm_quantization="w8a8"),
    dict(mesh=True),
    dict(auto_tensor_parallel=2),
    dict(engine_mesh=True),
    dict(lm_tensor_parallel=2),
    dict(lm_tensor_parallel=4, lm_quantization="int4"),
])
def test_later_slices_raise_not_implemented(handlers, kwargs, world):
    """What these cases once showed raising NotImplementedError now runs
    and is held to JAX: the tensor-parallel planner (plain, w8a8, int4 at
    tp=4), the engine's `mesh=`, `initialize_auto(tensor_parallel=)` and
    the DiT handler's `enable_mesh`. Planners decode greedily (their ids
    must equal JAX's tp=1 ids from the same weights; under
    `initialize_auto` the ids of JAX's `initialize_auto` engine at the
    same tp, whose weights the port's takes); the DiT renders under tp=2
    with JAX's `initial_noise` and must match JAX's latents."""
    from acestep_torch.llm.generator import LMEngine
    from acestep_torch.parallel import make_mesh

    jh, th = handlers
    if "mesh" in kwargs:
        T = 20
        noise = randn(4, 1, T, 64)
        kw = dict(audio_duration=0.8, seeds=[3], normalize=False,
                  initial_noise=noise)
        with highest():
            want = jh.generate_music("tp song", "la", **kw)
        th.enable_mesh(dp=1, tp=2)
        try:
            got = th.generate_music("tp song", "la", **kw)
        finally:
            th.release_mesh()
        np.testing.assert_allclose(got.pred_latents, want.pred_latents,
                                   rtol=2e-4, atol=2e-4)
    elif "auto_tensor_parallel" in kwargs:
        from acestep_tpu.config import LMConfig as JaxLMConfig
        from acestep_tpu.llm.handler import LLMHandler as JaxLLM
        from acestep_torch.config import LMConfig

        tp = kwargs["auto_tensor_parallel"]
        jauto = JaxLLM(dtype=jnp.float32)
        init = LLMHandler.initialize

        def with_jax_weights(self, **kw):
            # the JAX engine's seeded weights in place of the port's draw
            return init(self, params=np_tree(jauto.engine.params), **kw)

        with mock.patch.object(LMConfig, "for_size",
                               classmethod(_tiny_for_size)), \
                mock.patch.object(JaxLMConfig, "for_size",
                                  classmethod(_tiny_for_size)):
            want = jauto.initialize_auto(size="0.6B", tensor_parallel=tp)
            with mock.patch.object(LLMHandler, "initialize",
                                   with_jax_weights):
                one = LLMHandler(dtype=torch.float32, device="cpu")
                one.initialize_auto(size="0.6B")
                got = LLMHandler(dtype=torch.float32, device="cpu")
                picked = got.initialize_auto(size="0.6B", tensor_parallel=tp)
        try:
            assert picked == want
            assert got.engine.mesh.tp == tp
            with highest():
                codes = _greedy_codes(jauto.engine)
            assert _greedy_codes(got.engine) == _greedy_codes(one.engine) \
                == codes
        finally:
            got.release()
    else:
        mode = kwargs.get("lm_quantization")
        codes = 65 if mode == "w8a8" else 64
        jlm = _jax_planner(num_fallback_codes=codes, quantization=mode)
        plain = _jax_planner(num_fallback_codes=codes) if mode else jlm
        llm = LLMHandler(dtype=torch.float32, device="cpu")
        tp = kwargs.get("lm_tensor_parallel", 2)
        with highest():
            want = _greedy_codes(jlm.engine)
        if "engine_mesh" in kwargs:
            llm.initialize(cfg=port_cfg(jlm.cfg), num_fallback_codes=codes,
                           params=np_tree(plain.engine.params))
            mesh = make_mesh(1, tp)
            try:
                engine = LMEngine(llm.engine.model, llm.cfg, llm.tokenizer,
                                  dtype=torch.float32, mesh=mesh)
                assert _greedy_codes(engine) == want
            finally:
                mesh.close()
            return
        llm.initialize(cfg=port_cfg(jlm.cfg), num_fallback_codes=codes,
                       params=np_tree(plain.engine.params), quantization=mode,
                       tensor_parallel=tp)
        try:
            assert llm.engine.mesh.tp == tp
            assert _greedy_codes(llm.engine) == want
        finally:
            llm.release()


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
        assert entry["path"].endswith(".flac") and entry["params_path"]
    # code hints turn a text2music request into a cover
    cover = tinf.generate_music(th, None, tinf.GenerationParams(
        caption="x", duration=1.0, audio_codes="<|audio_code_1|>"),
        tinf.GenerationConfig(batch_size=1, output_dir=str(tmp_path)))
    assert cover.success, cover.error
    assert cover.extra_outputs["task"] == "cover"


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
