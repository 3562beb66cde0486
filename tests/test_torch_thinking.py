"""`generate_music(thinking=True)` end to end, the port against the JAX
facade: the LM planner writes the CoT metadata and the audio codes, the
codes feed the code-hint render, the VAE decodes. Both stacks hold the same
weights (the JAX seeded inits carried across) and the render gets the same
`initial_noise` (the seam: each handler's `generate_music` is wrapped to
pass it). The planner decodes greedily (lm_temperature 0), float32 on the
CPU, tiny geometry.

Tolerances: the LM metadata and the audio-code strings must be EQUAL
(greedy over logits that agree to ~1e-6); latents 2e-4 absolute and audio
2e-4 + two int16 steps, as in test_torch_pipeline.py. The other planner
modes of the facade (analyze / understand / create / format) must give
equal results.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acestep_tpu import inference as jinf
from acestep_tpu.llm.handler import LLMHandler as JaxLLM
from acestep_tpu.pipeline.handler import AceStepHandler as JaxHandler
from acestep_torch import inference as tinf
from acestep_torch.llm.handler import LLMHandler
from acestep_torch.pipeline.handler import AceStepHandler
from torch_parity import (
    capped, highest, np_tree, one_torch_thread, port_cfg, randn, tiny_dit_cfg,
    tiny_vae_cfg,
)

GEOM = dict(frame_bucket=20, min_frames=20, refer_frames=10)


_one_thread = pytest.fixture(scope="module", autouse=True)(
    one_torch_thread)


@pytest.fixture(scope="module")
def stacks():
    jd = JaxHandler(dit_config=tiny_dit_cfg(), vae_config=tiny_vae_cfg(),
                    dtype=jnp.float32, **GEOM)
    jd.initialize_service(seed=0)
    td = AceStepHandler(port_cfg(tiny_dit_cfg()), port_cfg(tiny_vae_cfg()),
                        dtype=torch.float32, device="cpu", **GEOM)
    td.initialize_service(params=np_tree(jd.params),
                          vae_params=np_tree(jd.vae_params))
    jl = JaxLLM(dtype=jnp.float32)
    jl.initialize(num_fallback_codes=32, max_duration=600, seed=0)
    tl = LLMHandler(dtype=torch.float32, device="cpu")
    tl.initialize(cfg=port_cfg(jl.cfg), num_fallback_codes=32,
                  max_duration=600, params=np_tree(jl.engine.params))
    return (jd, jl), (td, tl)


def _run(facade, dit, llm, params, config, noise):
    """The facade's result and the handler results it rendered from."""
    seen = []
    orig = dit.generate_music

    def with_noise(*a, **kw):
        kw["initial_noise"] = noise
        seen.append(orig(*a, **kw))
        return seen[-1]

    with mock.patch.object(dit, "generate_music", with_noise):
        res = facade.generate_music(dit, llm, params, config)
    assert res.success, res.error
    return res, seen[0]


@pytest.mark.parametrize("batch", [1, 2])
def test_thinking_text2music_matches_jax(stacks, tmp_path, batch):
    """batch 1: one plan (CoT + codes) for the request; batch 2 with
    allow_lm_batch: one batched plan, per-item codes."""
    (jd, jl), (td, tl) = stacks
    params = dict(caption="lofi hip hop with warm keys", lyrics="[verse]\nhi",
                  duration=2.0, seed=7, thinking=True, lm_temperature=0.0)
    noise = randn(3, batch, 60, 64)

    def config(sub):
        return dict(batch_size=batch, allow_lm_batch=batch > 1,
                    output_dir=str(tmp_path / sub), audio_format="wav")

    with highest():
        want, want_r = _run(jinf, jd, jl, jinf.GenerationParams(**params),
                            jinf.GenerationConfig(**config("j")), noise)
    got, got_r = _run(tinf, td, tl, tinf.GenerationParams(**params),
                      tinf.GenerationConfig(**config("t")), noise)
    go, wo = got.extra_outputs, want.extra_outputs
    assert go["lm_metadata"] == wo["lm_metadata"]
    assert go["audio_codes"] == wo["audio_codes"]
    codes = go["audio_codes"] if batch > 1 else [go["audio_codes"]]
    assert len(codes) == batch
    # 5 Hz codes over the planned duration (the schema's floor is 10 s)
    n = 5 * int(go["lm_metadata"]["duration"])
    assert all(c.count("<|audio_code_") == n for c in codes)
    assert "lm_time_cost" in go["time_costs"]
    assert got_r.extra["task"] == want_r.extra["task"] == "cover"
    np.testing.assert_allclose(got_r.pred_latents, want_r.pred_latents,
                               atol=2e-4)
    for a, b in zip(got_r.audios, want_r.audios):
        lsb = np.abs(b).max() / 32767.0
        np.testing.assert_allclose(a, b, atol=2e-4 + 2 * lsb)
    assert all(np.isfinite(a).all() for a in got_r.audios)


def test_planner_modes_of_the_facade_match_jax(stacks):
    """analyze_input in full; understand / create / format with the
    engines' decode budgets capped alike (torch_parity.capped)."""
    (_, jl), (_, tl) = stacks
    params = dict(caption="sad piano", lyrics="", seed=3, lm_temperature=0.0,
                  bpm=80)

    def run(inf, llm):
        out = [inf.analyze_input(llm, inf.GenerationParams(**params))]
        with capped(llm):
            out += [inf.understand_music(llm, "<|audio_code_3|>" * 12,
                                         temperature=0.0).to_dict(),
                    inf.create_sample(llm, "calm", temperature=0.0),
                    inf.format_sample(llm, "rock", "la", temperature=0.0)]
        return out

    with highest():
        want = run(jinf, jl)
    got = run(tinf, tl)
    assert got == want
    assert got[0]["success"] and got[0]["metadata"]["bpm"] == 80
    assert tinf.analyze_input(None, tinf.GenerationParams())["success"] is False
