"""The port's handler against `acestep_tpu.pipeline.handler.AceStepHandler`
on every task of the slice: cover from source audio and from code hints,
per-row repaint, outpaint, the track modes (extract, lego, complete: the
source in context without the cover flag), timbre references, partial
cover strength,
cover noise, the base model (APG) and the sft model (custom timesteps,
ADG), and `audio_to_codes`. Both handlers get the same weights (the JAX
handler's seeded init, carried across), requests and `initial_noise`.
Float32 on the CPU, tiny geometry, one frame geometry (40 frames) for the
whole file.

Tolerances: latents 2e-4 absolute (float32 both sides, summation order
compounding over the VAE encoder, the condition encoders and the decoder
passes); audio 2e-4 + two steps of the int16 + peak transfer grid, as in
test_torch_pipeline.py. Spans, cover flags, frame counts, schedules,
instruction texts and code strings must be equal exactly.

The timbre reference's 30 s budget is cut for the test: both handlers'
`_sample_reference_segments` run at a sample rate of 160 Hz, so the
head / middle / tail windows and the looping of a short reference are
exercised on a few thousand samples.
"""

import dataclasses
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acestep_tpu.pipeline import handler as jhandler
from acestep_tpu.pipeline.handler import AceStepHandler as JaxHandler
from acestep_tpu.utils.memory import is_oom_error as jax_is_oom
from acestep_torch.pipeline import handler as thandler
from acestep_torch.pipeline.handler import AceStepHandler
from acestep_torch.utils.memory import is_oom_error
from torch_parity import highest, np_tree, port_cfg, randn, tiny_dit_cfg, tiny_vae_cfg

GEOM = dict(frame_bucket=20, min_frames=20, refer_frames=10)
T = 40                       # latent frames of every request here
HOP = 8                      # the tiny VAE's hop
REF_SR = 160                 # the reference budget's sample rate in tests


def _pair(version, base=None):
    cfg = dataclasses.replace(tiny_dit_cfg(), model_version=version)
    jh = JaxHandler(dit_config=cfg, vae_config=tiny_vae_cfg(),
                    dtype=jnp.float32, **GEOM)
    if base is None:
        jh.initialize_service(seed=0)
    else:
        jh.initialize_service(seed=0, vae_params=base.vae_params)
    th = AceStepHandler(port_cfg(cfg), port_cfg(tiny_vae_cfg()),
                        dtype=torch.float32, device="cpu", **GEOM)
    th.initialize_service(params=np_tree(jh.params),
                          vae_params=np_tree(jh.vae_params))
    return jh, th


@pytest.fixture(scope="module")
def turbo():
    return _pair("turbo")


def _song(frames, seed, amp=0.5):
    g = np.random.default_rng(seed)
    n = frames * HOP
    tt = np.arange(n) / 40.0
    tone = np.sin(2 * np.pi * g.uniform(0.5, 3.0) * tt)[:, None]
    return (amp * tone + 0.1 * g.standard_normal((n, 2))).astype(np.float32)


SRC = _song(T, 1)


def _sampled_refs(fn):
    orig_j, orig_t = (JaxHandler._sample_reference_segments,
                      AceStepHandler._sample_reference_segments)
    with mock.patch.object(JaxHandler, "_sample_reference_segments",
                           staticmethod(lambda a: orig_j(a, sr=REF_SR))), \
            mock.patch.object(AceStepHandler, "_sample_reference_segments",
                              staticmethod(lambda a: orig_t(a, sr=REF_SR))):
        return fn()


def _compare(jh, th, *, B=2, seed=0, frames=T, **kw):
    kw = dict(seeds=list(range(B)), normalize=False,
              initial_noise=randn(seed, B, frames, 64), batch_size=B, **kw)
    kw.setdefault("captions", ["a cover of the song", "another take"][:B])
    with highest():
        want = _sampled_refs(lambda: jh.generate_music(**kw))
    got = _sampled_refs(lambda: th.generate_music(**kw))
    np.testing.assert_allclose(got.pred_latents, want.pred_latents, atol=2e-4)
    for key in ("spans", "is_covers", "frames", "schedule", "task"):
        assert got.extra[key] == want.extra[key], key
    for a, b in zip(got.audios, want.audios):
        assert a.shape == b.shape
        lsb = np.abs(b).max() / 32767.0
        np.testing.assert_allclose(a, b, atol=2e-4 + 2 * lsb)
    assert all(np.isfinite(a).all() and np.abs(a).max() > 0
               for a in got.audios)
    return got


def test_cover_from_source_audio(turbo):
    got = _compare(*turbo, task="cover", src_audio=SRC)
    assert got.extra["is_covers"] == [True, True]
    assert got.extra["frames"] == T


def test_cover_from_code_hints_mixed_batch(turbo):
    """text2music with valid codes becomes a cover; the hint-less row's
    frames take the silence latent."""
    codes = "".join(f"<|audio_code_{c}|>" for c in (5, 999, 63999, 70000,
                                                    12, 4096, 31, 0))
    got = _compare(*turbo, audio_code_hints=[codes, None])
    assert got.extra["task"] == "cover"
    assert got.extra["frames"] == 8 * 5


def test_repaint_per_row(turbo):
    got = _compare(*turbo, task="repaint", src_audio=SRC,
                   repainting_start=[0.2, None], repainting_end=[0.8, 1.2])
    assert got.extra["spans"] == [("repainting", 5, 20),
                                  ("repainting", 0, 30)]


def test_outpaint_both_sides(turbo):
    """Row 0 extends 0.4 s left and right of the 1.6 s source; row 1
    repaints 0.2-0.6 s of the source and must not repaint the padding."""
    got = _compare(*turbo, task="repaint", src_audio=SRC,
                   repainting_start=[-0.4, 0.2], repainting_end=[2.0, None])
    # 10 frames left; (2.0 - 1.6) * 25 = 9.999... -> 9 frames right
    assert got.extra["frames"] == T + 10 + 9
    assert got.extra["spans"] == [("repainting", 0, 60),
                                  ("repainting", 15, 50)]


def _instructions(module):
    """Patch `module.textlib.resolve_instruction` to record what it
    returns: (patch, list of texts)."""
    seen = []
    real = module.textlib.resolve_instruction

    def spy(*a, **kw):
        seen.append(real(*a, **kw))
        return seen[-1]

    return mock.patch.object(module.textlib, "resolve_instruction", spy), seen


@pytest.mark.parametrize("task,kw,spans", [
    ("extract", dict(track_name="vocals"), [("full", 0, T)] * 2),
    ("lego", dict(track_name="drums", repainting_start=0.2,
                  repainting_end=0.8), [("repainting", 5, 20)] * 2),
    ("complete", dict(track_classes=["drums", "bass"]), [("full", 0, T)] * 2),
])
def test_track_modes(turbo, task, kw, spans):
    """extract / lego / complete put the source latents in context with
    the cover flag off: a full span for extract and complete, the
    repaint span for lego; the instruction names the tracks."""
    jpatch, jtexts = _instructions(jhandler)
    tpatch, ttexts = _instructions(thandler)
    with jpatch, tpatch:
        got = _compare(*turbo, task=task, src_audio=SRC, **kw)
    assert got.extra["task"] == task
    assert got.extra["is_covers"] == [False, False]
    assert got.extra["spans"] == spans and got.extra["frames"] == T
    assert ttexts == jtexts and ttexts
    names = [kw["track_name"]] if "track_name" in kw else kw["track_classes"]
    assert all(n.upper() in ttexts[0] for n in names)


def test_timbre_reference_and_looping_short_reference(turbo):
    long_ref = _song(800, 2)        # 6400 samples > the 4800 budget
    short_ref = _song(20, 3)        # 160 samples: loops to the budget
    _compare(*turbo, captions=["with a reference", "short reference"],
             refer_audios=[long_ref, short_ref], audio_duration=1.6)


def test_partial_cover_strength(turbo):
    got = _compare(*turbo, task="cover", src_audio=SRC,
                   audio_cover_strength=0.5)
    assert len(got.extra["schedule"]) == 8


def test_cover_noise_strength(turbo):
    got = _compare(*turbo, task="cover", src_audio=SRC,
                   cover_noise_strength=0.4)
    assert got.extra["schedule"][0] < 1.0


@pytest.fixture(scope="module")
def base(turbo):
    return _pair("base", turbo[0])


@pytest.fixture(scope="module")
def sft(turbo):
    return _pair("sft", turbo[0])


def test_base_text2music_apg(base):
    got = _compare(*base, captions=["guided", "guided two"], lyrics="la",
                   audio_duration=1.6, infer_steps=4, guidance_scale=5.0)
    assert len(got.extra["schedule"]) == 5


def test_sft_custom_timesteps_adg(sft):
    got = _compare(*sft, captions=["sft"], B=1, audio_duration=1.6,
                   timesteps=[1.0, 0.8, 0.45, 0.2], use_adg=True,
                   guidance_scale=4.0, cfg_interval=(0.1, 0.9))
    assert got.extra["schedule"] == [1.0, 0.8, 0.45, 0.2, 0.0]


def test_audio_to_codes_equal(turbo):
    jh, th = turbo
    with highest():
        want = jh.audio_to_codes(SRC[:37 * HOP])      # pads to the window
    got = th.audio_to_codes(SRC[:37 * HOP])
    assert got == want and got.count("<|audio_code_") == 8


def test_silent_reference_raises(turbo):
    _, th = turbo
    with pytest.raises(ValueError, match="silent"):
        th.generate_music("x", audio_duration=1.6,
                          refer_audios=np.zeros((800, 2), np.float32))


def test_invalid_hint_is_ignored(turbo):
    _, th = turbo
    kw = dict(audio_duration=1.6, seeds=3, normalize=False)
    a = th.generate_music("song", audio_code_hints="not a code", **kw)
    b = th.generate_music("song", **kw)
    assert a.extra["task"] == "text2music" and a.extra["is_covers"] == [False]
    np.testing.assert_array_equal(a.pred_latents, b.pred_latents)


@pytest.mark.parametrize("hint", [
    None, "", "   ", [], "junk", "<|audio_code_3|><|audio_code_70000|>",
    [1, -5, 64001], (7,)])
def test_parse_code_hint_matches_jax(hint):
    want = JaxHandler._parse_code_hint(hint)
    got = AceStepHandler._parse_code_hint(hint)
    if want is None:
        assert got is None
    else:
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("seconds", [0.5, 12.0, 30.0, 41.3])
def test_reference_segments_match_jax(seconds):
    audio = randn(int(seconds), int(seconds * 48000), 2)
    want = JaxHandler._sample_reference_segments(audio)
    got = AceStepHandler._sample_reference_segments(audio)
    assert got.shape == want.shape == (30 * 48000, 2)
    assert np.array_equal(got, want)


def _oom():
    return torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                       "allocate 2.00 GiB")


@pytest.mark.parametrize("stage", ["encode", "decode"])
def test_oom_ladder_halves_and_retries(turbo, stage):
    _, th = turbo
    name = "tiled_encode" if stage == "encode" else "tiled_decode"
    real = getattr(thandler, name)
    plans = []

    def flaky(*a, chunk_size, parallel_windows, **kw):
        plans.append((chunk_size, parallel_windows))
        if len(plans) <= 2:
            raise _oom()
        return real(*a, chunk_size=chunk_size,
                    parallel_windows=parallel_windows, **kw)

    def run():
        if stage == "encode":
            return th.encode_audio(SRC)
        return th.decode_latents(randn(4, 1, T, 64))

    want = run()
    with mock.patch.object(thandler, name, flaky):
        got = run()
    np.testing.assert_array_equal(got, want)
    c, g = plans[0]
    assert plans == [(c, g), (c, g // 2), (c, g // 4)]


@pytest.mark.parametrize("stage", ["encode", "decode"])
def test_non_oom_error_reraises(turbo, stage):
    _, th = turbo
    name = "tiled_encode" if stage == "encode" else "tiled_decode"
    calls = []

    def broken(*a, **kw):
        calls.append(1)
        raise RuntimeError("cuDNN error: CUDNN_STATUS_BAD_PARAM")

    with mock.patch.object(thandler, name, broken), \
            pytest.raises(RuntimeError, match="BAD_PARAM"):
        if stage == "encode":
            th.encode_audio(SRC)
        else:
            th.decode_latents(randn(4, 1, T, 64))
    assert calls == [1]


def test_oom_ladder_gives_up_at_its_floor(turbo):
    _, th = turbo
    plans = []

    def always(*a, chunk_size, parallel_windows, **kw):
        plans.append((chunk_size, parallel_windows))
        raise _oom()

    with mock.patch.object(thandler, "tiled_encode", always), \
            pytest.raises(torch.cuda.OutOfMemoryError):
        th.encode_audio(SRC)
    assert plans[-1] == (64, 1) and len(plans) > 4


@pytest.mark.parametrize("msg", [
    "RESOURCE_EXHAUSTED: Out of memory while trying to allocate",
    "CUDA out of memory. Tried to allocate 2.00 GiB",
    "OOM when allocating tensor", "cuDNN error: CUDNN_STATUS_BAD_PARAM",
    "resource exhausted"])
def test_oom_matching_matches_jax(msg):
    assert is_oom_error(RuntimeError(msg)) == jax_is_oom(RuntimeError(msg))
    # CUDA's own class is matched whatever its message
    assert is_oom_error(torch.cuda.OutOfMemoryError("allocation failed"))
