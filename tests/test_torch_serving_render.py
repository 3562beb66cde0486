"""`generate_music_group` (the serving queue's fused render) of the port
against the JAX package's: 3 jobs with pinned seeds through tiny real
handlers on the CPU, the port's carrying the JAX handler's seeded weights.
The RNGs differ, so both handlers get the same numpy noise through their
`initial_noise` seam (each handler's `generate_music` is wrapped). Then,
port only: each fused item equals a solo render of its seed.

Tolerance (test_torch_pipeline.py's): latents 2e-4 absolute (float32 on
both sides, summation order through the condition encoders and 8 decoder
passes); audio 2e-4 + two steps of the int16 + peak transfer grid.
Metadata, seeds, result keys and the `time_costs` keys are equal exactly.
"""

import numpy as np
import pytest

from acestep_tpu import inference as jinf
from acestep_torch import inference as tinf
from test_torch_pipeline import handlers  # noqa: F401 — the shared fixture
from torch_parity import highest, randn

DURATION = 1.6
T = 40                       # 1.6 s = 40 frames, on the 20-frame bucket
JOBS = [
    dict(caption="an upbeat synthpop song", lyrics="la la la", seed=3,
         bpm=100),
    dict(caption="slow piano ballad", lyrics="[verse]\nhello", seed=4,
         keyscale="C major", vocal_language="fr"),
    dict(caption="lofi beat", lyrics="", instrumental=True, seed=5,
         timesignature="3"),
]


def _jobs(inf, out_dir):
    return [(inf.GenerationParams(duration=DURATION, thinking=False, **kw),
             inf.GenerationConfig(batch_size=1, output_dir=out_dir,
                                  audio_format="wav")) for kw in JOBS]


def _with_noise(handler, noise, calls):
    """Wrap handler.generate_music: each call gets `noise` as its initial
    noise and renders unnormalized; its kwargs and result are recorded."""
    orig = handler.generate_music

    def wrapped(*a, **kw):
        kw["initial_noise"] = noise
        kw.setdefault("normalize", False)
        res = orig(*a, **kw)
        calls.append((kw, res))
        return res
    return wrapped


def _assert_render_close(got, want):
    np.testing.assert_allclose(got.pred_latents, want.pred_latents,
                               atol=2e-4)
    for a, b in zip(got.audios, want.audios):
        assert a.shape == b.shape
        lsb = np.abs(b).max() / 32767.0
        np.testing.assert_allclose(a, b, atol=2e-4 + 2 * lsb)


@pytest.fixture(scope="module")
def fused(handlers, tmp_path_factory):  # noqa: F811
    jh, th = handlers
    noise = randn(7, len(JOBS), T, 64)
    jcalls, tcalls = [], []
    jh.generate_music = _with_noise(jh, noise, jcalls)
    th.generate_music = _with_noise(th, noise, tcalls)
    try:
        with highest():
            want = jinf.generate_music_group(
                jh, None, _jobs(jinf, str(tmp_path_factory.mktemp("j"))))
        got = tinf.generate_music_group(
            th, None, _jobs(tinf, str(tmp_path_factory.mktemp("t"))))
    finally:
        del jh.generate_music, th.generate_music
    return got, want, tcalls, jcalls, noise


def test_group_renders_once_and_matches_jax(fused):
    got, want, tcalls, jcalls, _ = fused
    assert len(tcalls) == len(jcalls) == 1
    (tkw, tres), (jkw, jres) = tcalls[0], jcalls[0]
    assert tkw["batch_size"] == jkw["batch_size"] == 3
    for key in ("captions", "lyrics", "metas", "vocal_languages", "seeds",
                "audio_duration", "use_random_seed", "task"):
        assert tkw[key] == jkw[key], key
    _assert_render_close(tres, jres)


def test_group_results_equal_jax(fused):
    got, want, _, _, _ = fused
    assert [r.success for r in got] == [r.success for r in want] == \
        [True] * 3
    for g, w in zip(got, want):
        ge, we = g.extra_outputs, w.extra_outputs
        assert set(ge["time_costs"]) == set(we["time_costs"])
        assert ge["time_costs"]["coalesced_jobs"] == 3
        for key in ("lm_metadata", "audio_codes", "frames", "task", "seeds",
                    "coalesced_jobs"):
            assert ge[key] == we[key], key
        (ga,), (wa,) = g.audios, w.audios
        assert {k: v for k, v in ga.items() if k not in ("audio",)}.keys() \
            == wa.keys()
        for key in ("key", "seed", "params", "sample_rate"):
            assert ga[key] == wa[key], key
        assert ga["path"].endswith(".wav") and ga["params_path"]
    assert [r.audios[0]["seed"] for r in got] == [3, 4, 5]


def test_group_failure_gives_one_result_per_job(handlers, tmp_path):  # noqa: F811
    _, th = handlers
    jobs = _jobs(tinf, str(tmp_path))
    jobs[0][0].infer_method = "bogus"          # the handler rejects it
    out = tinf.generate_music_group(th, None, jobs)
    assert len(out) == 3 and not any(r.success for r in out)
    assert all("infer_method" in r.error for r in out)


def test_fused_item_equals_solo_render(handlers, fused):  # noqa: F811
    """Each row draws from its own noise: a fused item matches a solo
    render of the same job (batch 1) within the tolerance."""
    _, th = handlers
    got, _, tcalls, _, noise = fused
    kw, fused_res = tcalls[0]
    rows = ("captions", "lyrics", "metas", "vocal_languages", "seeds")
    for i in range(len(JOBS)):
        solo = th.generate_music(**{
            **{k: v for k, v in kw.items() if k not in rows},
            **{k: [kw[k][i]] for k in rows},
            "batch_size": 1, "save_dir": None,
            "initial_noise": noise[i:i + 1]})
        np.testing.assert_allclose(solo.pred_latents[0],
                                   fused_res.pred_latents[i], atol=2e-4)
        np.testing.assert_allclose(
            got[i].extra_outputs["pred_latents"][0], solo.pred_latents[0],
            atol=2e-4)
        lsb = np.abs(solo.audios[0]).max() / 32767.0
        np.testing.assert_allclose(fused_res.audios[i], solo.audios[0],
                                   atol=2e-4 + 2 * lsb)


def test_seeded_rows_without_noise_seam(handlers, tmp_path):  # noqa: F811
    """Without the seam each row's generator is seeded with its job's
    seed: the fused item equals the solo render of that seed."""
    _, th = handlers
    jobs = _jobs(tinf, str(tmp_path))
    out = tinf.generate_music_group(th, None, jobs)
    for i, job in enumerate(jobs):
        solo = tinf.generate_music(th, None, *job)
        np.testing.assert_allclose(out[i].extra_outputs["pred_latents"],
                                   solo.extra_outputs["pred_latents"],
                                   atol=2e-4)
        assert isinstance(out[i].audios[0]["audio"], np.ndarray)
