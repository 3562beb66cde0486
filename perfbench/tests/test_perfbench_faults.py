"""Whole runs on the CPU at tiny widths (the harness's look for a card
skipped) with the timed path broken underneath: each fault a cell can
have must turn `correct` false under the cell's own limits.

- a sampler step that returns its state unchanged;
- half of a fused render's rows left out, the other rows' songs served
  in their place (the REST cell fuses up to 4 jobs a render, and its
  sample holds every song of one of the largest renders);
- an answer altered where it is produced (a quarter of every song's
  samples negated after the decode);
- a request that fails.
There is one card a cell, so no exchange between cards to leave out.
"""

import numpy as np
import pytest
import torch
from conftest import tiny_spec

import run as run_py


def _step_unchanged(handler, monkeypatch):
    from acestep_torch.models import sampler

    monkeypatch.setattr(sampler, "dit_decoder",
                        lambda model, cfg, xt, *a, **k: torch.zeros_like(xt))


def _half_batch(handler, monkeypatch):
    from acestep_torch.pipeline.handler import AceStepHandler

    orig = AceStepHandler._generate_latents

    def half(self, inputs, *, seeds, **kw):
        x0 = orig(self, inputs, seeds=seeds, **kw)
        B = x0.shape[0]
        if B > 1:
            x0 = x0.clone()
            x0[B - B // 2:] = x0[:B // 2]
        return x0

    # set, not monkeypatched: the run's own wrappers restore the class
    AceStepHandler._generate_latents = half


def _answer_altered(handler, monkeypatch):
    from acestep_torch.pipeline.handler import AceStepHandler

    orig = AceStepHandler.decode_latents

    def altered(self, latents):
        audio = np.array(orig(self, latents))
        audio[:, : audio.shape[1] // 4] *= -1.0
        return audio

    AceStepHandler.decode_latents = altered


def _request_fails(handler, monkeypatch, target):
    """Every render that holds the seed `target` raises."""
    from acestep_torch.pipeline.handler import AceStepHandler

    orig = AceStepHandler.generate_music

    def sometimes(self, *a, **kw):
        seeds = kw.get("seeds")
        if target in ([seeds] if isinstance(seeds, int) else seeds or []):
            raise RuntimeError("planted failure")
        return orig(self, *a, **kw)

    AceStepHandler.generate_music = sometimes


FAULTS = {"step_unchanged": _step_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered, "request_fails": _request_fails}
CASES = [("turbo-rest-30s", f) for f in FAULTS] + \
    [("turbo-long-240s", f) for f in ("step_unchanged", "answer_altered",
                                      "request_fails")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_turns_correct_false(cell, fault, monkeypatch):
    # the cell's own mix and sample size: the REST cell's 8 clients keep
    # jobs queued behind the render, so the server fuses them
    spec = tiny_spec(cell)
    seed = 987654321
    args = (monkeypatch,)
    if fault == "request_fails":
        from harness import traffic

        first = traffic.requests(spec.mix, seed, 3.0,
                                 count=spec.mix.get("closed_count", 0))[0]
        args = (monkeypatch, first["seed"])
    run, metrics, checks = run_py.execute(
        spec, seed, 3.0, False, torch.device("cpu"),
        hook=lambda h: FAULTS[fault](h, *args))
    if fault == "half_batch":
        assert any(r["coalesced"] > 1 for r in run.records), \
            "no fused render formed: the fault was not exercised"
    correct, shown = run_py.verdict(checks, spec.limits)
    assert correct is False, shown


def test_sound_long_run_is_correct():
    spec = tiny_spec("turbo-long-240s")
    run, metrics, checks = run_py.execute(spec, 5, 3.0, False,
                                          torch.device("cpu"))
    correct, shown = run_py.verdict(checks, spec.limits)
    assert correct is True, shown
    assert {"latency_p50_s", "audio_s_per_s", "setup_s",
            "peak_mem_gib"} <= set(metrics)
