"""The port's tools beside the package against the JAX package's own, on the
CPU at tiny geometry: the environment doctor (`scripts/check_gpu.py`
against `scripts/check_tpu.py`'s sections and exit code), the profiler
harness (`profile_inference_torch.py` against `profile_inference.py`: the
same modes, flags and report keys, equal non-time values on the same
arguments; tier-test's rows) and the memory profiler
(`scripts/profile_vram.py`'s analytic estimate against
`scripts/profile_hbm.py`'s, exactly).

Both profilers run their handlers at the same tiny geometry: the port's
through `--device cpu --tiny`, the JAX package's with its `AceStepHandler`
replaced by the same tiny construction. Times are not compared.
"""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

import profile_inference as jpi
from acestep_torch import runtime_config as trc
from acestep_torch.utils import downloads as tdl
from acestep_tpu import runtime_config as jrc
from acestep_tpu.config import DiTConfig as JaxDiTConfig
from acestep_tpu.config import VAEConfig as JaxVAEConfig
from acestep_tpu.pipeline import handler as jhandler

JaxHandler = jhandler.AceStepHandler

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import check_gpu  # noqa: E402
import profile_hbm  # noqa: E402
import profile_inference_torch as tpi  # noqa: E402
import profile_vram  # noqa: E402

TINY = dict(frame_bucket=25, min_frames=25, refer_frames=10)
# report values that are times or rates, not compared across packages
TIMED = {"wall_s", "seconds_per_song", "rtf", "diffusion_s",
         "dit_steps_per_s", "vae_decode_s", "vae_rtf", "init_s", "lm_s",
         "cot_wall_s", "cot_tokens_per_s", "codes_tokens_per_s",
         "generic_tokens_per_s", "output"}


# ------------------------------------------------------------------
# the environment doctor
# ------------------------------------------------------------------


@pytest.fixture
def no_hub(monkeypatch):
    """No card, no nvcc, no local checkpoints, no hub (the probe mocked):
    records the hosts probed."""
    from acestep_torch.ops import _build

    probed = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit on the machine that runs them")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(tdl, "resolve_local", lambda name, root=None: None)
    monkeypatch.setattr(tdl, "_probe",
                        lambda host, timeout=3.0: probed.append(host))
    for var in ("HF_HUB_OFFLINE", "ACESTEP_MAX_HBM_GB"):
        monkeypatch.delenv(var, raising=False)
    return probed


def test_doctor_cpu_run_passes_with_warnings(no_hub, capsys):
    assert check_gpu.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for title in ("Python / library versions", "CUDA devices",
                  "Memory / tier policy", "Kernel build toolchain",
                  "Checkpoint resolution", "ACESTEP_* environment",
                  "Summary"):
        assert f"  {title}\n" in out
    assert "[warn] no CUDA device (CPU run requested" in out
    assert "[warn] nvcc not found" in out
    assert "[ok]   tier: tier_cpu" in out
    assert "[warn] no checkpoints found and no hub reachable" in out
    assert no_hub == ["huggingface.co", "modelscope.cn"]
    assert "[FAIL]" not in out
    assert "[RESULT] environment looks good" in out
    # --cpu is the JAX doctor's spelling of the same run
    assert check_gpu.main(["--cpu"]) == 0


def test_doctor_without_card_fails_the_device_check(no_hub, capsys):
    assert check_gpu.main([]) == 1
    out = capsys.readouterr().out
    assert "[FAIL] no CUDA device is available" in out
    # without a card nvcc's absence is a warning here, not a second failure
    assert "[RESULT] 1 check(s) FAILED" in out


@pytest.mark.parametrize("argv", [["--smoke", "--device", "cpu"],
                                  ["--smoke"]])
def test_doctor_smoke_needs_a_card(no_hub, capsys, argv):
    assert check_gpu.main(argv) == 1
    out = capsys.readouterr().out
    assert "[FAIL] no card: --smoke launches the kernels" in out


def test_doctor_offline_does_not_probe_and_masks_keys(no_hub, capsys,
                                                      monkeypatch):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("ACESTEP_MAX_HBM_GB", "16")
    monkeypatch.setenv("ACESTEP_API_KEY", "sk-secret-value")
    assert check_gpu.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert no_hub == []
    assert "HF_HUB_OFFLINE is set, so the hubs were not probed" in out
    assert "[ok]   tier: tier_16g" in out
    assert "[warn] ACESTEP_MAX_HBM_GB=16 overrides detection" in out
    assert "ACESTEP_API_KEY=sk-sec..." in out and "secret-value" not in out


def test_doctor_script_runs_alone_on_the_cpu():
    """As a user runs it: a process of its own from the repo root (offline,
    so no hub is probed)."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("ACESTEP_")}
    env["HF_HUB_OFFLINE"] = "1"
    res = subprocess.run([sys.executable, "scripts/check_gpu.py", "--device",
                          "cpu"], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env=env)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "[RESULT] environment looks good" in res.stdout


# ------------------------------------------------------------------
# the profiler harness
# ------------------------------------------------------------------


def _jax_parser():
    """profile_inference.py's parser, as its main() builds it."""
    captured = []

    class Stop(Exception):
        pass

    def parse_args(self, *a, **k):
        captured.append(self)
        raise Stop

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = parse_args
    try:
        with pytest.raises(Stop):
            jpi.main([])
    finally:
        argparse.ArgumentParser.parse_args = orig
    return captured[0]


def _flags(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type,
                     type(a).__name__, tuple(a.choices or ()))
            for a in parser._actions if a.dest != "help"}


def test_profiler_modes_and_flags_equal_jax():
    assert list(tpi.MODES) == list(jpi.MODES)
    port = _flags(tpi.build_parser())
    assert set(port) - set(_flags(_jax_parser())) == {"device", "tiny"}
    assert {k: v for k, v in port.items()
            if k not in ("device", "tiny")} == _flags(_jax_parser())


def _jax_tiny_handler(*args, **kwargs):
    return JaxHandler(
        JaxDiTConfig.tiny(), JaxVAEConfig.tiny(decoder_input_channels=64),
        dtype=jnp.float32, **TINY)


@pytest.fixture
def both(monkeypatch, capsys):
    """Runs one argv through both profilers (the JAX one on its tiny
    handler); returns (port report, JAX report). Each tier cache starts
    empty and is restored after."""
    monkeypatch.setattr(jhandler, "AceStepHandler", _jax_tiny_handler)
    # JAX's tier-test sets the variable itself: restored after
    monkeypatch.setenv("ACESTEP_MAX_HBM_GB", "")
    monkeypatch.setattr(jrc, "_GLOBAL", None)
    monkeypatch.setattr(trc, "_GLOBAL", None)
    monkeypatch.delenv("ACESTEP_MESH", raising=False)

    def run(argv):
        assert tpi.main(argv + ["--device", "cpu", "--tiny"]) == 0
        port = json.loads(capsys.readouterr().out)
        monkeypatch.setattr(jrc, "_GLOBAL", None)
        monkeypatch.setattr(trc, "_GLOBAL", None)
        assert jpi.main(argv) == 0
        return port, json.loads(capsys.readouterr().out)
    return run


def _untimed(x):
    """The report's keys all the way down, and its values other than times
    and rates; `costs` keeps its keys only."""
    if isinstance(x, dict):
        return {k: (sorted(v) if k == "costs" else
                    type(v).__name__ if k in TIMED else _untimed(v))
                for k, v in x.items()}
    if isinstance(x, list):
        return [_untimed(v) for v in x]
    return x


def _check_device(port, k1=0, k4=0):
    dev = port.pop("device")
    assert dev == {"device": "cpu", "launches": {"K1": k1, "K4": k4}}


def test_profile_report_equals_jax(both, monkeypatch):
    """Batch 2 on the 4 GB tier (max batch 1): both clamp and say so."""
    monkeypatch.setenv("ACESTEP_MAX_HBM_GB", "4")
    port, jax_rep = both(["--mode", "profile", "--duration", "2", "--batch",
                          "2", "--steps", "2"])
    _check_device(port)
    assert port["cold"]["batch_clamped_to"] == 1
    assert _untimed(port) == _untimed(jax_rep)


def test_benchmark_report_equals_jax(both):
    port, jax_rep = both(["--mode", "benchmark", "--durations", "1,2",
                          "--batches", "1,2", "--steps", "2",
                          "--thinking-matrix"])
    _check_device(port)
    assert port["lm_planner"]["size"] == "tiny-fallback"
    assert [r.get("thinking", False) for r in port["rows"]] == \
        [False, True] * 4
    assert all(r["ok"] for r in port["rows"] if "ok" in r)
    assert _untimed(port) == _untimed(jax_rep)


@pytest.mark.parametrize("mode", ["understand", "create_sample",
                                  "format_sample"])
def test_planner_mode_reports_equal_jax(both, mode):
    port, jax_rep = both(["--mode", mode])
    _check_device(port)
    assert set(port) == set(jax_rep) == {"mode", "wall_s", "output"}
    assert port["mode"] == jax_rep["mode"] == mode
    assert type(port["output"]) is type(jax_rep["output"])


def test_tier_test_rows_equal_jax(both):
    """Each port tier in a child process of its own; the rows' tier, limits,
    planner and outcome equal JAX's in-process ones."""
    port, jax_rep = both(["--mode", "tier-test", "--tiers", "0,8"])
    _check_device(port)
    keys = ("hbm_gb", "tier", "max_batch", "max_duration", "lm", "ok")
    assert [tuple(r[k] for k in keys) for r in port["tiers"]] == \
        [tuple(r[k] for k in keys) for r in jax_rep["tiers"]] == \
        [(0.0, "tier_cpu", 8, 600, None, True),
         (8.0, "tier_8g", 2, 240, "0.6B", True)]
    assert _untimed(port) == _untimed(jax_rep)


def _tier_args(**kw):
    return tpi.build_parser().parse_args(
        ["--device", "cpu", "--tiny"] + [f"--{k.replace('_', '-')}"
                                         for k, v in kw.items() if v])


@pytest.mark.parametrize("sweep", ["base", "tier_boundary",
                                   "tier_batch_boundary"])
@pytest.mark.parametrize("fault", ["oom", "kernel"])
def test_boundary_sweeps_record_oom_and_raise_the_rest(monkeypatch, sweep,
                                                      fault):
    """Out of device memory is a tier's or a sweep's limit; any other
    error (an injected kernel fault) propagates and cannot read as one."""
    monkeypatch.setattr(trc, "_GLOBAL", None)
    err = (torch.cuda.OutOfMemoryError("CUDA out of memory") if fault == "oom"
           else RuntimeError("acestep_flash_fwd failed: CUDA error 700"))
    run_once = tpi._run_once

    def failing(handler, *, duration, batch, steps, warm=False):
        quant = getattr(handler, "quantization", None)
        if (sweep == "base" and batch == 2) or \
                (sweep == "tier_boundary" and quant == "fp8") or \
                (sweep == "tier_batch_boundary" and batch == 4):
            raise err
        return run_once(handler, duration=2.0, batch=batch, steps=1)

    monkeypatch.setattr(tpi, "_run_once", failing)
    args = _tier_args(**{sweep: sweep != "base"})
    if fault == "kernel":
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            tpi.tier_entry(args, 0.0)
        return
    entry = tpi.tier_entry(args, 0.0)
    if sweep == "base":
        assert not entry["ok"] and "out of memory" in entry["error"]
        return
    assert entry["ok"]
    if sweep == "tier_boundary":
        assert [(r["quantization"], r["ok"]) for r in entry["boundary"]] == [
            ("bf16", True), ("int8", True), ("fp8", False), ("w8a8", True)]
    else:
        assert [(r["batch"], r["ok"]) for r in entry["batch_boundary"]] == [
            (1, True), (2, True), (4, False)]
        assert entry["max_safe_batch"] == 2


def test_tier_child_failure_propagates(monkeypatch):
    monkeypatch.setattr(tpi.subprocess, "run",
                        lambda *a, **k: subprocess.CompletedProcess(a, 1, ""))
    with pytest.raises(RuntimeError, match="tier 8 GB: the child process "
                                           "exited 1"):
        tpi.mode_tier_test(tpi.build_parser().parse_args(
            ["--device", "cpu", "--tiny", "--tiers", "8"]))


def test_profiler_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        tpi.main(["--mode", "understand"])


# ------------------------------------------------------------------
# the memory profiler
# ------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vram_analytic_estimate_equals_jax(monkeypatch, dtype):
    """Exact bytes on both sides (the GB rounding off): parameters, the
    decode window's activations and the latents."""
    from acestep_torch.config import DiTConfig, VAEConfig
    from acestep_torch.pipeline.handler import AceStepHandler

    monkeypatch.setattr(jrc, "_GLOBAL", None)
    jh = JaxHandler(JaxDiTConfig.tiny(),
                                 JaxVAEConfig.tiny(decoder_input_channels=64),
                                 dtype=getattr(jnp, dtype), **TINY)
    jh.initialize_service(seed=0)
    th = AceStepHandler(DiTConfig.tiny(), VAEConfig.tiny(
        decoder_input_channels=64), dtype=getattr(torch, dtype),
        device="cpu", **TINY)
    th.initialize_service(seed=0)
    monkeypatch.setattr(profile_hbm, "gb", float)
    monkeypatch.setattr(profile_vram, "gb", float)
    for duration, batch in ((2.0, 1), (60.0, 2), (600.0, 8)):
        want = {k: float(v) for k, v in profile_hbm.analytic_estimate(
            jh, duration, batch).items()}
        assert profile_vram.analytic_estimate(th, duration, batch) == want
        assert want["params_gb"] > 0 and want["latents_gb"] > 0


def test_vram_cpu_rows_hold_the_labelled_estimate(capsys):
    assert profile_vram.main(["--device", "cpu", "--tiny", "--durations",
                              "1,2", "--batches", "1,2", "--steps",
                              "2"]) == 0
    cap = capsys.readouterr()
    rep = json.loads(cap.out)
    assert rep["device"] == {"device": "cpu",
                             "launches": {"K1": 0, "K4": 0}}
    assert [(r["duration_s"], r["batch"]) for r in rep["stages"]] == [
        (1.0, 1), (1.0, 2), (2.0, 1), (2.0, 2)]
    for r in rep["stages"]:
        assert set(r) == {"duration_s", "batch", "params_gb",
                          "decode_act_est_gb", "latents_gb", "note"}
        assert r["note"] == "memory_stats unavailable; analytic estimate"
    assert 'init: {"before": null, "after": null}' in cap.err


def test_vram_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        profile_vram.main(["--durations", "1"])
