"""Benchmark of the PyTorch/CUDA port: headline seconds-per-song and the
service-stack matrix. The counterpart of bench.py, with its sections, row
keys, budget gate and stdout contract.

Headline: condition encode -> 8-step turbo DiT -> tiled Oobleck VAE decode
for one 60 s 48 kHz stereo song at batch 1, bf16, full width
(DiTConfig.turbo(), VAEConfig()), seeded random weights and inputs; one
warm run, then the median of three, each wall ending on
`torch.cuda.synchronize()`. The headline records K1's (flash attention)
and K4's (the VAE's snake + conv stack) launches for one song.

The matrix: thinking on/off x batch 1/8 x 10/30/60/600 s through the
service stack (AceStepHandler + LLMHandler + the facade), with per-stage
times (LM / diffusion / VAE) and analytic DiT MFU per diffusion row, the
Qwen3 1.7B and 4B planner geometries (bf16 with an int8 KV cache, and
w8a8), prefill, prefix reuse and `plan_batch`. Random weights and
`SimpleTokenizer`: throughput does not depend on the weights.

Wall budget: the process targets ACESTEP_BENCH_BUDGET_S seconds (default
960). Sections run in bench.py's order; one that does not fit the
remaining budget (with the set-up of any handler or planner it would have
to build) is skipped with an explicit `skipped (budget)` row. A failed row
is an `error` row; after an out-of-memory error later sections are
skipped (`post-OOM`) unless a fresh 256 MB allocation succeeds.

stdout: ONE small JSON line
  {"metric": "seconds_per_song", "value": W, "unit": "s",
   "vs_baseline": 2.0 / W, "extra": {...}}
printed twice: after the headline and, updated, at exit. Progress goes to
stderr. The matrix goes to BENCH_MATRIX_torch.json and, with
`--write-docs`, docs/BENCHMARK_torch.md (`--docs-from-matrix` rewrites the
docs from the saved matrix without a device).

Runs on the CUDA device; without one it raises, unless `--device cpu`
(plain PyTorch versions of the kernels, float32; `--tiny` builds the
miniature models):

    python3 bench_torch.py [--headline-only] [--write-docs]
    python3 bench_torch.py --device cpu --tiny --headline-only
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import statistics
import sys
import tempfile
import time
from typing import List, Optional

import torch

from acestep_torch.config import DiTConfig, LMConfig, VAEConfig
from profile_inference_torch import _dtype, _sync, card_line, kernel_launches

ROOT = os.path.dirname(os.path.abspath(__file__))
MATRIX_PATH = os.path.join(ROOT, "BENCH_MATRIX_torch.json")
DOCS_PATH = os.path.join(ROOT, "docs", "BENCHMARK_torch.md")

# The upstream README's headline: under 2 s per full song on an A100. It
# is the yardstick bench.py divides by; no card of this repo measured it.
BASELINE_SECONDS = 2.0
DURATION_S = 60
BATCH = 1
TEXT_LEN = 64
LYRIC_LEN = 512
COND_LEN = TEXT_LEN + LYRIC_LEN + 1
MARGIN_S = 30.0

# Published dense peaks (TFLOP/s; TOP/s for int8) by the name
# torch.cuda.get_device_name() gives: NVIDIA's H100 data sheet.
PEAK_TFLOPS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989.4, "int8": 1978.9},
    "NVIDIA H100 PCIe": {"bf16": 756.0, "int8": 1513.0},
    "NVIDIA H100 NVL": {"bf16": 835.0, "int8": 1671.0},
}


def log(msg):
    print(msg, file=sys.stderr, flush=True)


class Budget:
    """The process's wall budget: a section starts only if its estimate
    fits inside what is left less MARGIN_S."""

    def __init__(self, total_s: float):
        self.total_s = total_s
        self.t_start = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.t_start

    def remaining(self) -> float:
        return self.total_s - MARGIN_S - self.elapsed()


def _stats(walls):
    """(median, [min, max]): rows report the median with its spread."""
    return (round(statistics.median(walls), 3),
            [round(min(walls), 3), round(max(walls), 3)])


def _median_run(walls):
    """(wall, spread, idx) where idx is the run whose wall IS the reported
    median (lower median for even counts): stage costs come from the same
    run as the reported wall, or the columns can sum past it."""
    order = sorted(range(len(walls)), key=walls.__getitem__)
    idx = order[(len(walls) - 1) // 2]
    return (round(walls[idx], 3),
            [round(min(walls), 3), round(max(walls), 3)], idx)


def device_name(device) -> Optional[str]:
    """torch's name of the card, or None off a CUDA device."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else None


# ---------------------------------------------------------------- MFU

def peak_tflops(name: Optional[str], dtype: str = "bf16") -> Optional[float]:
    """The card's published dense peak for the MFU column; None for a card
    (or CPU) the table does not name: no guessed figure."""
    peaks = PEAK_TFLOPS.get(name or "")
    return None if peaks is None else peaks[dtype]


def dit_flops(cfg: DiTConfig, frames: int, cond_len: int, steps: int,
              batch: int, cfg_steps: int = 0) -> float:
    """Analytic forward FLOPs of the DiT decoder trajectory (2*MACs).

    Counts the decoder only (projections, attention, MLP, patchify): the
    condition encoder runs once per request and is excluded, so the MFU
    column measures the diffusion loop it is printed next to.
    `cfg_steps` of the `steps` run with a doubled (CFG) batch.
    """
    L = -(-frames // cfg.patch_size)                     # patches
    h = cfg.hidden_size
    qd = cfg.num_attention_heads * cfg.head_dim
    kvd = cfg.num_key_value_heads * cfg.head_dim
    inter = cfg.intermediate_size
    n_layers = cfg.num_hidden_layers
    window = cfg.sliding_window or 128

    per_layer = 0.0
    for i in range(n_layers):
        kv_span = min(L, window if cfg.layer_is_sliding(i) else L)
        # self-attn: QKVO projections + QK^T + AV
        per_layer_i = 2 * L * (h * qd + 2 * h * kvd + qd * h)
        per_layer_i += 2 * 2 * L * kv_span * qd
        # cross-attn: Q,O every step (KV cached once per trajectory)
        per_layer_i += 2 * L * (h * qd + qd * h)
        per_layer_i += 2 * 2 * L * cond_len * qd
        # SwiGLU MLP: gate+up+down
        per_layer_i += 2 * L * h * inter * 3
        per_layer += per_layer_i
    # patchify in (192ch*patch -> h) + de-patchify out (h -> 64*patch)
    io = 2 * L * (3 * cfg.audio_acoustic_hidden_dim * cfg.patch_size * h) \
        + 2 * L * (h * cfg.audio_acoustic_hidden_dim * cfg.patch_size)
    per_fwd = per_layer + io
    # cross-KV projection, once per trajectory
    kv_once = n_layers * 2 * cond_len * (2 * h * kvd)
    eff_steps = steps + cfg_steps                        # CFG doubles batch
    return batch * (per_fwd * eff_steps + kv_once)


def _mfu_fields(cfg: DiTConfig, frames: int, cond_len: int, steps: int,
                batch: int, diffusion_s: float, cfg_steps: int = 0,
                dtype: str = "bf16", name: Optional[str] = None) -> dict:
    """DiT FLOPs and, on the card `name` (None off a CUDA device: both
    null), their rate over `diffusion_s` and its share of the card's peak
    (`mfu_pct`; null with `mfu_card` when the table has no peak for it)."""
    if not diffusion_s or diffusion_s <= 0:
        return {}
    fl = dit_flops(cfg, frames, cond_len, steps, batch, cfg_steps)
    out = {"dit_tflops": round(fl / 1e12, 2)}
    if name is None:                # not a card: no device rate or share
        return {**out, "dit_tflops_s": None, "mfu_pct": None}
    tf = fl / diffusion_s / 1e12
    peak = peak_tflops(name, dtype)
    out.update(dit_tflops_s=round(tf, 1),
               mfu_pct=None if peak is None else round(100.0 * tf / peak, 1))
    if peak is None:
        out["mfu_card"] = name
    return out


# ------------------------------------------------------------- stages

def probe_bandwidth(device, wall_bound_s: float = 25.0) -> dict:
    """Device-to-host copy rate (MiB/s): a 600 s song's audio is ~115 MB
    of int16 on the copy back, so its VAE stage includes this copy.
    Escalating sizes (1 -> 8 -> 32 MiB int16), each timed from a
    synchronised device to the tensor on the host, under a wall bound."""
    t_start = time.perf_counter()
    rates = []
    probed_mib = 0.0
    for mib in (1, 8, 32, 32):
        n = int(mib * 1024 * 1024 // 2)
        x = torch.full((n,), len(rates) + 1, dtype=torch.int16,
                       device=device)
        _sync(device)
        t0 = time.perf_counter()
        x.cpu()
        dt = time.perf_counter() - t0
        rates.append(mib / max(dt, 1e-6))
        probed_mib = float(mib)
        if time.perf_counter() - t_start > wall_bound_s or rates[-1] < 4.0:
            break
    med, spread = _stats(rates)
    return {"d2h_MBps": med, "d2h_MBps_spread": spread,
            "d2h_probe_mib": probed_mib}


def headline_configs(tiny: bool):
    """(DiTConfig, VAEConfig) of the headline: full width, or the
    miniature models (the tiny VAE takes the tiny DiT's 64 latents)."""
    if tiny:
        return DiTConfig.tiny(), VAEConfig.tiny(decoder_input_channels=64)
    return DiTConfig.turbo(), VAEConfig()


def headline_inputs(cfg: DiTConfig, T: int, device, dtype,
                    seed: int = 0, batch: int = BATCH):
    """(prepare_condition's keyword inputs, x_init) of a text2music song
    of T latent frames, drawn from a generator seeded `seed` on
    `device`: bench.py's shapes."""
    g = torch.Generator(device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device).to(dtype)

    C = cfg.audio_acoustic_hidden_dim
    inputs = dict(
        text_hidden_states=randn(batch, TEXT_LEN, cfg.text_hidden_dim),
        text_attention_mask=torch.ones((batch, TEXT_LEN), dtype=torch.int32,
                                       device=device),
        lyric_hidden_states=randn(batch, LYRIC_LEN, cfg.text_hidden_dim),
        lyric_attention_mask=torch.ones((batch, LYRIC_LEN),
                                        dtype=torch.int32, device=device),
        refer_audio_packed=randn(batch, 2 * cfg.pool_window_size,
                                 cfg.timbre_hidden_dim),
        refer_order_mask=torch.arange(batch, dtype=torch.int32,
                                      device=device),
        src_latents=torch.zeros((batch, T, C), dtype=dtype, device=device),
        chunk_masks=torch.ones((batch, T, C), dtype=dtype, device=device),
        is_covers=torch.zeros((batch,), dtype=torch.int32, device=device),
    )
    return inputs, randn(batch, T, C)


def song(model, vae, cfg: DiTConfig, vae_cfg: VAEConfig, inputs, x_init,
         schedule):
    """The headline's composition: condition -> cross K/V -> 8-step turbo
    ODE -> tiled VAE decode. Returns (latents, audio)."""
    from acestep_torch.models.dit import prepare_condition
    from acestep_torch.models.sampler import ConditionSet, sample_turbo
    from acestep_torch.models.vae_tiled import tiled_decode

    enc, _mask, ctx = prepare_condition(model, cfg, **inputs)
    cond = ConditionSet.build(model, cfg, enc, ctx)
    x0 = sample_turbo(model, cfg, x_init=x_init, schedule=schedule,
                      cond=cond)
    return x0, tiled_decode(vae, vae_cfg, x0)


def headline(device, tiny: bool = False):
    """One 60 s song at batch 1: (median wall, spread, MFU fields, the
    K1/K4 launches of one song)."""
    from acestep_torch.models.dit import init_dit_params
    from acestep_torch.models.sampler import build_turbo_schedule
    from acestep_torch.models.vae import init_vae_params

    cfg, vae_cfg = headline_configs(tiny)
    dtype = _dtype(device)
    T = DURATION_S * 25                      # 25 Hz latent frames
    t0 = time.perf_counter()
    model = init_dit_params(cfg, torch.Generator(device).manual_seed(4),
                            dtype=dtype)
    vae = init_vae_params(vae_cfg, torch.Generator(device).manual_seed(5),
                          dtype=dtype)
    inputs, x_init = headline_inputs(cfg, T, device, dtype)
    _sync(device)
    log(f"setup: {time.perf_counter() - t0:.1f}s")
    schedule = build_turbo_schedule(shift=3.0)

    def generate():
        with torch.inference_mode():
            _, audio = song(model, vae, cfg, vae_cfg, inputs, x_init,
                            schedule)
        _sync(device)
        return audio

    log(f"device: {device} ({device_name(device)})")
    t0 = time.perf_counter()
    audio = generate()
    log(f"first run: {time.perf_counter() - t0:.1f}s; audio "
        f"{tuple(audio.shape)}")
    times = []
    launches = None
    for i in range(3):
        before = kernel_launches()
        t0 = time.perf_counter()
        audio = generate()
        times.append(time.perf_counter() - t0)
        if launches is None:
            launches = {k: n - before[k]
                        for k, n in kernel_launches().items()}
        log(f"headline run {i}: {times[-1]:.3f}s")
    if not bool(torch.isfinite(audio).all()):
        raise RuntimeError("headline: non-finite audio")
    wall, spread = _stats(times)
    # the wall covers the condition encoder, 8 DiT steps and the VAE; the
    # DiT has most of the FLOPs, so this is a lower bound on DiT MFU
    mfu = _mfu_fields(cfg, T, COND_LEN, 8, BATCH, wall,
                      name=device_name(device))
    return wall, spread, mfu, launches


# ------------------------------------------------------------- matrix

def _handler(device, tiny: bool, version: str = "turbo"):
    """An AceStepHandler of `version` (turbo/base) on `device`, not yet
    initialised: full width, or the miniature models."""
    from acestep_torch.pipeline.handler import AceStepHandler

    if tiny:
        return AceStepHandler(DiTConfig.tiny(model_version=version),
                              VAEConfig.tiny(decoder_input_channels=64),
                              dtype=_dtype(device), frame_bucket=25,
                              min_frames=25, refer_frames=10, device=device)
    cfg = DiTConfig.turbo() if version == "turbo" else DiTConfig.base()
    return AceStepHandler(cfg, VAEConfig(), dtype=_dtype(device),
                          device=device)


def matrix(rows: list, truncated: list, budget: Budget, device,
           out_dir: str, tiny: bool = False) -> None:
    """Service-stack matrix, in bench.py's section order, under `budget`;
    the thinking rows' facade writes its wav files into `out_dir`."""
    from acestep_torch import inference
    from acestep_torch.inference import GenerationConfig, GenerationParams
    from acestep_torch.llm.handler import LLMHandler
    from acestep_torch.llm.tokenizer import SimpleTokenizer
    from acestep_torch.utils.memory import is_oom_error, release_device_memory

    name = device_name(device)
    dtype = _dtype(device)
    state: dict = {}            # live handlers, built lazily per section
    oom_hit: list = []          # post-OOM circuit breaker (see section())

    def lm_cfg(geometry: LMConfig) -> LMConfig:
        return (LMConfig.tiny(vocab_size=tok17().vocab_size) if tiny
                else geometry)

    def dit_cfg(version: str = "turbo") -> DiTConfig:
        if tiny:
            return DiTConfig.tiny(model_version=version)
        return DiTConfig.turbo() if version == "turbo" else DiTConfig.base()

    # set-up a section pays when its handler or planner is not built yet
    # (seconds on an H100: seeded init on the card and first requests)
    DEP_COST = {"handler": 3, "llm": 2, "llm17": 5, "llm17q": 5}

    # Each section's estimate is its seconds on an H100 (NVIDIA H100 80GB
    # HBM3, 700 W) with about a third added. Mandatory sections keep a
    # budget reserve: an optional (tail) section only runs if the
    # remaining budget covers both it and every mandatory section still
    # outstanding.
    MANDATORY = {
        "60s_b1": 5, "30s_b8": 8, "10s_b1_think": 4,
        "lm1.7B_think60s_b1": 8, "lm1.7B_prefill2048_cfg": 2,
        "lm1.7B_prefix_reuse": 5, "30s_b1_think_lm1.7B": 10,
        "lm1.7B_codes300_w8a8": 12, "base50_60s_b1": 10,
        "lm4B": 50,
    }
    reserve_left = dict(MANDATORY)

    # Slow-run detector: the worst actual/estimate overrun among
    # substantial completed sections inflates every later tail's gate, so
    # a slow run sheds optional tails early.
    overrun = [1.0]

    @contextlib.contextmanager
    def section(sec, est_s, deps=(), tail=False):
        """Budget gate + fail-soft guard: a section that does not fit the
        remaining budget is skipped visibly; a broken row does not end the
        matrix."""
        t_sec = time.perf_counter()
        reserve_left.pop(sec, None)
        if oom_hit:
            log(f"SECTION {sec} skipped (post-OOM)")
            truncated.append(sec)
            rows.append({"config": sec, "skipped": "post-OOM"})
            yield False
            return
        est_s = est_s + sum(DEP_COST[d] for d in deps if d not in state)
        factor = max(overrun) if tail else 1.0
        need = (est_s + sum(reserve_left.values())) * factor if tail \
            else est_s
        if budget.remaining() < need:
            log(f"SECTION {sec} skipped (budget): need ~{need:.0f}s"
                f"{' incl. mandatory reserve' if tail else ''}"
                f"{f' (x{factor:.2f} slow run)' if factor > 1 else ''}, "
                f"have {budget.remaining():.0f}s")
            truncated.append(sec)
            rows.append({"config": sec, "skipped": "budget"})
            yield False
            return
        failed = False
        try:
            yield True
        except Exception as e:       # noqa: BLE001 - the row's error
            log(f"SECTION {sec} FAILED: {e!r}")
            rows.append({"config": sec, "error": repr(e)[:300]})
            failed = True
            if is_oom_error(e):
                oom_hit.append(sec)
        elapsed = time.perf_counter() - t_sec
        if not failed and elapsed >= 30 and elapsed > est_s:
            overrun.append(elapsed / est_s)
            log(f"slow-run factor now x{max(overrun):.2f} "
                f"({sec}: {elapsed:.0f}s vs {est_s:.0f}s est)")
        log(f"section {sec}: {elapsed:.1f}s elapsed, "
            f"{budget.remaining():.0f}s budget left")
        if failed:
            # drop the handlers (on OOM the residents may be why the card
            # is full) and the allocator's cached blocks
            if oom_hit:
                state.clear()
            release_device_memory()
            if oom_hit:
                # if a fresh 256 MB allocation succeeds after the release,
                # later sections (which rebuild their residents) can run
                try:
                    z = torch.zeros((128, 1024, 1024), dtype=torch.int16,
                                    device=device)
                    _sync(device)
                    del z
                    log(f"post-OOM probe passed after {sec}; continuing")
                    oom_hit.clear()
                except torch.cuda.OutOfMemoryError as pe:
                    log(f"post-OOM probe failed ({pe!r}); "
                        f"skipping remaining sections")

    # lazy builders ---------------------------------------------------

    def turbo_handler():
        if "handler" not in state:
            h = _handler(device, tiny)
            h.initialize_service(seed=0)
            state["handler"] = h
        return state["handler"]

    def tiny_llm():
        if "llm" not in state:
            lm = LLMHandler(dtype=dtype, device=device)
            lm.initialize(num_fallback_codes=64, max_duration=600, seed=0)
            state["llm"] = lm
        return state["llm"]

    def tok17():
        if "tok17" not in state:
            state["tok17"] = SimpleTokenizer(num_audio_codes=64_000)
        return state["tok17"]

    def llm17():
        if "llm17" not in state:
            lm = LLMHandler(dtype=dtype, device=device)
            # kv_quant: int8 KV cache, halving the per-step cache reads
            # that dominate decode beyond ~3k context
            lm.initialize(cfg=lm_cfg(LMConfig.qwen3_1_7b()),
                          tokenizer=tok17(), max_duration=600, seed=0,
                          kv_quant=True)
            state["llm17"] = lm
        return state["llm17"]

    def drop(*names, hard=False):
        for n in names:
            state.pop(n, None)
        gc.collect()
        if hard:
            # a resident planner's captured decode graphs pin their
            # memory pools: drop them (they are captured again on use)
            for obj in state.values():
                engine = getattr(obj, "engine", None)
                if engine is not None:
                    engine._graphs = {}
            release_device_memory()

    def counted(fn):
        """(fn(), the K1/K4 launches of the call)."""
        before = kernel_launches()
        out = fn()
        _sync(device)
        return out, {k: n - before[k] for k, n in kernel_launches().items()}

    # row runners -----------------------------------------------------

    def run_dit(tag, duration, batch, repeats=3, steps=8):
        handler = turbo_handler()
        kw = dict(audio_duration=float(duration), batch_size=batch,
                  seeds=list(range(batch)), infer_steps=steps)
        _, launches = counted(lambda: handler.generate_music(
            ["bench"] * batch, ["[inst]"] * batch, **kw))
        walls, runs = [], []
        for _ in range(repeats):
            t0 = time.perf_counter()
            r = handler.generate_music(["bench"] * batch,
                                       ["[inst]"] * batch, **kw)
            _sync(device)
            walls.append(time.perf_counter() - t0)
            runs.append(r.time_costs)
        wall, spread, mid = _median_run(walls)
        costs = runs[mid]
        diff_s = round(costs.get("diffusion_time_cost", 0), 3)
        rows.append({
            "config": tag, "duration_s": duration, "batch": batch,
            "thinking": False, "wall_s": wall, "wall_spread": spread,
            "seconds_per_song": round(wall / batch, 3),
            "rtf": round(duration * batch / wall, 1),
            "prep_s": round(costs.get("prepare_time_cost", 0)
                            + costs.get("text_encode_time_cost", 0), 3),
            "svc_total_s": round(costs.get("total_time_cost", 0), 3),
            "diffusion_s": diff_s,
            "vae_s": round(costs.get("vae_decode_time_cost", 0), 3),
            "launches": launches,
            **_mfu_fields(dit_cfg(), int(duration * 25), COND_LEN, steps,
                          batch, diff_s, name=name),
        })
        log(f"matrix {tag}: {rows[-1]}")

    def run_think(tag, duration, batch, repeats=2, llm_handler=None,
                  lm_geom=None, dit_handler=None):
        llm_ = llm_handler if llm_handler is not None else tiny_llm()
        dit_ = dit_handler if dit_handler is not None else turbo_handler()
        params = GenerationParams(caption="an upbeat synth track",
                                  lyrics="[inst]", thinking=True,
                                  duration=float(duration), seed=7)
        # wav: the rows measure generation, not the (default) flac encode
        config = GenerationConfig(batch_size=batch, output_dir=out_dir,
                                  allow_lm_batch=True,
                                  use_random_seed=False, audio_format="wav")
        _, launches = counted(lambda: inference.generate_music(
            dit_, llm_, params, config))                          # warm
        walls, runs = [], []
        for _ in range(repeats):
            t0 = time.perf_counter()
            result = inference.generate_music(dit_, llm_, params, config)
            _sync(device)
            walls.append(time.perf_counter() - t0)
            if not result.success:
                raise RuntimeError(f"{tag}: {result.error}")
            runs.append(result.extra_outputs.get("time_costs", {}))
        wall, spread, mid = _median_run(walls)
        costs = runs[mid]
        diff_s = round(costs.get("diffusion_time_cost", 0), 3)
        row = {
            "config": tag, "duration_s": duration, "batch": batch,
            "thinking": True, "wall_s": wall, "wall_spread": spread,
            "seconds_per_song": round(wall / batch, 3),
            "rtf": round(duration * batch / wall, 1),
            "lm_s": round(costs.get("lm_time_cost", 0), 3),
            "diffusion_s": diff_s,
            "vae_s": round(costs.get("vae_decode_time_cost", 0), 3),
            "launches": launches,
            **_mfu_fields(dit_cfg(), int(duration * 25), COND_LEN, 8,
                          batch, diff_s, name=name),
        }
        if lm_geom:
            row["lm_geom"] = lm_geom
        rows.append(row)
        log(f"matrix {tag}: {rows[-1]}")

    def run_lm_only(tag, *, target_duration, batch, repeats=3):
        """LM-only two-phase wall (CFG-paired, constrained CoT + codes)."""
        lm = llm17()
        kw = dict(temperature=0.85, cfg_scale=2.0, top_p=0.9,
                  target_duration=target_duration,
                  user_metadata={"duration": target_duration})
        n_codes = int(target_duration * 5)
        if batch == 1:
            lm.generate_with_stop_condition("bench lm", seed=0, **kw)
        else:
            lm.plan_batch("bench lm", n=batch, seed=0, **kw)
        walls, toks_runs = [], []
        for i in range(repeats):
            t0 = time.perf_counter()
            if batch == 1:
                rs = [lm.generate_with_stop_condition("bench lm",
                                                      seed=1 + i, **kw)]
            else:
                rs = lm.plan_batch("bench lm", n=batch, seed=1 + i, **kw)
            _sync(device)
            walls.append(time.perf_counter() - t0)
            # TOTAL decoded tokens across the batch (short rows stop early
            # and feed pads: crediting every row with the longest row's
            # CoT length would overstate throughput)
            cot_total = sum(len(lm.tokenizer.encode(r["cot_text"]))
                            for r in rs)
            toks_runs.append(cot_total + n_codes * batch)
        wall, spread, mid = _median_run(walls)
        toks = toks_runs[mid]
        rows.append({
            "config": tag, "lm_geom": "1.7B", "batch": batch,
            "thinking": True, "duration_s": target_duration,
            "wall_s": wall, "wall_spread": spread,
            "lm_tokens_per_seq": round(toks / batch, 1),
            "decode_tok_s": round(toks / wall, 1),
        })
        log(f"matrix {tag}: {rows[-1]}")

    def run_guided(tag, duration, steps, repeats=3):
        handler_b = state["handler_b"]
        kw = dict(audio_duration=float(duration), infer_steps=steps,
                  guidance_scale=7.0, use_adg=False)
        _, launches = counted(lambda: handler_b.generate_music(
            "bench", "[inst]", seeds=1, **kw))                    # warm
        walls, runs = [], []
        for i in range(repeats):
            t0 = time.perf_counter()
            r = handler_b.generate_music("bench", "[inst]", seeds=2 + i, **kw)
            _sync(device)
            walls.append(time.perf_counter() - t0)
            runs.append(r.time_costs)
        wall, spread, mid = _median_run(walls)
        costs = runs[mid]
        diff_s = round(costs.get("diffusion_time_cost", 0), 3)
        rows.append({
            "config": tag, "duration_s": duration, "batch": 1,
            "thinking": False, "wall_s": wall, "wall_spread": spread,
            "seconds_per_song": wall, "rtf": round(duration / wall, 1),
            "infer_steps": steps,
            "prep_s": round(costs.get("prepare_time_cost", 0)
                            + costs.get("text_encode_time_cost", 0), 3),
            "svc_total_s": round(costs.get("total_time_cost", 0), 3),
            "diffusion_s": diff_s,
            "vae_s": round(costs.get("vae_decode_time_cost", 0), 3),
            "launches": launches,
            **_mfu_fields(dit_cfg("base"), int(duration * 25), COND_LEN,
                          steps, 1, diff_s, cfg_steps=steps, name=name),
        })
        log(f"matrix {tag}: {rows[-1]}")

    # the headline's model and VAE are dead locals by now: start the 4B
    # section from the allocator's empty cache
    drop(hard=True)

    # 4B planner: Qwen3-4B geometry at w8a8 (the 16 GB tier's mode) plus
    # the w8a8 DiT+VAE service pairing on one card. First, as in bench.py,
    # on a card no earlier section has used.
    def bench_lm4b():
        # nested function: on an exception every local (the 4B handler and
        # its caches) dies with the frame, freeing its memory
        if device.type == "cuda":
            log(f"pre-4B allocated: "
                f"{torch.cuda.memory_allocated(device) / (1 << 20):.0f} MB")
        llm4 = LLMHandler(dtype=dtype, device=device)
        t0 = time.perf_counter()
        llm4.initialize(cfg=lm_cfg(LMConfig.qwen3_4b()), tokenizer=tok17(),
                        max_duration=600, seed=0, quantization="w8a8")
        load4_s = time.perf_counter() - t0
        p4 = llm4.build_formatted_prompt_with_cot(
            "bench", "", "<think>\nduration: 60\n</think>")
        n4 = llm4.build_formatted_prompt_with_cot(
            "bench", "", "<think>\nduration: 60\n</think>",
            is_negative_prompt=True)
        qkw4 = dict(unconditional_prompts=[n4], cfg_scale=2.0,
                    temperature=0.85, top_p=0.9, n_codes=300)
        llm4.engine.generate_codes([p4], seed=0, **qkw4)        # warm
        walls4 = []
        for i in range(2):
            t0 = time.perf_counter()
            llm4.engine.generate_codes([p4], seed=1 + i, **qkw4)
            _sync(device)
            walls4.append(time.perf_counter() - t0)
        w4, s4, _ = _median_run(walls4)
        rows.append({
            "config": "lm4B_codes300_w8a8", "lm_geom": "4B", "batch": 1,
            "thinking": True, "wall_s": w4, "wall_spread": s4,
            "decode_tok_s": round(300 / w4, 1), "load_s": round(load4_s, 1),
        })
        log(f"matrix lm4B_codes300_w8a8: {rows[-1]}")
        # the thinking example with the 4B planner end to end through the
        # 16 GB tier's pairing (w8a8 DiT + w8a8 4B LM), fail-soft: losing
        # the pairing row must not lose the codes row
        hq = None
        if budget.remaining() > 30:
            try:
                hq = _handler(device, tiny)
                hq.initialize_service(seed=0, quantization="w8a8")
                run_think("30s_b1_think_lm4B", 30, 1, repeats=2,
                          llm_handler=llm4, lm_geom="4B", dit_handler=hq)
            except Exception as e:   # noqa: BLE001 - row-level fail-soft
                log(f"row 30s_b1_think_lm4B FAILED: {e!r}")
                rows.append({"config": "30s_b1_think_lm4B",
                             "error": repr(e)[:300]})
        # the quantized service row, on the pairing handler that exists
        if hq is not None and budget.remaining() > 30:
            try:
                _, launches = counted(lambda: hq.generate_music(
                    "bench", "[inst]", audio_duration=60.0, seeds=1,
                    infer_steps=8))                              # warm
                walls, runs = [], []
                for i in range(3):
                    t0 = time.perf_counter()
                    r = hq.generate_music("bench", "[inst]",
                                          audio_duration=60.0,
                                          seeds=2 + i, infer_steps=8)
                    _sync(device)
                    walls.append(time.perf_counter() - t0)
                    runs.append(r.time_costs)
                wall, spread, mid = _median_run(walls)
                costs = runs[mid]
                diff_s = round(costs.get("diffusion_time_cost", 0), 3)
                rows.append({
                    "config": "60s_b1_w8a8", "duration_s": 60, "batch": 1,
                    "thinking": False, "wall_s": wall,
                    "wall_spread": spread, "seconds_per_song": wall,
                    "rtf": round(60 / wall, 1), "diffusion_s": diff_s,
                    "vae_s": round(costs.get("vae_decode_time_cost", 0), 3),
                    "launches": launches,
                    **_mfu_fields(dit_cfg(), 1500, COND_LEN, 8, 1, diff_s,
                                  dtype="int8", name=name),
                })
                log(f"matrix 60s_b1_w8a8: {rows[-1]}")
            except Exception as e:   # noqa: BLE001 - row-level fail-soft
                log(f"row 60s_b1_w8a8 FAILED: {e!r}")
                rows.append({"config": "60s_b1_w8a8",
                             "error": repr(e)[:300]})
        del llm4, hq

    with section("lm4B", 50) as go:
        if go:
            retry = False
            try:
                bench_lm4b()
            except Exception as e:   # noqa: BLE001 - one-shot OOM retry
                if not (is_oom_error(e) and budget.remaining() > 60):
                    raise
                log(f"lm4B OOM ({e!r}); releasing and retrying once")
                retry = True
            if retry:
                # outside the except block: the exception (whose traceback
                # pins the half-built 4B model via frame locals) is dead
                release_device_memory()
                bench_lm4b()
    # nothing survives the 4B section by construction
    drop(hard=True)

    with section("60s_b1", 5, deps=("handler",)) as go:
        if go:
            run_dit("60s_b1", 60, 1, repeats=3)
    with section("30s_b8", 8, deps=("handler",)) as go:
        if go:
            run_dit("30s_b8", 30, 8, repeats=3)
    with section("10s_b1_think", 4, deps=("handler", "llm")) as go:
        if go:
            run_think("10s_b1_think", 10, 1, repeats=2)

    # the 1.7B planner geometry (throughput does not depend on weights)
    with section("lm1.7B_think60s_b1", 8, deps=("llm17",)) as go:
        if go:
            run_lm_only("lm1.7B_think60s_b1", target_duration=60, batch=1,
                        repeats=2)
    with section("lm1.7B_prefill2048_cfg", 2, deps=("llm17",)) as go:
        if go:
            lm = llm17()
            prompt2k = "a" * 2048
            lm.engine.generate_codes([prompt2k],
                                     unconditional_prompts=["b" * 2048],
                                     cfg_scale=2.0, n_codes=1, seed=0)
            _sync(device)                                         # warm
            t0 = time.perf_counter()
            lm.engine.generate_codes([prompt2k],
                                     unconditional_prompts=["b" * 2048],
                                     cfg_scale=2.0, n_codes=1, seed=1)
            _sync(device)
            pf_wall = time.perf_counter() - t0
            rows.append({
                "config": "lm1.7B_prefill2048_cfg", "lm_geom": "1.7B",
                "batch": 1, "thinking": True, "wall_s": round(pf_wall, 3),
                "prefill_tok_s": round(2 * 2048 / pf_wall, 0),
            })
            log(f"matrix lm1.7B_prefill2048_cfg: {rows[-1]}")
    # cross-request prefix reuse: back-to-back jobs share the chat
    # template's prefix KV; the row reports the reuse the engine counted
    with section("lm1.7B_prefix_reuse", 5, deps=("llm17",)) as go:
        if go:
            lm = llm17()
            st0 = dict(lm.engine.prefill_stats)
            for i in range(3):
                lm.generate_with_stop_condition(
                    f"prefix probe {i}", seed=20 + i, temperature=0.85,
                    cfg_scale=2.0, top_p=0.9, target_duration=10,
                    user_metadata={"duration": 10})
            st1 = lm.engine.prefill_stats
            # prompt_tokens counts the FULL prompts (reused prefix + delta)
            prompt = st1["prompt_tokens"] - st0["prompt_tokens"]
            reused = st1["reused_tokens"] - st0["reused_tokens"]
            rows.append({
                "config": "lm1.7B_prefix_reuse", "lm_geom": "1.7B",
                "thinking": True,
                "prompt_tokens": int(prompt),
                "reused_tokens": int(reused),
                "lm_prefix_reuse_pct": round(
                    100.0 * reused / max(1, prompt), 1),
            })
            log(f"matrix lm1.7B_prefix_reuse: {rows[-1]}")
    # the upstream thinking example: 30 s, batch 1, 8 steps, with think
    with section("30s_b1_think_lm1.7B", 10,
                 deps=("llm17", "handler")) as go:
        if go:
            run_think("30s_b1_think_lm1.7B", 30, 1, repeats=2,
                      llm_handler=llm17(), lm_geom="1.7B")

    # optional llm17 tails run here, while the bf16 trunk is resident
    with section("lm1.7B_think60s_b8", 18, deps=("llm17",), tail=True) as go:
        if go:
            run_lm_only("lm1.7B_think60s_b8", target_duration=60, batch=8,
                        repeats=2)
    with section("lm1.7B_think600s_b1", 85, deps=("llm17",),
                 tail=True) as go:
        if go:
            run_lm_only("lm1.7B_think600s_b1", target_duration=600, batch=1,
                        repeats=2)
    drop("llm17")               # bf16 trunk released before the w8a8 one

    # w8a8 1.7B planner: trunk weights stay int8 inside the decode loops
    def init_llm17q():
        lm = LLMHandler(dtype=dtype, device=device)
        lm.initialize(cfg=lm_cfg(LMConfig.qwen3_1_7b()), tokenizer=tok17(),
                      max_duration=600, seed=0, quantization="w8a8")
        p2 = lm.build_formatted_prompt_with_cot(
            "bench", "", "<think>\nduration: 60\n</think>")
        n2 = lm.build_formatted_prompt_with_cot(
            "bench", "", "<think>\nduration: 60\n</think>",
            is_negative_prompt=True)
        state["llm17q"] = (lm, p2, n2)
        return lm, p2, n2

    def run_codes(tag, n_codes, seed, repeats):
        lm, p2, n2 = state.get("llm17q") or init_llm17q()
        qkw = dict(unconditional_prompts=[n2], cfg_scale=2.0,
                   temperature=0.85, top_p=0.9, n_codes=n_codes)
        lm.engine.generate_codes([p2], seed=seed, **qkw)         # warm
        qwalls = []
        for i in range(repeats):
            t0 = time.perf_counter()
            lm.engine.generate_codes([p2], seed=seed + 1 + i, **qkw)
            _sync(device)
            qwalls.append(time.perf_counter() - t0)
        qwall, qspread, _ = _median_run(qwalls)
        rows.append({
            "config": tag, "lm_geom": "1.7B", "batch": 1, "thinking": True,
            "wall_s": qwall, "wall_spread": qspread,
            "decode_tok_s": round(n_codes / qwall, 1),
        })
        log(f"matrix {tag}: {rows[-1]}")

    with section("lm1.7B_codes300_w8a8", 12, deps=("llm17q",)) as go:
        if go:
            run_codes("lm1.7B_codes300_w8a8", 300, 0, repeats=3)
    with section("lm1.7B_codes3000_w8a8", 140, deps=("llm17q",),
                 tail=True) as go:
        if go:
            run_codes("lm1.7B_codes3000_w8a8", 3000, 10, repeats=2)
    drop("llm17q")

    # long-song tails reuse the still-live turbo handler + tiny LM
    with section("600s_b1", 14, deps=("handler",), tail=True) as go:
        if go:
            run_dit("600s_b1", 600, 1, repeats=2)
    with section("30s_b8_think", 10, deps=("handler", "llm"),
                 tail=True) as go:
        if go:
            run_think("30s_b8_think", 30, 8, repeats=2)

    # the turbo handler (the largest resident) goes before the base one
    drop("handler", "llm", hard=True)

    # base model, guided: 50 steps, CFG 7.0 with APG (the upstream
    # generate_music default)
    def base_handler():
        if "handler_b" not in state:
            h = _handler(device, tiny, "base")
            h.initialize_service(seed=0)
            state["handler_b"] = h
        return state["handler_b"]

    with section("base50_60s_b1", 10) as go:
        if go:
            base_handler()
            run_guided("base50_60s_b1", 60, 50, repeats=3)
    with section("base50_600s_b1", 55, tail=True) as go:
        if go:
            base_handler()
            run_guided("base50_600s_b1", 600, 50, repeats=2)
    drop("handler_b")
    state.clear()
    gc.collect()


# --------------------------------------------------------------- docs

def write_docs(payload: dict, rows: list, env: dict) -> None:
    extra = payload["extra"]
    hs = extra.get("headline_spread", [])
    lines = [
        "# Benchmarks of the PyTorch/CUDA port (measured)",
        "",
        f"Measured by `bench_torch.py` on {extra.get('card') or extra.get('device')}"
        " (warm, seeded random weights, 8-step turbo, bf16 unless noted).",
        "All walls are the MEDIAN of the repeats; spread = [min, max].",
        "`vs_baseline` divides the upstream README's A100 figure (< 2 s a",
        "60 s song) by the headline; no card of this repo measured it.",
        "",
        f"Device-to-host copy rate at run time: {env.get('d2h_MBps', '?')} "
        f"MB/s (spread {env.get('d2h_MBps_spread', '?')}); a 600 s song's",
        "VAE stage includes the copy of ~115 MB of int16 audio.",
        "",
        f"**Headline**: {payload['value']} s per 60 s song, spread {hs} "
        f"({payload['vs_baseline']}x the upstream baseline); K1 / K4 "
        f"launches a song: {extra.get('launches')}.",
        "",
        "`MFU %` is analytic DiT-decoder FLOPs / diffusion wall / the card's",
        "published dense peak (bf16, or int8 for w8a8 rows) - decoder",
        "trajectory only, condition encoder excluded.",
        "",
        "| config | duration | batch | think | wall s | spread | s/song | RTF | LM s | LM tok/s | DiT s | MFU % | VAE s |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for row in rows:
        if "error" in row or "skipped" in row:
            why = ("FAILED" if "error" in row
                   else f"SKIPPED ({row['skipped']})")
            lines.append(f"| {row['config']} | — | — | — | {why} | "
                         f"— | — | — | — | — | — | — | — |")
            continue
        if "lm_prefix_reuse_pct" in row:
            lines.append(
                f"| {row['config']} | — | — | on | "
                f"{row['lm_prefix_reuse_pct']}% of "
                f"{row['prompt_tokens']} prompt tokens served from the "
                f"cross-request prefix cache | — | — | — | — | — | — | "
                f"— | — |")
            continue
        lines.append(
            f"| {row['config']} | {row.get('duration_s', '—')} | "
            f"{row.get('batch', '—')} | "
            f"{'on' if row.get('thinking') else 'off'} | "
            f"{row.get('wall_s', '—')} | "
            f"{row.get('wall_spread', '—')} | "
            f"{row.get('seconds_per_song', '—')} | {row.get('rtf', '—')} | "
            f"{row.get('lm_s', '—')} | "
            f"{row.get('decode_tok_s', row.get('prefill_tok_s', '—'))} | "
            f"{row.get('diffusion_s', '—')} | "
            f"{row.get('mfu_pct', '—')} | "
            f"{row.get('vae_s', '—')} |")
    lines += [
        "",
        "Small thinking rows use the self-contained fallback LM (tiny",
        "random weights) to time the two-phase constrained decoding.",
        "`lm1.7B_*`/`lm4B_*` rows build the Qwen3 geometries (random",
        "weights): LM-only CFG-paired two-phase walls; the LM tok/s column",
        "is decode (or prefill) tokens/s of the conditional stream (CFG",
        "doubles the model batch), plus the upstream 30 s thinking example",
        "end to end.",
        "",
    ]
    os.makedirs(os.path.dirname(DOCS_PATH), exist_ok=True)
    with open(DOCS_PATH, "w", encoding="utf-8") as f:
        f.write("\n".join(lines))
    log(f"wrote {DOCS_PATH}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--headline-only", action="store_true",
                   help="the headline and the bandwidth probe, no matrix")
    p.add_argument("--write-docs", action="store_true",
                   help="also write docs/BENCHMARK_torch.md")
    p.add_argument("--docs-from-matrix", action="store_true",
                   help="rewrite the docs from BENCH_MATRIX_torch.json "
                        "(no device)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device; 'cpu' runs "
                        "the plain versions of the kernels)")
    p.add_argument("--tiny", action="store_true",
                   help="miniature seeded models (CPU rehearsals, tests)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.docs_from_matrix:
        with open(MATRIX_PATH, encoding="utf-8") as f:
            saved = json.load(f)
        write_docs(saved["headline"], saved["rows"], saved["env"])
        return 0
    from acestep_torch.pipeline.handler import resolve_device

    budget = Budget(float(os.environ.get("ACESTEP_BENCH_BUDGET_S", "960")))
    device = resolve_device(args.device)   # no card, no --device cpu: raises
    wall, spread, mfu, launches = headline(device, args.tiny)
    payload = {
        "metric": "seconds_per_song",
        "value": round(wall, 4),
        "unit": "s",
        "vs_baseline": round(BASELINE_SECONDS / wall, 3),
        "extra": {"headline_spread": spread, **mfu,
                  "device": device_name(device) or str(device),
                  "card": card_line() if device.type == "cuda" else None,
                  "launches": launches},
    }
    # early print: a later kill still leaves a parseable last stdout line
    print(json.dumps(payload), flush=True)
    env = probe_bandwidth(device) if device.type == "cuda" else {}
    log(f"d2h bandwidth probe: {env}")
    payload["extra"].update(env)

    if not args.headline_only:
        rows: list = []
        truncated: list = []
        try:
            with tempfile.TemporaryDirectory(prefix="bench_torch_") as out:
                matrix(rows, truncated, budget, device, out, args.tiny)
        except Exception as e:      # noqa: BLE001 - rows so far are kept
            log(f"MATRIX ABORTED: {e!r}")
        payload["extra"]["rows_done"] = sum(
            1 for r in rows if "error" not in r and "skipped" not in r)
        payload["extra"]["truncated"] = truncated[:8]
        with open(MATRIX_PATH, "w", encoding="utf-8") as f:
            json.dump({"headline": payload, "rows": rows,
                       "truncated": truncated, "env": env}, f, indent=1)
        log(f"wrote {MATRIX_PATH}")
        if args.write_docs:
            write_docs(payload, rows, env)
    log(f"total bench wall: {budget.elapsed():.1f}s "
        f"(budget {budget.total_s:.0f}s)")
    print(json.dumps(payload), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
