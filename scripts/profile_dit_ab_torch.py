"""A/B of the DiT denoising loop of the PyTorch/CUDA port: the flash kernel
(K1, `attention_impl="flash"`) against the plain dense attention
(`attention_impl="dense"`), with a per-stage wall. The counterpart of
scripts/profile_dit_ab.py.

Drives the 8-step turbo trajectory (the bench headline's diffusion stage)
at the 60 s and 600 s geometries (1500 and 15000 latent frames), batch 1,
bf16, full width (DiTConfig.turbo(), VAEConfig()), seeded random weights
(throughput does not depend on them). Each variant: one warm run, then the
median of 5; every stage ends on `torch.cuda.synchronize()`, and the
stages of the median run are reported: condition (the condition
encoders), cross_kv (the per-layer cross-attention K/V, once a
trajectory), each of the 8 steps, and the VAE decode.

The JAX tool also compares the scanned layer stack with an unrolled one.
An eager PyTorch loop has no scan, so that axis has no counterpart here.

One JSON line per variant, then the faster one. Runs on the CUDA device;
without one it raises, unless `--device cpu` (the plain versions, float32;
`--tiny` builds the miniature models):

    python3 scripts/profile_dit_ab_torch.py [--geo 60|600] [--trace]
    python3 scripts/profile_dit_ab_torch.py --device cpu --tiny --geo 60

--trace writes a torch.profiler trace of one run of the faster variant to
<tmp>/dit_trace (the system's temporary directory).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from typing import List, Optional

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench_torch  # noqa: E402  (the repo root, above)

GEOMETRIES = ((1500, "60s"), (15000, "600s"))
REPEATS = 5


def build(cfg, T: int, device, tiny: bool):
    """(model, vae, vae_cfg, inputs, x_init) of the headline's song at T
    latent frames: seeded weights and inputs, as bench_torch.headline."""
    from acestep_torch.models.dit import init_dit_params
    from acestep_torch.models.vae import init_vae_params

    _, vae_cfg = bench_torch.headline_configs(tiny)
    dtype = bench_torch._dtype(device)
    model = init_dit_params(cfg, torch.Generator(device).manual_seed(4),
                            dtype=dtype)
    vae = init_vae_params(vae_cfg, torch.Generator(device).manual_seed(5),
                          dtype=dtype)
    inputs, x_init = bench_torch.headline_inputs(cfg, T, device, dtype)
    return model, vae, vae_cfg, inputs, x_init


def trajectory(model, vae, cfg, vae_cfg, inputs, x_init, device):
    """One song, stage by stage, each ending on a synchronise: (latents,
    audio, {stage: seconds}). The steps are sample_turbo's ODE updates."""
    from acestep_torch.models.dit import dit_decoder, prepare_condition
    from acestep_torch.models.sampler import ConditionSet, build_turbo_schedule
    from acestep_torch.models.vae_tiled import tiled_decode

    stages = {}

    def timed(stage, fn):
        t0 = time.perf_counter()
        out = fn()
        bench_torch._sync(device)
        stages[stage] = time.perf_counter() - t0
        return out

    with torch.inference_mode():
        enc, _mask, ctx = timed("condition", lambda: prepare_condition(
            model, cfg, **inputs))
        cond = timed("cross_kv", lambda: ConditionSet.build(model, cfg, enc,
                                                            ctx))
        schedule = build_turbo_schedule(shift=3.0)
        ts = torch.tensor(schedule + [0.0], dtype=x_init.dtype,
                          device=x_init.device)
        xt = x_init
        for i in range(len(schedule)):
            t_vec = ts[i].expand(xt.shape[0])
            vt = timed(f"step{i}", lambda: dit_decoder(
                model, cfg, xt, t_vec, t_vec, cond.context_latents,
                cross_kv_cache=cond.cross_kv))
            xt = xt - vt * (ts[i] - ts[i + 1])
        audio = timed("decode", lambda: tiled_decode(vae, vae_cfg, xt))
    return xt, audio, stages


def run(tag: str, cfg, T: int, device, tiny: bool,
        repeats: int = REPEATS):
    """One variant's row, printed: the warm-up's wall, the median wall
    with its spread, and the median run's stages."""
    model, vae, vae_cfg, inputs, x_init = build(cfg, T, device, tiny)
    t0 = time.perf_counter()
    trajectory(model, vae, cfg, vae_cfg, inputs, x_init, device)
    first_s = time.perf_counter() - t0
    walls, stage_runs = [], []
    for _ in range(repeats):
        t0 = time.perf_counter()
        _, _, stages = trajectory(model, vae, cfg, vae_cfg, inputs, x_init,
                                  device)
        walls.append(time.perf_counter() - t0)
        stage_runs.append(stages)
    wall, spread, mid = bench_torch._median_run(walls)
    row = {"variant": tag, "T": T, "impl": cfg.attention_impl,
           "first_s": round(first_s, 4), "median_s": wall, "spread": spread,
           "stages": {k: round(v, 4) for k, v in stage_runs[mid].items()},
           "device": bench_torch.device_name(device) or str(device)}
    print(json.dumps(row), flush=True)
    return row


def main(argv: Optional[List[str]] = None) -> int:
    from acestep_torch.models.dit import resolve_attention_impl
    from acestep_torch.pipeline.handler import resolve_device
    from acestep_torch.utils.memory import release_device_memory

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--geo", choices=("60", "600"),
                   help="one geometry only (60 s or 600 s)")
    p.add_argument("--trace", action="store_true",
                   help="a torch.profiler trace of the faster variant")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    p.add_argument("--tiny", action="store_true",
                   help="miniature seeded models (CPU rehearsals, tests)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)   # no card, no --device cpu: raises
    base, _ = bench_torch.headline_configs(args.tiny)
    geos = [g for g in GEOMETRIES if args.geo is None
            or g[1] == f"{args.geo}s"]
    results = {}
    for T, label in geos:
        print(f"{label}: impl='auto' resolves to "
              f"{resolve_attention_impl(base)!r}", file=sys.stderr,
              flush=True)
        for impl in ("dense", "flash"):
            cfg = dataclasses.replace(base, attention_impl=impl)
            tag = f"{label} impl={impl}"
            row = run(tag, cfg, T, device, args.tiny)
            results[tag] = (row["median_s"], cfg, T)
            release_device_memory()
    best = min(results, key=lambda k: results[k][0])
    print(json.dumps({"best": best, "median_s": results[best][0]}),
          flush=True)

    if args.trace:
        _, cfg, T = results[best]
        model, vae, vae_cfg, inputs, x_init = build(cfg, T, device,
                                                    args.tiny)
        trajectory(model, vae, cfg, vae_cfg, inputs, x_init, device)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        out = os.path.join(tempfile.gettempdir(), "dit_trace")
        os.makedirs(out, exist_ok=True)
        with torch.profiler.profile(activities=acts) as prof:
            trajectory(model, vae, cfg, vae_cfg, inputs, x_init, device)
        prof.export_chrome_trace(os.path.join(out, "trace.json"))
        print(f"trace written to {out}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
