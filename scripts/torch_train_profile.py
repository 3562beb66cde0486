#!/usr/bin/env python3
"""Where a full-width LoRA training step, or a text2music request, of the
PyTorch port spends its time, on one NVIDIA GPU.

    python3 scripts/torch_train_profile.py [--frames 3000] [--steps 3]
    python3 scripts/torch_train_profile.py --text2music [--duration 60]
        [--batch 1] [--steps 3]

Builds the full-width DiT (`DiTConfig()`, bf16, seeded random weights) and
a rank-16 LoRA adapter on all 11 targets (fp32), runs two warm-up steps of
`acestep_torch.training.lora.make_lora_train_step` on a seeded batch of
`--frames` latent frames, times `--steps` steps with the host clock
(synchronised), then traces `--steps` more with `torch.profiler` and prints
one JSON line:

- `step_s`: median seconds per step, untraced;
- `device_busy_share`: the time in which a kernel ran (the union of the
  kernels' intervals) over the traced wall time; `1 - busy` is the device
  idle share;
- `kernels_per_step` and kernel milliseconds per step by category: the
  port's kernels (K1 forward, K2 dQ, K3 dK/dV), matrix products (cuBLAS /
  CUTLASS), and everything else;
- `top`: the ten kernels with the most time per step;
- the FLOPs of one step: `matmul_tflop_per_step`, aten's matrix products
  (mm, addmm, bmm, baddbmm: the projections with the adapters' merged
  weights, forward, recompute, dX and dW, and the adapters themselves)
  counted by `torch.utils.flop_counter.FlopCounterMode`;
  `decoder_attention_tflop_per_step`, the decoder's self-attention, which
  runs in K1-K3 outside aten and is counted from its (query, key) pairs:
  4 * heads * head_dim per pair for K1 (forward and recompute), 6 for K2
  and 8 for K3; and `matmul_share_of_bf16_peak`, the matrix products'
  FLOPs over what the card's dense bf16 peak (989 TFLOP/s) does in their
  kernel time.

With `--text2music` it builds the full-width turbo handler
(`DiTConfig.turbo()`, `VAEConfig()`, bf16, seeded random weights), runs two
warm-up requests of `--duration` seconds at `--batch` through
`acestep_torch.inference.generate_music`, times `--steps` more with the
host clock, traces one with `torch.profiler` and prints one JSON line:
`request_s` (median, untraced), `device_busy_ms`, `device_busy_share` and
its complement `device_idle_share` over the traced request (the tracer's
host overhead lengthens it), kernel milliseconds by
category (K1, K4, matrix products, other), and for the two device stages,
the diffusion (8 `dit_decoder` steps) and the VAE decode: each stage's
wall time in the trace, its busy share, its kernel milliseconds by
category, and `k1_share_of_stage` (K1's kernel time over the stage's wall
time), with the inputs as the path leaves them. A stage's window runs from
its host call to a synchronise at its end, added by this script, so the
kernels inside it are the stage's own.

It needs a CUDA device and prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CATEGORIES = (
    ("K1 flash fwd", ("flash_fwd_kernel",)),
    ("K4 snake conv", ("snake_unit_kernel", "snake_conv_small_kernel")),
    ("K2 flash bwd dq", ("flash_bwd_dq_kernel",)),
    ("K3 flash bwd dkv", ("flash_bwd_dkv_kernel",)),
    ("matmul", ("gemm", "cutlass", "xmma", "nvjet", "cublas", "wgmma")),
)

MATMUL_OPS = ("mm", "addmm", "bmm", "baddbmm")
PEAK_BF16_FLOPS = 989e12     # one H100 SXM, dense bf16 tensor cores


def category(name: str) -> str:
    low = name.lower()
    for label, keys in CATEGORIES:
        if any(k in low for k in keys):
            return label
    return "other"


def device_events(prof):
    """The trace's device activity as (start_us, end_us, name): kernels,
    copies and fills. The device-side ranges that `record_function`
    annotations leave (the stage windows below) are not work, and are
    left out."""
    from torch.autograd import DeviceType

    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events() if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation)


def busy_us(kernels, lo=None, hi=None) -> float:
    """Microseconds in which at least one kernel ran, inside [lo, hi]."""
    total, cur_a, cur_b = 0.0, None, None
    for a, b, _ in kernels:
        if lo is not None:
            a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def text2music(args) -> None:
    import tempfile

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from acestep_torch import inference
    from acestep_torch.config import DiTConfig, VAEConfig
    from acestep_torch.pipeline.handler import AceStepHandler

    handler = AceStepHandler(DiTConfig.turbo(), VAEConfig(),
                             dtype=torch.bfloat16)
    handler.initialize_service(seed=0)

    def stage(name, fn):
        def run(*a, **kw):
            with record_function("stage:" + name):
                out = fn(*a, **kw)
                torch.cuda.synchronize()
            return out
        return run

    handler._generate_latents = stage("diffusion", handler._generate_latents)
    handler.decode_latents = stage("vae_decode", handler.decode_latents)
    params = inference.GenerationParams(
        caption="upbeat synthpop, female vocals, 120 bpm",
        lyrics="[verse]\nneon lights across the bay\n[chorus]\nwe run",
        duration=args.duration, seed=22, thinking=False)
    with tempfile.TemporaryDirectory() as out_dir:
        config = inference.GenerationConfig(batch_size=args.batch,
                                            use_random_seed=False,
                                            output_dir=out_dir)

        def request():
            res = inference.generate_music(handler, None, params, config)
            if not res.success:
                raise RuntimeError(f"generate_music failed: {res.error}")
            return res

        for _ in range(2):
            request()
        times = []
        for _ in range(args.steps):
            t0 = time.perf_counter()
            request()
            times.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = request()
            traced_wall = time.perf_counter() - t0
    kernels = device_events(prof)
    windows = {e.name[len("stage:"):]: (e.time_range.start, e.time_range.end)
               for e in prof.events() if e.device_type == DeviceType.CPU
               and e.name.startswith("stage:")}

    def split(lo=None, hi=None):
        """Kernel microseconds by category inside [lo, hi] (clipped)."""
        by_cat = {}
        for a, b, name in kernels:
            if lo is not None:
                a, b = max(a, lo), min(b, hi)
            if b > a:
                by_cat[category(name)] = by_cat.get(category(name), 0.0) \
                    + b - a
        return by_cat

    total = split()
    stages = {}
    for name, (lo, hi) in windows.items():
        by_cat = split(lo, hi)
        wall_us = hi - lo
        stages[name] = {
            "wall_ms": wall_us / 1e3,
            "device_busy_share": busy_us(kernels, lo, hi) / wall_us,
            "kernel_ms": {k: v / 1e3 for k, v in by_cat.items()},
            "k1_share_of_stage": by_cat.get("K1 flash fwd", 0.0) / wall_us}
    busy = busy_us(kernels) / 1e6 / traced_wall
    print(json.dumps({
        "mode": "text2music", "duration": args.duration,
        "batch": args.batch, "requests": args.steps,
        "request_s": statistics.median(times), "traced_request_s": traced_wall,
        "device_busy_ms": busy * traced_wall * 1e3,
        "device_busy_share": busy, "device_idle_share": 1.0 - busy,
        "kernels": len(kernels),
        "kernel_ms": {k: v / 1e3 for k, v in total.items()},
        "stages": stages,
        "time_costs": res.extra_outputs["time_costs"],
        "device": torch.cuda.get_device_name(0)}), flush=True)


def main() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    from acestep_torch.config import DiTConfig
    from acestep_torch.lora.adapters import init_lora
    from acestep_torch.models.dit import init_dit_params
    from acestep_torch.models.sampler import build_turbo_schedule
    from acestep_torch.training.lora import make_lora_train_step
    from acestep_torch.training.step import tiny_batch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=3000)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--text2music", action="store_true",
                    help="trace a text2music request instead of a step")
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--batch", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_train_profile: no CUDA device is available")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip(),
          flush=True)
    if args.text2music:
        text2music(args)
        return

    cfg = DiTConfig()
    gen = torch.Generator("cuda").manual_seed(0)
    model = init_dit_params(cfg, gen, dtype=torch.bfloat16)
    adapter = init_lora(gen, model, rank=16, alpha=32.0)
    leaves = [x.requires_grad_() for pair in adapter["weights"].values()
              for x in pair.values()]
    step = make_lora_train_step(
        model, cfg, adapter["meta"],
        torch.optim.AdamW(leaves, lr=1e-4, weight_decay=0.01),
        discrete_timesteps=build_turbo_schedule(shift=3.0))
    batch = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
             for k, v in tiny_batch(cfg, gen, batch=1, frames=args.frames,
                                    text_len=64, lyric_len=256).items()}

    def run():
        loss = step(adapter["weights"], batch, generator=gen)
        torch.cuda.synchronize()
        return float(loss)

    for _ in range(2):
        run()
    times = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)

    with FlopCounterMode(display=False) as counter:
        run()
    flops_by_op = {str(op): n for op, n in
                   counter.get_flop_counts()["Global"].items()}
    matmul_flops = sum(n for op, n in flops_by_op.items()
                       if op.split(".")[-1] in MATMUL_OPS)
    patches = -(-args.frames // cfg.patch_size)
    i = torch.arange(patches)
    banded = int(((i[:, None] - i[None, :]).abs()
                  <= cfg.sliding_window).sum())
    pairs = sum(banded if cfg.layer_is_sliding(layer) else patches ** 2
                for layer in range(cfg.num_hidden_layers))
    attention_flops = ((4 + 4 + 6 + 8) * cfg.num_attention_heads
                       * cfg.head_dim * pairs)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            run()
        traced_wall = time.perf_counter() - t0
    kernels = device_events(prof)
    by_cat, by_name = {}, {}
    for a, b, name in kernels:
        by_cat[category(name)] = by_cat.get(category(name), 0.0) + b - a
        by_name[name] = by_name.get(name, 0.0) + b - a
    n = args.steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    matmul_ms = by_cat.get("matmul", 0.0) / 1e3 / n
    print(json.dumps({
        "frames": args.frames, "patches": patches,
        "steps": n, "step_s": statistics.median(times),
        "traced_step_s": traced_wall / n,
        "device_busy_share": busy_us(kernels) / 1e6 / traced_wall,
        "kernels_per_step": len(kernels) / n,
        "kernel_ms_per_step": {k: v / 1e3 / n for k, v in by_cat.items()},
        "top": [{"name": k[:120], "ms_per_step": v / 1e3 / n}
                for k, v in top],
        "matmul_tflop_per_step": matmul_flops / 1e12,
        "aten_tflop_by_op": {k: v / 1e12 for k, v in flops_by_op.items()},
        "decoder_attention_tflop_per_step": attention_flops / 1e12,
        "matmul_share_of_bf16_peak": (matmul_flops / PEAK_BF16_FLOPS
                                      / (matmul_ms / 1e3)),
        "device": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()
