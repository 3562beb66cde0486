#!/usr/bin/env python3
"""Where the PyTorch port's 5 Hz LM planner spends its time, on one NVIDIA
GPU.

    python3 scripts/torch_lm_profile.py [--size 4B] [--fill 400]
        [--slots 768] [--duration 60] [--quantization w8a8]

Builds the planner of `--size` (`LMConfig.for_size`, bf16, seeded random
weights, the built-in tokenizer with 64000 audio codes; with
`--quantization`, the trunk quantized in that mode and, for w8a8, the
int8 head copy and the int8 KV cache) and prints one JSON line:

- `step`: one decode step at rows 2 ([cond; uncond]), `--fill` tokens in a
  `--slots` cache, the CoT's head window: 8 eager steps traced with
  `torch.profiler` give the kernels a step launches and their device
  milliseconds by category (matrix products, attention (softmax, the
  attention's batched products' operand copies are 'other'), index
  writes, casts and copies, other elementwise) and the ten costliest
  kernels; 8 graph replays traced the same way give the replay's wall,
  its kernel milliseconds and its busy share (kernel time over wall);
- `plan`: one greedy two-phase plan (CFG 2, `--duration` seconds of
  codes), timed untraced after a warm-up and traced once: the device busy
  share over the plan and kernel milliseconds by category;
- the card's name and power limit (nvidia-smi).

It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CATEGORIES = (
    ("matmul", ("gemm", "gemv", "cutlass", "xmma", "nvjet", "cublas",
                "wgmma", "splitk")),
    ("softmax", ("softmax",)),
    ("index", ("index", "scatter", "gather")),
    ("copy_cast", ("copy", "convert")),
)


def category(name: str) -> str:
    low = name.lower()
    for label, keys in CATEGORIES:
        if any(k in low for k in keys):
            return label
    return "elementwise_other"


def kernels_of(prof):
    """(start_us, end_us, name) of the trace's device activity."""
    from torch.autograd import DeviceType

    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events() if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation)


def busy_us(kernels) -> float:
    """Microseconds in which at least one kernel ran."""
    total, cur_a, cur_b = 0.0, None, None
    for a, b, _ in kernels:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def split_ms(kernels, per: int = 1) -> dict:
    out = {}
    for a, b, name in kernels:
        out[category(name)] = out.get(category(name), 0.0) + (b - a) / 1e3
    return {k: v / per for k, v in sorted(out.items())}


def top(kernels, per: int, n: int = 10) -> list:
    by = {}
    for a, b, name in kernels:
        t, c = by.get(name, (0.0, 0))
        by[name] = (t + (b - a) / 1e3, c + 1)
    rows = sorted(by.items(), key=lambda kv: -kv[1][0])[:n]
    return [{"kernel": k[:90], "ms_per_step": t / per, "calls_per_step":
             c / per} for k, (t, c) in rows]


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--size", default="4B")
    p.add_argument("--fill", type=int, default=400)
    p.add_argument("--slots", type=int, default=768)
    p.add_argument("--duration", type=float, default=60.0)
    p.add_argument("--quantization", default=None)
    args = p.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from acestep_torch.config import LMConfig
    from acestep_torch.llm.generator import _GraphStep
    from acestep_torch.llm.handler import LLMHandler
    from acestep_torch.llm.tokenizer import SimpleTokenizer
    from acestep_torch.models.lm import KVCache

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    llm = LLMHandler(dtype=torch.bfloat16)
    llm.initialize(cfg=LMConfig.for_size(args.size),
                   tokenizer=SimpleTokenizer(num_audio_codes=64_000),
                   quantization=args.quantization)
    eng = llm.engine
    cfg, V = eng.cfg, eng.vocab_use
    cache = KVCache.create(cfg, 2, args.slots, dtype=eng.dtype,
                           quantized=eng.kv_quant, device=eng.device)
    row_lens = torch.full((2,), args.fill, dtype=torch.long,
                          device=eng.device)
    toks = torch.zeros(2, dtype=torch.long, device=eng.device)
    graph = _GraphStep(eng._step_eager, cache, row_lens, 0, V)
    runs = {"eager": lambda: eng._step_eager(toks, cache, row_lens, 0, V),
            "graph": lambda: graph(toks, row_lens)}
    step = {}
    for name, fn in runs.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(8):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / 8
        ks = kernels_of(prof)
        step[name] = {"wall_ms": wall * 1e3,
                      "kernels_per_step": len(ks) / 8,
                      "kernel_ms": sum(b - a for a, b, _ in ks) / 8e3,
                      "busy_share": busy_us(ks) / 8e3 / (wall * 1e3),
                      "kernel_ms_by_category": split_ms(ks, 8),
                      "top": top(ks, 8)}
    del graph, cache

    kw = dict(target_duration=args.duration, seed=0, cfg_scale=2.0,
              metadata_temperature=0.0, codes_temperature=0.0)
    caption = "melodic house, airy pads, female vocals"
    llm.plan(caption, "[verse]\nlights on the water", **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    llm.plan(caption, "[verse]\nlights on the water", **kw)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = llm.plan(caption, "[verse]\nlights on the water", **kw)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    ks = kernels_of(prof)
    print(json.dumps({
        "size": args.size, "quantization": args.quantization,
        "kv_quant": eng.kv_quant, "rows": 2, "slots": args.slots,
        "fill": args.fill,
        "head_rows": V, "step": step,
        "plan": {"plan_s": plan_s, "traced_s": traced,
                 "cot_tokens": len(llm.tokenizer.encode(res["cot_text"])),
                 "codes": res["audio_codes"].count("<|audio_code_"),
                 "device_busy_share": busy_us(ks) / 1e6 / traced,
                 "kernels": len(ks),
                 "kernel_ms_by_category": split_ms(ks)},
        "card": card}), flush=True)


if __name__ == "__main__":
    main()
