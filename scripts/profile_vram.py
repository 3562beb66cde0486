"""Per-request device-memory profiler of the PyTorch/CUDA port.

The counterpart of scripts/profile_hbm.py, under the reference's own name:
a seeded handler's requests across a duration x batch matrix, each row the
request's peak device memory. On the card the caching allocator's numbers
stand in for JAX's `memory_stats`: `peak_gb` is
`torch.cuda.max_memory_allocated` (reset before each request), `in_use_gb`
`torch.cuda.memory_reserved` after it, `limit_gb` the card's memory
(`torch.cuda.mem_get_info`). With `--device cpu` there are no device
numbers, and a row holds the analytic estimate instead (parameter bytes,
the widest decode stage's activations, the latents), labelled as such.
The init step's numbers go to stderr; every row also goes there as it
completes, and the report, with the card's name and power limit and the
kernels' launches, to stdout.

Usage:
  python scripts/profile_vram.py --durations 10,60 --batches 1,4
  python scripts/profile_vram.py --device cpu --tiny --durations 2
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def device_memory_stats(device):
    """The caching allocator's counterpart of JAX's `memory_stats`, or None
    off the card."""
    import torch

    if device.type != "cuda":
        return None
    _free, total = torch.cuda.mem_get_info(device)
    return {
        "bytes_in_use": torch.cuda.memory_reserved(device),
        "peak_bytes_in_use": torch.cuda.max_memory_allocated(device),
        "bytes_limit": total,
    }


def gb(n):
    return round(n / (1 << 30), 3)


def _tensor_bytes(module) -> int:
    return sum(p.numel() * p.element_size() for p in module.parameters())


def analytic_estimate(handler, duration: float, batch: int) -> dict:
    """Rough device-memory model where no memory numbers exist: parameters
    + activations of the widest stage (decode windows + latents)."""
    p_bytes = _tensor_bytes(handler.model) + _tensor_bytes(handler.vae)
    T = int(duration * 25)
    chunk, groups = handler._decode_plan(T)
    # decode activation ~ groups * chunk frames * hop samples * 2ch * widest
    # intermediate channel multiple (dtype bytes)
    act = groups * chunk * handler.vae_cfg.hop_length * 2 * 4
    latents = batch * T * handler.cfg.audio_acoustic_hidden_dim * 4
    return {"params_gb": gb(p_bytes),
            "decode_act_est_gb": gb(act),
            "latents_gb": gb(latents)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--durations", default="10,60")
    parser.add_argument("--batches", default="1")
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device; 'cpu' "
                             "reports the analytic estimate)")
    parser.add_argument("--tiny", action="store_true",
                        help="miniature models with seeded weights (tests)")
    args = parser.parse_args(argv)

    import torch

    from acestep_torch.pipeline.handler import resolve_device
    from profile_inference_torch import build_handler, device_report

    device = resolve_device(args.device)
    rows = []
    base = device_memory_stats(device)
    handler = build_handler(device, args.tiny)
    handler.initialize_service(seed=0)
    after_init = device_memory_stats(device)
    print("init:", json.dumps({
        "before": {k: gb(v) for k, v in base.items()} if base else None,
        "after": {k: gb(v) for k, v in after_init.items()}
        if after_init else None}), file=sys.stderr)

    for duration in [float(d) for d in args.durations.split(",")]:
        for batch in [int(b) for b in args.batches.split(",")]:
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            handler.generate_music(
                ["vram probe"] * batch, ["[inst]"] * batch,
                audio_duration=duration, batch_size=batch,
                seeds=list(range(batch)), infer_steps=args.steps)
            stats = device_memory_stats(device)
            row = {"duration_s": duration, "batch": batch}
            if stats:
                row.update({"peak_gb": gb(stats["peak_bytes_in_use"]),
                            "in_use_gb": gb(stats["bytes_in_use"]),
                            "limit_gb": gb(stats["bytes_limit"])})
            else:
                row.update(analytic_estimate(handler, duration, batch))
                row["note"] = "memory_stats unavailable; analytic estimate"
            rows.append(row)
            print(json.dumps(row), file=sys.stderr)

    print(json.dumps({"stages": rows, "device": device_report(device)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
