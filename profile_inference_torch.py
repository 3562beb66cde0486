"""Profiler / benchmark harness of the PyTorch/CUDA port (acestep_torch).

The counterpart of profile_inference.py, with its modes, flags and report
keys:
- profile:        one configured generation with per-stage time costs
- benchmark:      duration x batch x steps matrix, JSON report with RTF
- tier-test:      iterate memory tiers via the ACESTEP_MAX_HBM_GB override
                  and validate init + a small generation per tier, each
                  tier in a child process of its own whose allocator is
                  capped at the tier's size less 1 GiB (tier 0 uncapped);
                  out of device memory is a tier's (or a boundary
                  sweep's) failed row, any other error is raised
- understand / create_sample / format_sample: LM utility modes

Metrics per run: wall seconds, seconds-per-song, real-time factor (audio
seconds generated per wall second), DiT steps/s, VAE decode RTF. Every
report also carries `device`: the device the numbers were taken on (on a
card its name and power limit as nvidia-smi prints them) and the launches
of the port's kernels in the run (K1, the flash attention forward; K4,
the VAE's snake + conv stack).

Runs on the CUDA device; `--device cpu` runs the plain PyTorch versions of
the kernels on the CPU in float32, `--tiny` builds miniature seeded models.

    python profile_inference_torch.py --mode profile --duration 30
    python profile_inference_torch.py --mode tier-test --tiers 8
    python profile_inference_torch.py --device cpu --tiny --duration 2
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

ROOT = os.path.dirname(os.path.abspath(__file__))
GIB = 1 << 30


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _device(args):
    """The run's torch device: the card unless `--device` names another;
    raises without a card unless the CPU was asked for."""
    from acestep_torch.pipeline.handler import resolve_device

    return resolve_device(args.device)


def _dtype(device):
    import torch

    return torch.float32 if device.type == "cpu" else torch.bfloat16


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_line(index: int = 0) -> Optional[str]:
    """`name, power.limit` of card `index` as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[index].strip() if index < len(out) else None


def kernel_launches() -> Dict[str, int]:
    """The port's serving kernels' launches in this process."""
    from acestep_torch.ops import flash_attention as fa
    from acestep_torch.ops import snake_conv as sc

    return {"K1": fa.launches, "K4": sc.launches}


def device_report(device, launches: Optional[Dict[str, int]] = None
                  ) -> Dict[str, Any]:
    """What the report's numbers were taken on, and the kernel launches
    behind them (this process's unless `launches` is given)."""
    import torch

    rep: Dict[str, Any] = {"device": str(device),
                           "launches": launches or kernel_launches()}
    if device.type == "cuda":
        index = device.index if device.index is not None \
            else torch.cuda.current_device()
        rep["name"] = torch.cuda.get_device_name(index)
        rep["card"] = card_line(index)
    return rep


def build_handler(device, tiny: bool):
    """The turbo handler on `device` (bf16 on a card, float32 on the CPU),
    full width or, with `tiny`, the miniature models; not initialised."""
    from acestep_torch.config import DiTConfig, VAEConfig
    from acestep_torch.pipeline.handler import AceStepHandler

    if tiny:
        # the tiny VAE emits latents at the tiny DiT's acoustic dim (64)
        return AceStepHandler(DiTConfig.tiny(),
                              VAEConfig.tiny(decoder_input_channels=64),
                              dtype=_dtype(device), frame_bucket=25,
                              min_frames=25, refer_frames=10, device=device)
    return AceStepHandler(dtype=_dtype(device), device=device)


def _init_handler(args, quantization: Optional[str] = None):
    from acestep_torch.parallel import parse_mesh_spec

    handler = build_handler(_device(args), args.tiny)
    t0 = time.time()
    handler.initialize_service(checkpoint_dir=args.checkpoint_dir,
                               vae_dir=args.vae_dir,
                               quantization=quantization)
    mesh_spec = parse_mesh_spec(getattr(args, "mesh", None))
    if mesh_spec:
        handler.enable_mesh(dp=mesh_spec[0], tp=mesh_spec[1])
    return handler, time.time() - t0


def _run_once(handler, *, duration: float, batch: int, steps: int,
              warm: bool = False) -> Dict[str, Any]:
    # the handler returns the audio on the host (int16 + peak, copied
    # back synchronously), so the wall ends after the device's work
    t0 = time.time()
    result = handler.generate_music(
        "an upbeat synthpop track with bright leads",
        "[inst]",
        audio_duration=duration, batch_size=batch, infer_steps=steps,
        seeds=42, save_dir=None,
    )
    wall = time.time() - t0
    costs = result.time_costs
    diff = costs.get("diffusion_time_cost", 0.0) or 1e-9
    vae = costs.get("vae_decode_time_cost", 0.0) or 1e-9
    # the handler clamps batch to the tier ceiling (effective_batch):
    # per-song metrics divide by what rendered, and the report says so
    actual = max(1, len(result.seeds or [])) or batch
    out = {
        "duration_s": duration, "batch": batch, "steps": steps,
        "warm": warm,
        "wall_s": round(wall, 3),
        "seconds_per_song": round(wall / actual, 3),
        "rtf": round(duration * actual / wall, 2),
        "diffusion_s": round(diff, 3),
        "dit_steps_per_s": round(steps / diff, 2),
        "vae_decode_s": round(vae, 3),
        "vae_rtf": round(duration * actual / vae, 2),
        "costs": {k: round(v, 4) for k, v in costs.items()},
    }
    if actual != batch:
        out["batch_clamped_to"] = actual
    return out


def mode_profile(args) -> Dict[str, Any]:
    handler, init_s = _init_handler(args)
    cold = _run_once(handler, duration=args.duration, batch=args.batch,
                     steps=args.steps)
    report: Dict[str, Any] = {"mode": "profile", "init_s": round(init_s, 2),
                              "cold": cold}
    if args.detailed:
        # cProfile the warm run: host-side dispatch/prep hotspots; device
        # time shows up in the synchronous copy of the audio to the host
        import cProfile
        import io
        import pstats

        prof = cProfile.Profile()
        prof.enable()
        warm = _run_once(handler, duration=args.duration, batch=args.batch,
                         steps=args.steps, warm=True)
        prof.disable()
        buf = io.StringIO()
        stats = pstats.Stats(prof, stream=buf).sort_stats("cumulative")
        stats.print_stats(25)
        report["detailed"] = buf.getvalue().splitlines()[:60]
    else:
        warm = _run_once(handler, duration=args.duration, batch=args.batch,
                         steps=args.steps, warm=True)
    report["warm"] = warm
    if args.llm_debug:
        report["llm_debug"] = _llm_token_throughput(args)
    return report


def _llm_token_throughput(args) -> Dict[str, Any]:
    """Token-level LM throughput: the constrained CoT loop, the codes loop
    and the generic sampler, each warmed once, then timed to the end of
    its device work."""
    llm = _init_llm(args)
    device = llm.device
    prompt = llm.build_formatted_prompt(
        "an upbeat synthpop track with bright leads", "[inst]")
    n_prompt = len(llm.tokenizer.encode(prompt))
    tables = llm._cot_tables({"duration": 30}, None)

    llm.engine.generate_cot_device(prompt, fsm_tables=tables,
                                   max_tokens=128, seed=0)
    _sync(device)
    t0 = time.time()
    toks = llm.engine.generate_cot_device(prompt, fsm_tables=tables,
                                          max_tokens=128, seed=1)
    _sync(device)
    cot_s = time.time() - t0

    llm.engine.generate_codes([prompt], n_codes=150, seed=0)
    _sync(device)
    t0 = time.time()
    llm.engine.generate_codes([prompt], n_codes=150, seed=1)
    _sync(device)
    codes_s = time.time() - t0

    llm.engine.generate([prompt], max_new_tokens=64, seed=2)
    _sync(device)
    t0 = time.time()
    out = llm.engine.generate([prompt], max_new_tokens=64, seed=3)
    _sync(device)
    generic_s = time.time() - t0
    return {
        "prompt_tokens": n_prompt,
        "cot_tokens": len(toks),
        "cot_wall_s": round(cot_s, 3),
        "cot_tokens_per_s": round(len(toks) / max(cot_s, 1e-9), 1),
        "codes_tokens_per_s": round(150 / max(codes_s, 1e-9), 1),
        "generic_tokens_per_s": round(
            len(out.token_ids[0]) / max(generic_s, 1e-9), 1),
    }


def _run_think_once(handler, llm, *, duration: float, batch: int,
                    steps: int, warm: bool = False) -> Dict[str, Any]:
    """One thinking (LM-planned) run through the inference facade."""
    from acestep_torch import inference
    from acestep_torch.inference import GenerationConfig, GenerationParams

    params = GenerationParams(
        caption="an upbeat synthpop track with bright leads",
        lyrics="[inst]", thinking=True, duration=float(duration), seed=42,
        inference_steps=steps)
    config = GenerationConfig(batch_size=batch, output_dir=None,
                              allow_lm_batch=True, use_random_seed=False)
    t0 = time.time()
    result = inference.generate_music(handler, llm, params, config)
    wall = time.time() - t0
    costs = result.extra_outputs.get("time_costs", {}) if result.success \
        else {}
    return {
        "duration_s": duration, "batch": batch, "steps": steps,
        "thinking": True, "warm": warm, "ok": bool(result.success),
        "wall_s": round(wall, 3),
        "seconds_per_song": round(wall / batch, 3),
        "rtf": round(duration * batch / wall, 2),
        "lm_s": round(costs.get("lm_time_cost", 0.0), 3),
        "diffusion_s": round(costs.get("diffusion_time_cost", 0.0), 3),
        "vae_decode_s": round(costs.get("vae_decode_time_cost", 0.0), 3),
    }


def mode_benchmark(args) -> Dict[str, Any]:
    """duration x batch x steps x thinking matrix (the reference's
    `--mode benchmark` matrix spans the same four dimensions; batches
    clamp by the memory tier at request time)."""
    handler, init_s = _init_handler(args)
    durations = [float(d) for d in args.durations.split(",")]
    batches = [int(b) for b in args.batches.split(",")]
    steps_list = ([int(s) for s in args.steps_list.split(",")]
                  if args.steps_list else [args.steps])
    think_opts = [False, True] if args.thinking_matrix else [False]
    llm = lm_info = None
    if True in think_opts:
        # the tier's real planner geometry (initialize_auto walks the
        # fallback ladder with seeded weights when no checkpoint dir is
        # given): a tiny fallback LM would make the thinking rows
        # meaningless against the reference matrix
        from acestep_torch.llm.handler import LLMHandler

        llm = LLMHandler(dtype=handler.dtype, device=handler.device)
        if getattr(args, "lm_checkpoint_dir", None):
            llm.initialize(checkpoint_dir=args.lm_checkpoint_dir)
        else:
            try:
                lm_info = llm.initialize_auto()
            except RuntimeError:
                # tiers without a planner budget (the CPU tier): the tiny
                # fallback, labelled so the rows are not read as real
                # planner latency
                llm.initialize()
                lm_info = {"size": "tiny-fallback", "quantization": None,
                           "downgraded": False}
            log(f"bench thinking planner: {lm_info}")
    rows: List[Dict[str, Any]] = []
    for duration in durations:
        for batch in batches:
            for steps in steps_list:
                for think in think_opts:
                    if think:
                        def runner(warm=False):
                            return _run_think_once(
                                handler, llm, duration=duration,
                                batch=batch, steps=steps, warm=warm)
                    else:
                        def runner(warm=False):
                            return _run_once(handler, duration=duration,
                                             batch=batch, steps=steps,
                                             warm=warm)
                    runner()                             # warm-up
                    rows.append(runner(warm=True))
                    log(f"bench d={duration} b={batch} s={steps} "
                        f"think={think}: {rows[-1]['seconds_per_song']}"
                        f"s/song rtf={rows[-1]['rtf']}")
    report = {"mode": "benchmark", "init_s": round(init_s, 2),
              "steps_list": steps_list, "rows": rows}
    if lm_info:
        report["lm_planner"] = lm_info
    return report


# ------------------------------------------------------------------
# tier-test: one child process a tier
# ------------------------------------------------------------------

_CHILD = ("import sys, profile_inference_torch as p; "
          "sys.exit(p.tier_child(sys.argv[1], sys.argv[2]))")


def tier_child(args_json: str, hbm: str) -> int:
    """A tier-test child: ACESTEP_MAX_HBM_GB and, on a card, the caching
    allocator's cap (the tier's nominal size less 1 GiB: a card of that
    size reports up to its nominal GiB and its CUDA context lies outside
    the allocator's count; tier 0 uncapped) are set before any handler is
    built, so no earlier allocation escapes the cap. Prints the tier's
    entry and its kernel launches as one JSON line."""
    gb = float(hbm)
    os.environ["ACESTEP_MAX_HBM_GB"] = str(gb)
    args = argparse.Namespace(**json.loads(args_json))
    import torch

    from acestep_torch.runtime_config import get_tier_config, set_global_config

    device = _device(args)
    cap = None
    if device.type == "cuda" and gb > 1:
        index = device.index if device.index is not None \
            else torch.cuda.current_device()
        total = torch.cuda.get_device_properties(index).total_memory
        cap = min(total, int((gb - 1) * GIB))
        torch.cuda.set_per_process_memory_fraction(cap / total, index)
    set_global_config(get_tier_config(gb))
    entry = tier_entry(args, gb)
    if cap is not None:
        entry["cap_gb"] = round(cap / GIB, 3)
        entry["max_memory_reserved_gb"] = round(
            torch.cuda.max_memory_reserved(index) / GIB, 3)
    print(json.dumps({"tier_entry": entry, "launches": kernel_launches()}),
          flush=True)
    return 0


def _oom_row(e: RuntimeError, row: Dict[str, Any]) -> Dict[str, Any]:
    """A tier's or a boundary sweep's failed row: out of device memory is
    the limit; anything else (a kernel fault, a bad argument) is raised,
    so that it cannot read as one."""
    from acestep_torch.utils.memory import is_oom_error

    if not is_oom_error(e):
        raise e
    return {**row, "ok": False, "error": str(e)[:200]}


def tier_entry(args, hbm: float) -> Dict[str, Any]:
    """One tier's row: init + a 10 s generation, then the boundary
    sweeps when asked for."""
    from acestep_torch.runtime_config import get_tier_config
    from acestep_torch.utils.memory import release_device_memory

    tier = get_tier_config(float(hbm))
    entry: Dict[str, Any] = {"hbm_gb": hbm, "tier": tier.name,
                             "max_batch": tier.max_batch,
                             "max_duration": tier.max_duration_s,
                             "lm": tier.lm_size}
    try:
        handler, init_s = _init_handler(args)
        run = _run_once(handler, duration=10.0,
                        batch=min(2, tier.max_batch), steps=4)
        entry.update(init_s=round(init_s, 2), ok=True,
                     seconds_per_song=run["seconds_per_song"])
    except RuntimeError as e:
        entry = _oom_row(e, entry)
        log(f"tier {tier.name}: {entry}")
        return entry

    if args.tier_boundary:
        # the lowest tier at which quantization can be off: bf16 and each
        # quantized mode, each measured alone
        entry["boundary"] = []
        handler = None
        release_device_memory()
        for quant in (None, "int8", "fp8", "w8a8"):
            row = {"quantization": quant or "bf16"}
            try:
                h2, _ = _init_handler(args, quantization=quant)
                r = _run_once(h2, duration=10.0, batch=1, steps=4)
                row.update(ok=True, wall_s=r["wall_s"])
            except RuntimeError as e:
                row = _oom_row(e, row)
            h2 = None
            release_device_memory()
            entry["boundary"].append(row)
            log(f"  boundary {row['quantization']}: {row}")

    if args.tier_batch_boundary:
        # the largest safe batch: 1, 2, 4, 8 until out of memory, with the
        # tier's batch clamp lifted (a clamped batch would render at the
        # cap and report a false 'ok')
        entry["batch_boundary"] = []
        if handler is None:
            handler, _ = _init_handler(args)
        handler.tier = dataclasses.replace(handler.tier, max_batch=8)
        max_ok = 0
        for batch in (1, 2, 4, 8):
            row = {"batch": batch}
            try:
                r = _run_once(handler, duration=10.0, batch=batch, steps=4)
                row.update(ok=True, seconds_per_song=r["seconds_per_song"])
            except RuntimeError as e:
                row = _oom_row(e, row)
            entry["batch_boundary"].append(row)
            log(f"  batch boundary {batch}: {row}")
            if not row["ok"]:
                break
            max_ok = batch
        entry["max_safe_batch"] = max_ok
    return entry


def _run_tier_child(args, hbm: float) -> Dict[str, Any]:
    """Runs `tier_child` in a process of its own; its log goes to this
    process's stderr. A child that fails is raised."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, json.dumps(vars(args)), str(hbm)],
        stdout=subprocess.PIPE, text=True, env=env)
    lines = [line for line in proc.stdout.splitlines()
             if line.startswith('{"tier_entry"')]
    if proc.returncode or not lines:
        raise RuntimeError(f"tier {hbm:g} GB: the child process exited "
                           f"{proc.returncode} (its traceback is above)")
    return json.loads(lines[-1])


def mode_tier_test(args) -> Dict[str, Any]:
    from acestep_torch.runtime_config import get_tier_config

    tiers = ([float(t) for t in args.tiers.split(",")] if args.tiers
             else [0.0, 8.0, 16.0, 32.0])
    results = []
    launches = {"K1": 0, "K4": 0}
    for hbm in tiers:
        out = _run_tier_child(args, hbm)
        results.append(out["tier_entry"])
        for k in launches:
            launches[k] += out["launches"][k]
        log(f"tier {get_tier_config(hbm).name}: "
            f"{'ok' if out['tier_entry']['ok'] else 'failed'}")
    return {"mode": "tier-test", "tiers": results,
            "boundary": args.tier_boundary,
            "batch_boundary": args.tier_batch_boundary,
            "device": device_report(_device(args), launches)}


def _init_llm(args):
    from acestep_torch.llm.handler import LLMHandler

    device = _device(args)
    llm = LLMHandler(dtype=_dtype(device), device=device)
    llm.initialize(checkpoint_dir=getattr(args, "lm_checkpoint_dir", None))
    return llm


def mode_understand(args) -> Dict[str, Any]:
    llm = _init_llm(args)
    codes = "".join(f"<|audio_code_{i % 64000}|>" for i in range(50))
    t0 = time.time()
    out = llm.understand(codes)
    return {"mode": "understand", "wall_s": round(time.time() - t0, 2),
            "output": out}


def mode_create_sample(args) -> Dict[str, Any]:
    llm = _init_llm(args)
    t0 = time.time()
    out = llm.create_sample(args.query or "a rainy day lofi track")
    return {"mode": "create_sample", "wall_s": round(time.time() - t0, 2),
            "output": out}


def mode_format_sample(args) -> Dict[str, Any]:
    llm = _init_llm(args)
    t0 = time.time()
    out = llm.format_sample("edm banger", "la la la")
    return {"mode": "format_sample", "wall_s": round(time.time() - t0, 2),
            "output": out}


MODES = {
    "profile": mode_profile,
    "benchmark": mode_benchmark,
    "tier-test": mode_tier_test,
    "understand": mode_understand,
    "create_sample": mode_create_sample,
    "format_sample": mode_format_sample,
}


def build_parser() -> argparse.ArgumentParser:
    """profile_inference.py's flags, plus `--device` and `--tiny`."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--mode", default="profile", choices=sorted(MODES))
    parser.add_argument("--checkpoint-dir", default=None)
    parser.add_argument("--vae-dir", default=None)
    parser.add_argument("--lm-checkpoint-dir", default=None)
    parser.add_argument("--mesh", default=os.environ.get("ACESTEP_MESH"),
                        help="multi-device DiT mesh 'DPxTP' or device count "
                             "(env: ACESTEP_MESH)")
    parser.add_argument("--duration", type=float, default=30.0)
    parser.add_argument("--durations", default="10,30,60")
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--batches", default="1,2")
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--steps-list", default=None,
                        help="benchmark mode: comma-separated steps "
                             "dimension (reference default matrix: 8,16)")
    parser.add_argument("--thinking-matrix", action="store_true",
                        help="benchmark mode: add the thinking True/False "
                             "dimension (runs the LM planner)")
    parser.add_argument("--query", default=None)
    parser.add_argument("--output", default=None,
                        help="write the JSON report here as well")
    parser.add_argument("--detailed", action="store_true",
                        help="cProfile the warm run (host-side hotspots)")
    parser.add_argument("--llm-debug", action="store_true",
                        help="LM token-level throughput (CoT/codes/generic)")
    parser.add_argument("--tier-boundary", action="store_true",
                        help="per tier: test bf16 + each quantization mode")
    parser.add_argument("--tier-batch-boundary", action="store_true",
                        help="per tier: escalate batch 1,2,4,8 until out "
                             "of memory")
    parser.add_argument("--tiers", default=None,
                        help="comma-separated memory GB values for "
                             "tier-test")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device; 'cpu' "
                             "runs the plain versions of the kernels in "
                             "float32)")
    parser.add_argument("--tiny", action="store_true",
                        help="miniature models with seeded weights (tests)")
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    device = _device(args)          # no card and no --device cpu: raises
    report = MODES[args.mode](args)
    report.setdefault("device", device_report(device))
    payload = json.dumps(report, indent=2, default=str)
    print(payload)
    if args.output:
        with open(args.output, "w", encoding="utf-8") as f:
            f.write(payload)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
