#!/usr/bin/env python3
"""GPU environment diagnostic for the PyTorch/CUDA port (acestep_torch).

The counterpart of `scripts/check_tpu.py`, under the reference's own name:
the torch build and its CUDA, the cards (name, power limit, memory,
compute capability), device memory and the tier that follows, the kernel
build toolchain (nvcc and the kernel library's cache, cc for the FLAC
helper), checkpoint resolution, the ACESTEP_* environment, and with
`--smoke` the port's two serving kernels launched against their plain
PyTorch versions.

Usage:
    python scripts/check_gpu.py                  # all passive checks
    python scripts/check_gpu.py --smoke          # + K1 and K4 on the card
    python scripts/check_gpu.py --device cpu     # the CPU run (no card)

Exit code 0 when every check passes (warnings allowed), 1 otherwise. With
no card the device check fails unless `--device cpu` (or `--cpu`) asks for
the CPU run; `--smoke` always needs a card.
"""
from __future__ import annotations

import argparse
import copy
import os
import shutil
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HEADER_WIDTH = 72
# kernels are compiled for sm_90a (acestep_torch/ops/_build.py)
MIN_CAPABILITY = (9, 0)
# the smoke test's limits, chip_smoke.py's for the same kernels: relative to
# max(1, max|plain|), the plain version in fp32 from the same bf16 inputs
TOL_K1_OUT = 2e-2
TOL_K1_LSE = 2e-3       # absolute; lse is fp32 from the same logits
TOL_K4 = 2e-2
# clock cycles a second the timer's spin kernel is sized with (an H100's
# boost clock, rounded up: a longer spin only waits longer)
SPIN_CYCLES_PER_S = 2.0e9

_FAILURES = []


def section(title: str) -> None:
    print(f"\n{'=' * HEADER_WIDTH}\n  {title}\n{'=' * HEADER_WIDTH}")


def ok(msg: str) -> None:
    print(f"[ok]   {msg}")


def warn(msg: str) -> None:
    print(f"[warn] {msg}")


def fail(msg: str) -> None:
    _FAILURES.append(msg)
    print(f"[FAIL] {msg}")


def card_lines() -> list:
    """`name, power.limit` of every card as nvidia-smi prints them; [] when
    nvidia-smi is absent or fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [line.strip() for line in out.splitlines() if line.strip()]


def check_install() -> None:
    section("Python / library versions")
    print(f"python: {sys.version.split()[0]} ({sys.executable})")
    try:
        import torch

        cuda = torch.version.cuda
        ok(f"torch {torch.__version__} (CUDA {cuda})" if cuda else
           f"torch {torch.__version__}")
        if not cuda:
            warn("this torch is a CPU-only build: the kernels cannot run")
    except ImportError as e:
        fail(f"torch not importable: {e}")
    try:
        import numpy

        ok(f"numpy {numpy.__version__}")
    except ImportError as e:
        fail(f"numpy not importable: {e}")
    try:
        import safetensors

        ok(f"safetensors {safetensors.__version__}")
    except ImportError:
        warn("safetensors not importable: checkpoint loading reads "
             "safetensors files itself, but tests and tools that write "
             "them need the package")


def check_devices(device: str) -> bool:
    """Lists the cards; True when the run can use one."""
    section("CUDA devices")
    import torch

    cpu_run = device == "cpu"
    if not torch.cuda.is_available():
        if cpu_run:
            warn("no CUDA device (CPU run requested: every kernel runs its "
                 "plain PyTorch version)")
        else:
            fail("no CUDA device is available")
            print("  remediation: run on a machine with an NVIDIA card and "
                  "a CUDA build of torch, or pass --device cpu to check "
                  "everything else.")
        return False
    cards = card_lines()
    n = torch.cuda.device_count()
    ok(f"{n} CUDA device(s)")
    for i in range(n):
        props = torch.cuda.get_device_properties(i)
        cap = (props.major, props.minor)
        card = cards[i] if i < len(cards) else f"{props.name}, power limit " \
                                                "not read (nvidia-smi)"
        print(f"       - cuda:{i}: {card}; {props.total_memory / 2**30:.1f} "
              f"GiB; compute capability {cap[0]}.{cap[1]}")
        if cap < MIN_CAPABILITY:
            warn(f"cuda:{i} is below sm_90: the port's kernels are built "
                 f"for sm_90a (Hopper) and will not load on it")
    if cpu_run:
        warn("CPU run requested: the cards above are not used")
    return not cpu_run


def check_tier(use_card: bool) -> None:
    section("Memory / tier policy")
    from acestep_torch.runtime_config import (detect_hbm_gb, get_tier_config,
                                              lm_fallback_plan)

    if use_card:
        import torch

        free, total = torch.cuda.mem_get_info()
        in_use, reserved = (torch.cuda.memory_allocated(),
                            torch.cuda.memory_reserved())
        ok(f"device memory: {total / 2**30:.1f} GiB ({free / 2**30:.1f} GiB "
           f"free); caching allocator {in_use / 2**30:.2f} GiB in use, "
           f"{reserved / 2**30:.2f} GiB reserved")
    hbm = detect_hbm_gb() if use_card else detect_hbm_gb("cpu")
    tier = get_tier_config(hbm)
    ok(f"tier: {tier.name} (memory {hbm:g} GB -> tier >= {tier.hbm_gb:g} GB)")
    print(f"       max duration {tier.max_duration_s}s, max batch "
          f"{tier.max_batch}, VAE decode chunk {tier.decode_chunk}")
    if tier.lm_size:
        print(f"       LM planner: {tier.lm_size} "
              f"(quant={tier.lm_quantization or 'bf16'}); "
              f"fallback ladder: {lm_fallback_plan(tier)}")
    else:
        print("       LM planner: disabled at this tier "
              "(thinking/sample/format modes unavailable)")
    if tier.notes:
        print(f"       note: {tier.notes}")
    if os.environ.get("ACESTEP_MAX_HBM_GB"):
        warn(f"ACESTEP_MAX_HBM_GB={os.environ['ACESTEP_MAX_HBM_GB']} "
             "overrides detection (tier simulation)")


def check_toolchain(use_card: bool) -> None:
    section("Kernel build toolchain")
    from acestep_torch.ops import _build
    from acestep_torch.utils import flac_native

    try:
        ok(f"nvcc: {_build._nvcc()}")
    except RuntimeError as e:
        (fail if use_card else warn)(str(e))
    key = _build._key()
    lib = _build.BUILD_ROOT / key / _build.LIB_NAME
    if lib.exists():
        ok(f"kernel library {key} built: {lib}")
    else:
        print(f"       kernel library {key}: not built yet (the first "
              f"kernel launch, or --smoke, builds it into {lib.parent})")
    cc = os.environ.get("CC", "cc")
    if flac_native._load() is not None:
        ok(f"FLAC helper built with {shutil.which(cc) or cc}")
    else:
        warn(f"FLAC helper not built ({cc} unavailable or failed, or "
             "ACESTEP_NO_NATIVE_FLAC=1): the pure-Python encoder is used, "
             "same bytes, slower")


def check_checkpoints() -> None:
    section("Checkpoint resolution")
    from acestep_torch.utils.downloads import (REPO_IDS, has_egress,
                                               resolve_local)

    any_found = False
    for name in sorted(REPO_IDS):
        path = resolve_local(name)
        if path:
            ok(f"{name}: {path}")
            any_found = True
        else:
            print(f"       {name}: not present locally")
    if not any_found:
        if os.environ.get("HF_HUB_OFFLINE", "") not in ("", "0"):
            warn("no checkpoints found; HF_HUB_OFFLINE is set, so the hubs "
                 "were not probed — random weights will be used")
        elif has_egress():
            warn("no checkpoints found — `python -m acestep_torch.utils."
                 "downloads_cli` fetches them (HF/ModelScope reachable)")
        else:
            warn("no checkpoints found and no hub reachable — random "
                 "weights will be used (geometry/perf work only)")


def check_env() -> None:
    section("ACESTEP_* environment")
    keys = sorted(k for k in os.environ if k.startswith("ACESTEP_"))
    if not keys:
        print("       (none set — defaults active; see .env.example)")
    for k in keys:
        val = os.environ[k]
        shown = val if "KEY" not in k else val[:6] + "..."
        print(f"       {k}={shown}")
    for k in ("PORT", "SERVER_NAME"):
        if os.environ.get(k):
            print(f"       {k}={os.environ[k]}")


def device_ms(fn, reps: int = 20) -> float:
    """Mean device time of `fn` over `reps` calls, read with CUDA events
    while a spin kernel holds the device until the host has enqueued every
    call, so the host's cost of a call does not enter the reading (the
    reading also holds when a call takes the device more than twice what
    it takes the host; chip_smoke.py's `cuda_ms`, shortened)."""
    import torch

    fn()
    torch.cuda.synchronize()
    one_call_s = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        one_call_s = min(one_call_s, time.perf_counter() - t0)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    cycles = int(2 * (time.perf_counter() - t0) * SPIN_CYCLES_PER_S) \
        + 1_000_000
    torch.cuda.synchronize()
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        caught_up = start.query()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / reps
        if not caught_up or ms > 2e3 * one_call_s:
            return ms
        cycles *= 2
    raise RuntimeError("the device caught up with the host four times; the "
                       "reading would include host time")


def _smoke_k1(window) -> None:
    import torch

    from acestep_torch.ops import flash_attention as fa

    B, L, (Hq, Hkv), D = 1, 750, (16, 8), 128
    g = torch.Generator("cuda").manual_seed(1 if window is None else 2)
    q, k, v = (torch.randn((B, L, h, D), generator=g, device="cuda")
               .to(torch.bfloat16) for h in (Hq, Hkv, Hkv))
    out, lse = fa.flash_attention_cuda(q, k, v, window)
    ref, ref_lse = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                            window)
    err = (out.float() - ref).abs().max().item()
    rel = err / max(1.0, ref.abs().max().item())
    lse_err = (lse - ref_lse).abs().max().item()
    name = f"K1 flash attention ({B}, {L}), {Hq}/{Hkv} heads, " + (
        "full" if window is None else f"banded W={window}")
    kernel_ms = device_ms(lambda: fa.flash_attention_cuda(q, k, v, window))
    plain_ms = device_ms(lambda: fa.flash_attention_plain(q, k, v, window), 5)
    times = f"kernel {kernel_ms:.5f} ms, plain {plain_ms:.4f} ms"
    if rel < TOL_K1_OUT and lse_err < TOL_K1_LSE:
        ok(f"{name}: max abs err {err:.3e} (rel {rel:.2e} < {TOL_K1_OUT}), "
           f"lse err {lse_err:.2e} (< {TOL_K1_LSE}); {times}")
    else:
        fail(f"{name}: max abs err {err:.3e} (rel {rel:.2e}, limit "
             f"{TOL_K1_OUT}), lse err {lse_err:.2e} (limit {TOL_K1_LSE}); "
             f"{times}")


def _smoke_k4() -> None:
    import torch

    from acestep_torch.models.vae import ResUnit
    from acestep_torch.ops import snake_conv as sc

    N, L, C = 4, 491520, 128
    g = torch.Generator("cuda").manual_seed(7)
    units = []
    for _ in range(3):
        u = ResUnit(C, device="cuda", dtype=torch.float32)
        with torch.no_grad():
            for p in u.parameters():
                p.normal_(0.0, 0.05, generator=g)
            for sn in (u.snake1, u.snake2):
                sn.alpha.normal_(0.0, 0.3, generator=g)
                sn.beta.normal_(0.0, 0.3, generator=g)
        units.append(u.to(torch.bfloat16))
    x = torch.randn((N, L, C), generator=g, device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        got = sc.res_unit_stack_cuda(units, x)
        # the plain version in fp32 from the same bf16 weights and input
        ref = sc.res_unit_stack_plain([copy.deepcopy(u).float()
                                       for u in units], x.float())
        err = (got.float() - ref).abs().max().item()
        rel = err / max(1.0, ref.abs().max().item())
        del ref, got
        torch.cuda.empty_cache()
        name = f"K4 snake + conv stack ({N}, {L}, {C})"
        kernel_ms = device_ms(lambda: sc.res_unit_stack_cuda(units, x))
        plain_ms = device_ms(lambda: sc.res_unit_stack_plain(units, x), 3)
        times = f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.3f} ms"
    if rel < TOL_K4:
        ok(f"{name}: max abs err {err:.3e} (rel {rel:.2e} < {TOL_K4}); "
           f"{times}")
    else:
        fail(f"{name}: max abs err {err:.3e} (rel {rel:.2e}, limit "
             f"{TOL_K4}); {times}")


def check_smoke(use_card: bool) -> None:
    section("On-device smoke test (K1, K4 against their plain versions)")
    if not use_card:
        fail("no card: --smoke launches the kernels on a CUDA device")
        return
    import torch

    from acestep_torch.ops import _build

    cards = card_lines() or [torch.cuda.get_device_name(0)]
    print(f"       card: {cards[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    try:
        _build.library()
    except RuntimeError as e:
        fail(f"kernel library build failed: {e}")
        return
    ok(f"kernel library loaded in {time.time() - t0:.1f}s")
    for name, case in (("K1 full", lambda: _smoke_k1(None)),
                       ("K1 banded", lambda: _smoke_k1(128)),
                       ("K4", _smoke_k4)):
        try:
            case()
        except (RuntimeError, ValueError, TypeError) as e:
            fail(f"{name}: launch failed: {e}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) checks the card; 'cpu' is "
                             "the CPU run, where no card is not a failure")
    parser.add_argument("--cpu", dest="device", action="store_const",
                        const="cpu", help="the same as --device cpu")
    parser.add_argument("--smoke", action="store_true",
                        help="launch K1 and K4 on the card against their "
                             "plain versions")
    args = parser.parse_args(argv)
    _FAILURES.clear()

    check_install()
    use_card = check_devices(args.device)
    check_tier(use_card)
    check_toolchain(use_card)
    check_checkpoints()
    check_env()
    if args.smoke:
        check_smoke(use_card)

    section("Summary")
    if _FAILURES:
        print(f"[RESULT] {len(_FAILURES)} check(s) FAILED:")
        for f in _FAILURES:
            print(f"  - {f}")
        return 1
    print("[RESULT] environment looks good")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
