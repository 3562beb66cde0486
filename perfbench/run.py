#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once, on the card this process sees.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Sets up the cell through the system module
its configuration names (`perfbench/systems/<system>.py`: seeded weights
drawn on the card, the port's handlers, a warm-up of every shape the mix
uses) and the server or facade its traffic mix names, opens the window,
drives the mix for `--seconds`, waits up to the mix's `late_s` for
answers still due, then has the system judge a seeded sample of them
against its plain reference. With `--trace 1` the port's own span tracer
is on over the window (off with `--trace 0`): its spans and the change in
its counters are the run's, beside a device trace of a stretch of the
window. The last line of stdout is the result: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics with `--trace 0`, its
per-layer ones with `--trace 1`), `device` (with the traced sub-window's
`busy_s` and `window_s` under `--trace 1`), `breakdown` when traced and
the stretch kept its kernel records, and last `checks`, each number
`correct` compared beside its limit; the same numbers end stderr.

Exits 2 without a result when no CUDA card is available or fewer than the
cell asks for, 3 when a JAX module or the JAX package was loaded, 4 when
a traced run read no device operation.
"""

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (HERE, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

# top-level module names no process of the benchmark may load
FORBIDDEN = ("jax", "jaxlib", "flax", "acestep_tpu", "bench", "bench_torch")
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
              "torch_extensions", "CUDA_CACHE_PATH": "nv",
              "TORCHINDUCTOR_CACHE_DIR": "inductor"}


def cache_env(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (`build/` holds the port's kernel library too); no library loads a
    JAX or TensorFlow backend of its own."""
    for var, sub in CACHE_DIRS.items():
        path = os.path.join(root, "build", "perfbench-cache", sub)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"
    os.environ["USE_JAX"] = "0"


def loaded_forbidden() -> list:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def sub_window(mix: dict, seconds: float) -> tuple:
    """The mix's traced stretch [a, b] of the window, scaled into a
    shorter window when it does not fit."""
    a, b = mix["trace_window_s"]
    if b > 0.9 * seconds:
        f = 0.9 * seconds / b
        a, b = a * f, b * f
    return a, b


def execute(spec, seed: int, seconds: float, trace: bool, device,
            t_process: float = T_PROCESS, hook=None):
    """Set up, drive and judge one run -> (measure.Run, metrics, checks).
    `hook(handlers)` runs after set-up, before the window (the tests plant
    faults through it)."""
    import torch

    from harness import drivers, measure, program, traffic
    from harness.spec import read_all
    from harness.trace import Tracer

    mix, system = spec.mix, spec.system
    rec = program.Recorder()
    port = program.PortTrace() if trace else None
    out_dir = tempfile.mkdtemp(prefix="perfbench-songs-")
    tracer = None
    try:
        handlers = system.build(spec.conf, seed, device)
        rec.install(kernels=trace)
        system.install(rec, handlers)
        system.warm(handlers, mix, seed, out_dir)
        driver = drivers.DRIVERS[mix["driver"]](handlers, mix, out_dir)
        reqs = traffic.requests(mix, seed, seconds,
                                count=mix.get("closed_count", 0))
        if hasattr(driver, "warm_http"):
            driver.warm_http(traffic.requests(dict(mix, loop="closed"),
                                              seed ^ 0x77, 0, count=1)[0])
        if hook is not None:
            hook(handlers)
        if trace:
            tracer = Tracer(rec, device, *sub_window(mix, seconds), seconds)
            tracer.prepare()
        program.synchronize(device)
        rec.spans.clear()
        rec.songs.clear()
        rec.renders.clear()
        if port is not None:
            port.open()
        w0 = time.monotonic() + 0.2
        setup_s = w0 - t_process
        # the window runs on a thread of its own: the main thread keeps
        # the profiler, which records only from the thread it began on
        done = {}

        def drive():
            try:
                done["records"] = driver.window(reqs, w0, seconds,
                                                mix["late_s"])
            except BaseException as e:  # re-raised on the main thread
                done["error"] = e

        th = threading.Thread(target=drive, name="perfbench-window")
        th.start()
        if tracer is not None:
            tracer.run(w0)
        th.join()
        program_spans, dropped, counters = (port.close() if port is not None
                                            else (None, 0, None))
        if "error" in done:
            raise done["error"]
        records = done["records"]
        driver.close()
        for r in records:
            if r["file"] and os.path.exists(r["file"]):
                r["bytes"] = os.path.getsize(r["file"])
        cuda = torch.device(device).type == "cuda"
        run = measure.Run(
            conf=spec.conf, w0=w0, records=records, setup_s=setup_s,
            memory_peak_bytes=(torch.cuda.max_memory_allocated(device)
                               if cuda else 0),
            card=torch.cuda.get_device_name(device) if cuda else "cpu",
            coalesced=getattr(driver, "coalesced", None),
            trace=tracer.summary() if tracer is not None else None,
            system=system, program_spans=program_spans,
            spans_dropped=dropped, counters=counters)
        if tracer is not None:
            report_trace(run, tracer)
        songs = rec.songs
        rec.uninstall()
        del handlers, driver
        program.release()
        checks = system.judge(spec.conf, seed, records, songs, device,
                              k=mix["correct_sample"], renders=rec.renders)
    finally:
        if port is not None and port.trace is not None:
            port.trace.disable()
        rec.uninstall()
        shutil.rmtree(out_dir, ignore_errors=True)
    return run, read_all(spec.metrics(trace), run, spec.root), checks


def report_trace(run, tracer) -> None:
    """On stderr: what the traced stretch held, a loss of its kernel
    records, the port's spans and counters over the window, and the
    stretch's idle cut at the port's span boundaries, by the innermost
    span open on the rendering thread."""
    from harness import spans
    from harness.trace import K1_NAMES, K4_NAMES

    t = run.trace or {}

    def say(text):
        print("perfbench: " + text, file=sys.stderr)

    say(f"traced {tracer.t_start} -> {tracer.t_stop}: events {tracer.kinds}, "
        f"launches {tracer.launches}, "
        + ", ".join(f"{k} calls {t[k]['calls']} kernels {t[k]['kernels']} "
                    f"paired {len(t[k]['pairs'])}"
                    for k in ("k1", "k4") if k in t)
        + f", launches without a kernel {tracer.unmatched}"
        + f", error {tracer.error}")
    if t and not t["complete"]:
        lost, n = t["lost"]
        say(f"the traced stretch lost the kernel records of {lost} of its "
            f"{n} launches after {len(tracer.unmatched)} takes: its device "
            "metrics and breakdown read null")
    got = run.program_spans or []
    say(f"program spans {len(got)}, dropped by the ring {run.spans_dropped}, "
        f"counters over the window {run.counters}")
    traced = spans.stretch_and_gaps(run)
    if not got or traced is None:
        return
    stretch, gaps = traced
    split = spans.split_idle(stretch, gaps, got, spans.rendering_threads(got))
    idle, _inside, http = spans.diffusion_idle(stretch, gaps, got)
    for name, seconds in sorted(split.items(), key=lambda x: -x[1]):
        say(f"idle under {name}: {seconds} s")
    k1 = spans.launched_inside(tracer.events, K1_NAMES,
                               spans.named(got, lambda n: n.startswith("dit.")))
    k4 = spans.launched_inside(tracer.events, K4_NAMES,
                               spans.named(got, lambda n: n == "vae"))
    say(f"diffusion idle {idle} s, of it under serve.http {http} s; K1 "
        f"launched inside dit.* {k1}%, K4 inside vae {k4}%")


def verdict(checks: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number the limits file
    names is at or under its limit; a number without a limit fails."""
    out = {}
    ok = bool(checks.get("sampled"))
    for name, value in checks.items():
        if name == "sampled":
            continue
        limit = limits.get(name)
        out[name] = {"value": value, "limit": limit}
        ok = ok and limit is not None and value <= limit
    return ok, out


def result_line(spec, run, metrics: dict, checks: dict, trace: bool) -> dict:
    correct_, shown = verdict(checks, spec.limits)
    device = {"platform": "gpu", "kind": run.card,
              "count": spec.cell["chips"],
              "memory_peak_bytes": int(run.memory_peak_bytes),
              "power_limit": power_limit()}
    line = {"correct": correct_, "attempted": len(run.records),
            "failed": sum(1 for r in run.records if not r["ok"]),
            "metrics": metrics, "device": device}
    if trace:
        t = run.trace
        device["busy_s"], device["window_s"] = t["busy_s"], t["window_s"]
    if trace and t["complete"]:
        line["breakdown"] = {
            "device_ops": sorted(([n, s] for n, s in t["by_name"].items()),
                                 key=lambda x: -x[1])[:10],
            "idle_gaps": sorted(([n, s] for n, s in t["idle_by_span"].items()),
                                key=lambda x: -x[1])[:10]}
    line["checks"] = shown
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env(ROOT)

    import torch

    from harness.spec import Spec

    spec = Spec(os.path.join(ROOT, "BENCHMARK.json"), args.workload)
    chips = spec.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {spec.name} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    trace = bool(args.trace)
    run, metrics, checks = execute(spec, args.seed, args.seconds, trace,
                                   torch.device("cuda:0"))
    bad = loaded_forbidden()
    if bad:
        print(f"perfbench: the run loaded {bad}", file=sys.stderr)
        return 3
    if trace and (run.trace is None or run.trace["busy_s"] <= 0):
        print("perfbench: the traced sub-window read no device operation",
              file=sys.stderr)
        return 4
    line = result_line(spec, run, metrics, checks, trace)
    songs = [r["bytes"] for r in run.records if r["bytes"]]
    print(f"perfbench: {spec.name} seed {args.seed}: {len(run.ok)} of "
          f"{len(run.records)} songs, {sum(songs) / 2**20:.1f} MiB written",
          file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
