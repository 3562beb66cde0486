#!/usr/bin/env python3
"""Run one cell as `run.py --trace 1` does, with the port's own span
tracer on over the window, and read its spans against the device trace.

    python3 perfbench/traced_spans.py --workload <name> --seed <n> \
        --seconds <s>

from the root of a checkout. After the warm-up the port's tracer
(`acestep_torch.utils.trace`) is turned on with its ring emptied; after
the window the ring is drained into the run's `program_spans`, and the run
holds the traced stretch and its idle intervals (`trace["stretch"]`,
`trace["gaps"]`). The last stdout line is run.py's traced result line
with `spans` added: the span metrics `host_stages_s`, `dit_step_host_ms`
and `diffusion_idle_pct` (their readers in metrics/), the stretch's idle
seconds cut at the program's span boundaries and put down to the
innermost span open on the rendering thread (`idle_split`, also printed
to stderr), the share of the idle inside `diffusion` spans during which
a `serve.http` span was open, and the shares of the traced K1 kernels
launched inside a `dit.*` span and of the K4 kernels inside a `vae` span.

Exits 2 without a CUDA card, 3 when JAX was loaded, 4 when the traced
stretch read no device operation.
"""

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (HERE, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

import run as run_py  # noqa: E402

SPAN_METRICS = ("host_stages_s", "dit_step_host_ms", "diffusion_idle_pct")


def span_tracer():
    """harness/trace.Tracer, whose summary also gives the traced stretch
    and its idle intervals (`stretch`, `gaps`); the class keeps the last
    one summarised as `last`, with its device events."""
    from harness import spans
    from harness import trace as htrace

    class SpanTracer(htrace.Tracer):
        last = None

        def summary(self):
            type(self).last = self
            out = super().summary()
            if out is not None:
                out["stretch"] = (self.t_start, self.t_stop)
                out["gaps"] = spans.gaps_of(self, super().summary)
            return out

    return SpanTracer


def traced_run(spec, seed: int, seconds: float, device,
               t_process: float = T_PROCESS):
    """run.execute with tracing, the port's tracer on over the window ->
    (measure.Run with program_spans, metrics, checks, the device trace's
    events as harness/trace.Tracer holds them)."""
    from acestep_torch.utils import trace as ptrace
    from harness import trace as htrace

    def hook(_handler):
        ptrace.enable()
        ptrace.drain()

    original, htrace.Tracer = htrace.Tracer, span_tracer()
    tracer = htrace.Tracer
    try:
        run, metrics, checks = run_py.execute(spec, seed, seconds, True,
                                              device, t_process, hook=hook)
    finally:
        htrace.Tracer = original
        ptrace.disable()
    run.program_spans = ptrace.drain()
    return run, metrics, checks, (tracer.last.events if tracer.last else [])


def span_readings(run, events) -> dict:
    """The span metrics and the idle breakdown of a traced run."""
    from harness import spans
    from harness.spec import reader
    from harness.trace import K1_NAMES, K4_NAMES

    out = {name: reader(name).read(run) for name in SPAN_METRICS}
    got, traced = run.program_spans, spans.stretch_and_gaps(run)
    if not got or traced is None:
        return out
    stretch, gaps = traced
    split = spans.split_idle(stretch, gaps, got, spans.rendering_threads(got))
    idle, _inside, http = spans.diffusion_idle(stretch, gaps, got)
    out.update(
        stretch_s=stretch[1] - stretch[0],
        idle_split=sorted(([n, s] for n, s in split.items()),
                          key=lambda x: -x[1]),
        diffusion_idle_s=idle,
        http_share_of_diffusion_idle_pct=(100.0 * http / idle if idle > 0
                                          else None),
        k1_in_dit_pct=spans.launched_inside(
            events, K1_NAMES,
            spans.named(got, lambda n: n.startswith("dit."))),
        k4_in_vae_pct=spans.launched_inside(
            events, K4_NAMES, spans.named(got, lambda n: n == "vae")),
        program_spans=len(got))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    run_py.cache_env(ROOT)

    import torch

    from harness.spec import Spec

    spec = Spec(os.path.join(ROOT, "BENCHMARK.json"), args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < spec.cell["chips"]:
        print(f"traced_spans: {spec.name} needs {spec.cell['chips']} CUDA "
              "card(s)", file=sys.stderr)
        return 2
    run, metrics, checks, events = traced_run(
        spec, args.seed, args.seconds, torch.device("cuda:0"))
    if run_py.loaded_forbidden():
        return 3
    if run.trace is None or run.trace["busy_s"] <= 0:
        print("traced_spans: the traced stretch read no device operation",
              file=sys.stderr)
        return 4
    line = run_py.result_line(spec, run, metrics, checks, True)
    line["spans"] = got = span_readings(run, events)
    idle = run.trace["window_s"] - run.trace["busy_s"]
    print(f"traced_spans: {spec.name} seed {args.seed}: stretch "
          f"{got.get('stretch_s')} s, idle {idle} s, "
          f"{got.get('program_spans')} program spans", file=sys.stderr)
    for name, seconds in got.get("idle_split", []):
        print(f"idle under {name}: {seconds} s", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
