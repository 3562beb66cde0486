#!/usr/bin/env python3
"""The control of a cell's correctness check, as the system module its
configuration names makes it (`control` in `perfbench/systems/<system>.py`;
for `dit_vae`: the plain reference put in the program's place with every
matrix and conv weight rounded to float8 e4m3, one scale an output
channel, the precision step below the bf16 the configuration serves in).
It produces each sampled request's answer itself and is judged by the
same numbers a run's `correct` compares; the limits sit between what
sound runs read and what this reads.

    python3 perfbench/control.py --workload <name> --seeds <n> [<n> ...]
        [--seconds <run_seconds>]

Prints one JSON line a seed: {"seed", each number the judge compares,
"sampled"}. Needs a CUDA card, like a run.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]


def control_numbers(spec, seed: int, seconds: float, device) -> dict:
    """The control's numbers on the requests a run of `seed` would judge,
    as the cell's system makes and judges them (its `control`)."""
    return spec.system.control(spec.conf, spec.mix, seed, seconds, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args(argv)

    import torch

    from harness.spec import Spec

    spec = Spec(os.path.join(ROOT, "BENCHMARK.json"), args.workload)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    seconds = args.seconds or spec.bench["run_seconds"]
    for seed in args.seeds:
        out = control_numbers(spec, seed, seconds, torch.device("cuda:0"))
        print(json.dumps({"seed": seed, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
