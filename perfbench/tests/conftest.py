"""Shared set-up of the benchmark's own tests: `perfbench/` and the repo
root on the import path, a tiny copy of a cell (the port's miniature
DiT and VAE in float32 on the CPU, short songs) for driving whole runs,
and the card fixture of the tests marked `cuda`.

Run from the repo root: python -m pytest perfbench/tests -q
(the `cuda` tests skip without a card; on the card: -m cuda).
"""

import copy
import dataclasses
import json
import os
import sys

import pytest
import torch

PERFBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PERFBENCH)
for p in (PERFBENCH, REPO):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness.spec import Spec  # noqa: E402

BENCH = os.path.join(REPO, "BENCHMARK.json")


def tiny_conf(name: str = "acestep-v15-turbo") -> dict:
    """The configuration file of `name` with the port's miniature DiT and
    VAE (`DiTConfig.tiny()`, `VAEConfig.tiny(decoder_input_channels=64)`)
    in float32."""
    from acestep_torch.config import DiTConfig, VAEConfig

    with open(os.path.join(PERFBENCH, "configs", name + ".json")) as f:
        conf = json.load(f)

    def plain(d):
        return {k: list(v) if isinstance(v, tuple) else v for k, v in d.items()}

    dit = plain(dataclasses.asdict(DiTConfig.tiny()))
    dit["layer_types"] = None
    conf.update(dit=dit, vae=plain(dataclasses.asdict(
        VAEConfig.tiny(decoder_input_channels=64))), dtype="float32")
    return conf


def tiny_spec(workload: str, duration_s: float = 10.0, rate: float = 2.0) -> Spec:
    """`workload` of BENCHMARK.json at tiny widths, short songs, two warm
    batch sizes."""
    spec = Spec(BENCH, workload)
    spec.conf = tiny_conf(spec.cell["config"])
    mix = copy.deepcopy(spec.mix)
    mix["request"]["duration_s"] = duration_s
    mix["warm_batches"] = mix["warm_batches"][:2]
    mix["late_s"] = 30
    if mix["loop"] == "open":
        mix["rate_per_s"] = rate
    else:
        mix["closed_count"] = 5000      # tiny songs take milliseconds
    spec.mix = mix
    return spec


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell runs at its own size on "
                    "the card")
    return torch.device("cuda")
