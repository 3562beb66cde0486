"""The control on the card, at each cell's own size: the reference with
every weight rounded to fp8 e4m3, in the program's place, must fail the
cell's limits. Marked `cuda`; on the card:
    python -m pytest perfbench/tests/test_perfbench_control.py -m cuda -q
"""

import json

import pytest
from conftest import BENCH

import control
from harness.spec import Spec

pytestmark = pytest.mark.cuda

with open(BENCH) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_fp8_control_fails_the_limits(cell, cuda_device):
    spec = Spec(BENCH, cell)
    got = control.control_numbers(spec, 2**31 + 7, spec.bench["run_seconds"],
                                  cuda_device)
    assert got["sampled"] == spec.mix["correct_sample"]
    assert (got["latent_err"] > spec.limits["latent_err"]
            or got["audio_err"] > spec.limits["audio_err"]), got
