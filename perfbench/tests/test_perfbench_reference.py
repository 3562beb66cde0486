"""The plain float32 reference against the port, on the CPU at tiny sizes.

The test may import both; the reference itself imports nothing of the
port (`test_perfbench_harness.py` checks that).
"""

import json
import os

import numpy as np
import pytest
import torch
from conftest import PERFBENCH, tiny_conf

from harness import correct, drivers, program, traffic, weights
from reference import dit as ref_dit
from reference import vae as ref_vae
from systems import dit_vae


def _full_conf():
    with open(os.path.join(PERFBENCH, "configs", "acestep-v15-turbo.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("size", ["full", "tiny"])
def test_param_shapes_are_the_modules(size):
    """The checkpoint layout the benchmark draws is every tensor the
    port's DiT and VAE modules hold, by name and shape."""
    from acestep_torch.models.dit import AceStepDiT
    from acestep_torch.models.vae import OobleckVAE

    conf = _full_conf() if size == "full" else tiny_conf()
    cfg_dit = program.tuples(conf["dit"])
    cfg_vae = program.tuples(conf["vae"])
    from acestep_torch.config import DiTConfig, VAEConfig

    dit = AceStepDiT(DiTConfig(**cfg_dit), device="meta")
    vae = OobleckVAE(VAEConfig(**cfg_vae), device="meta")
    assert {k: tuple(v.shape) for k, v in dit.state_dict().items()} == \
        ref_dit.param_shapes(conf["dit"])
    assert {k: tuple(v.shape) for k, v in vae.state_dict().items()} == \
        ref_vae.param_shapes(conf["vae"])


def test_weights_are_seeded_and_shared():
    """One seed draws the same values twice; the reference's float32 copy
    holds exactly the served values; another seed draws others."""
    shapes = {"a.weight": (4, 3), "b.scale": (5,), "c.bias": (2,)}
    a = weights.draw(shapes, 7, "dit", "cpu")
    b = weights.draw(shapes, 7, "dit", "cpu")
    c = weights.draw(shapes, 8, "dit", "cpu")
    for k in shapes:
        assert torch.equal(a[k], b[k])
        assert torch.equal(weights.widen(a)[k], a[k].float())
    assert not torch.equal(a["a.weight"], c["a.weight"])
    assert abs(float(a["b.scale"].float().mean()) - 1.0) < 0.3


@pytest.mark.parametrize("duration_s", [10.0, 40.0])
def test_reference_matches_port_on_cpu(duration_s):
    """A text2music request through the port's facade (float32, CPU,
    plain kernels) and through the reference agree to float32 rounding:
    the latents, and the song decoded from them (40 s: a segmented,
    tiled decode). Durations are whole 10 s frame buckets, as the cells'
    are: the port decodes the bucket's padding frames too."""
    conf = tiny_conf()
    handlers = dit_vae.build(conf, 11, torch.device("cpu"))
    mix = json.load(open(os.path.join(PERFBENCH, "traffic",
                                      "facade-wav-240s.json")))
    req = dict(traffic.requests(mix, 3, 0, count=1)[0], duration_s=duration_s)
    res = drivers.Facade(handlers, mix, None).one(dict(req, audio_format="wav"))
    assert res.success, res.error
    lat = res.extra_outputs["pred_latents"][0]
    ref = dit_vae.Reference(conf, 11, torch.device("cpu"))
    rec = drivers._record(req)
    want = ref.latents(rec)
    assert correct.rel(lat, want) < 1e-5
    song = res.audios[0]["audio"]
    # the int16 transfer rounds each sample to 1/32767 of the peak
    assert correct.rel(song, ref.song(want, duration_s)) < 1e-4


def test_fp8_control_reads_far_above_the_port():
    """The control (every weight rounded to fp8 e4m3) departs from the
    reference by many times what the port's float32 run does."""
    conf = tiny_conf()
    handlers = dit_vae.build(conf, 5, torch.device("cpu"))
    mix = json.load(open(os.path.join(PERFBENCH, "traffic",
                                      "facade-wav-240s.json")))
    req = dict(traffic.requests(mix, 9, 0, count=1)[0], duration_s=10.0)
    res = drivers.Facade(handlers, mix, None).one(dict(req, audio_format="wav"))
    rec = drivers._record(req)
    ref = dit_vae.Reference(conf, 5, torch.device("cpu"))
    ctl = dit_vae.Reference(conf, 5, torch.device("cpu"), fp8=True)
    port = correct.rel(res.extra_outputs["pred_latents"][0], ref.latents(rec))
    control = correct.rel(ctl.latents(rec), ref.latents(rec))
    assert control > 100 * max(port, 1e-7)


def test_nan_never_passes():
    a = np.ones(4)
    assert correct.rel(a * np.nan, a) == float("inf")
    assert correct.rel(a, a * np.nan) == float("inf")
    assert correct.rel(np.ones(3), a) == float("inf")
