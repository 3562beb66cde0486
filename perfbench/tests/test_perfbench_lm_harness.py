"""The thinking cell `turbo-lm4b-think-60s-b2` in the harness: its
configuration, mix, limits, readers and system are new files, found by
name; a tiny traced run of its mix through the facade, on the CPU with
the port's miniature DiT and VAE and a tiny planner, is judged correct
by every check its limits name and reads every new span and counter
metric; the device and peak metrics read from a traced stretch; adding
the cell changed none of the benchmark's other files."""

import copy
import dataclasses
import json
import os
import shutil

import pytest
import torch
from conftest import BENCH, PERFBENCH, tiny_conf

import run as run_py
from harness import measure
from harness import spec as spec_mod

CELL = "turbo-lm4b-think-60s-b2"
# what the cell added to perfbench/
NEW_FILES = (
    "configs/acestep-v15-turbo-lm4b.json",
    "traffic/facade-think-60s-b2.json",
    "limits/turbo-lm4b-think-60s-b2.json",
    "systems/dit_vae_lm.py",
    "reference/lm.py", "reference/hints.py",
    "harness/lm_counts.py", "harness/plan_spans.py",
    "metrics/plan_s.think.py", "metrics/lm_prefill_s.py", "metrics/lm_cot_s.py",
    "metrics/lm_codes_s.py", "metrics/lm_step_ms.py",
    "metrics/lm_graph_hit_pct.py", "metrics/lm_step_roofline_pct.py")
SPAN_METRICS = ("plan_s.think", "lm_prefill_s.think", "lm_cot_s.think",
                "lm_codes_s.think", "lm_step_ms.think",
                "lm_graph_hit_pct.think")
DEVICE_METRICS = ("lm_step_roofline_pct.think", "mfu_pct.think",
                  "idle_pct.think")
# the render's metrics, read on this cell by the turbo cells' readers
RENDER_METRICS = ("diffusion_s.think", "vae_s.think", "save_s.think",
                  "host_stages_s.think", "dit_step_host_ms.think",
                  "dit_graph_hit_pct.think")
RENDER_DEVICE_METRICS = ("k1_roofline_pct.think", "k4_roofline_pct.think",
                         "diffusion_idle_pct.think")

with open(BENCH) as f:
    B = json.load(f)


def tiny_think(root: str = PERFBENCH, bench: str = BENCH) -> spec_mod.Spec:
    """The cell at tiny widths: the miniature DiT and VAE, a two-layer
    planner in float32, 10 s songs, a short warm-up."""
    from acestep_torch.config import LMConfig

    spec = spec_mod.Spec(bench, CELL, root=root)
    conf = tiny_conf("acestep-v15-turbo-lm4b")
    conf["lm"] = dataclasses.asdict(LMConfig.tiny(vocab_size=64256,
                                                  tie_word_embeddings=False))
    spec.conf = conf
    mix = copy.deepcopy(spec.mix)
    mix["request"]["duration_s"] = 10
    mix.update(warm_calls=4, warm_quiet=1, closed_count=5000, late_s=30)
    spec.mix = mix
    return spec


def test_the_cell_is_named_as_the_issue_names_it():
    cells = {w["name"]: w for w in B["workloads"]}
    assert cells[CELL] == dict(cells[CELL], config="acestep-v15-turbo-lm4b",
                               traffic="facade-think-60s-b2", chips=1)
    assert B["workloads"][-1]["name"] == CELL
    conf = spec_mod.Spec(BENCH, CELL).conf
    assert conf["system"] == "dit_vae_lm" and conf["reduced"] == []
    assert conf["planner"]["size"] == "4B"
    assert conf["planner"]["quantization"] is None
    e2e = {m["name"]: m for m in B["end_to_end"]}
    for name in ("latency_p50_s", "audio_s_per_s"):
        assert e2e[name]["workloads"][-1] == CELL
    mine = [m["name"] for m in B["per_layer"]
            if CELL in m.get("workloads", ())]
    assert sorted(mine) == sorted(SPAN_METRICS + DEVICE_METRICS
                                  + RENDER_METRICS + RENDER_DEVICE_METRICS)
    for name in NEW_FILES:
        assert os.path.exists(os.path.join(PERFBENCH, name)), name


def test_adding_the_cell_left_every_other_file(tmp_path):
    """A copy of the benchmark without the cell's files, the cell's files
    added back: the copy's other files are left byte for byte, and the
    cell is found by name in it with everything it names."""
    root = tmp_path / "perfbench"
    shutil.copytree(PERFBENCH, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    for name in NEW_FILES:
        os.remove(root / name)
    before = {p: open(p, "rb").read() for p in map(str, root.rglob("*"))
              if os.path.isfile(p)}
    for name in NEW_FILES:
        shutil.copy(os.path.join(PERFBENCH, name), root / name)
    s = spec_mod.Spec(BENCH, CELL, root=str(root))
    assert s.system.__file__ == str(root / "systems" / "dit_vae_lm.py")
    assert set(s.limits) >= {"lm_logit_err", "stream_bad", "fsm_violations",
                             "code_count_bad", "latent_err", "audio_err",
                             "missing", "saved_bad"}
    for trace in (False, True):
        for m in s.metrics(trace):
            assert callable(spec_mod.reader(m["name"], str(root)).read)
    after = {p: open(p, "rb").read() for p in before}
    assert after == before


@pytest.fixture(scope="module")
def tiny_run():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        spec = tiny_think()
        return spec, run_py.execute(spec, 2**31 + 4242, 3.0, True,
                                    torch.device("cpu"))
    finally:
        torch.set_num_threads(n)


def test_a_tiny_traced_run_is_correct_and_reads_the_spans(tiny_run):
    spec, (run, metrics, checks) = tiny_run
    ok, shown = run_py.verdict(checks, spec.limits)
    assert ok is True, shown
    assert set(shown) == set(spec.limits)
    assert checks["sampled"] == spec.mix["correct_sample"]
    assert run.ok and all(r["ok"] for r in run.records)
    for name in SPAN_METRICS + RENDER_METRICS:
        assert metrics[name]["value"] >= 0, name
    # the CPU has no graphs: every decode step ran eagerly
    assert metrics["lm_graph_hit_pct.think"]["value"] == 0.0
    assert run.counters["lm_code_tokens"] == 2 * 50 * len(run.ok)
    plans = [s for s in run.program_spans if s["name"] == "plan"]
    assert len(plans) >= len(run.ok)
    # two songs a call, both judged and both saved
    plan = run.system.PLANS[run.ok[0]["seed"]]
    assert len(plan["seeds"]) == 2
    assert all(len(c) == 50 for c in plan["codes"]["codes"])


def test_the_device_metrics_read_a_traced_stretch(tiny_run):
    """On the card's name and a traced stretch over the window: the
    codes-phase roofline, the whole call's share of the peak, the idle share
    and the idle inside diffusion read numbers, each a share under 100%."""
    spec, (run, _metrics, _checks) = tiny_run
    got = run.program_spans
    lo = min(s["start"] for s in got)
    hi = max(s["end"] for s in got)
    run = dataclasses.replace(run, card="NVIDIA H100 80GB HBM3", trace={
        "complete": True, "stretch": (lo, hi), "window_s": hi - lo,
        "busy_s": 0.5 * (hi - lo),
        "gaps": [(lo + k * (hi - lo) / 10, lo + (k + 0.5) * (hi - lo) / 10)
                 for k in range(10)]})
    for name in DEVICE_METRICS:
        value = spec_mod.reader(name).read(run)
        assert value is not None and 0 < value < 100, (name, value)
    assert spec_mod.reader("idle_pct.think").read(run) == \
        pytest.approx(50.0)
    # idle in the middle half of every `diffusion` span
    mid = sorted((s["start"] + (s["end"] - s["start"]) / 4,
                  s["end"] - (s["end"] - s["start"]) / 4)
                 for s in got if s["name"] == "diffusion")
    assert mid
    run = dataclasses.replace(run, trace=dict(run.trace, gaps=mid))
    value = spec_mod.reader("diffusion_idle_pct.think").read(run)
    assert value == pytest.approx(50.0), value
    flops = [measure.song_flops(run, r) for r in run.ok]
    assert all(f > 0 for f in flops)


def test_a_program_without_the_planner_spans_reads_nothing(tiny_run):
    """The parent's program has no `lm.*` span or counter: the new
    readers read nothing there, and raise nothing."""
    _spec, (run, _m, _c) = tiny_run
    bare = dataclasses.replace(
        run, program_spans=[s for s in run.program_spans
                            if not s["name"].startswith("lm.")],
        counters={k: v for k, v in run.counters.items()
                  if not k.startswith("lm_")})
    for name in SPAN_METRICS[1:] + DEVICE_METRICS[:1]:
        assert spec_mod.reader(name).read(bare) is None, name
