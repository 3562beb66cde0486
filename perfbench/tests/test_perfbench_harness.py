"""The harness finds what BENCHMARK.json names by name, takes new cells,
configurations, mixes and metrics as new files only, prints the result
line the contract asks for, and loads nothing of JAX."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch
from conftest import BENCH, PERFBENCH, REPO, tiny_conf, tiny_spec

import run as run_py
from harness import spec as spec_mod

FORBIDDEN = {"jax", "jaxlib", "flax", "acestep_tpu", "bench", "bench_torch"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

with open(BENCH) as f:
    B = json.load(f)


def _sources(*subdirs):
    for sub in subdirs:
        root = os.path.join(PERFBENCH, sub)
        for dirpath, _dirs, files in os.walk(root):
            if os.path.basename(dirpath) in ("tests", "__pycache__"):
                continue
            for f in files:
                if f.endswith(".py"):
                    yield os.path.join(dirpath, f)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


# ---------------------------------------------------------------- contract

def test_benchmark_json_keys_and_names():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["perfbench"] and B["command"][1] == "perfbench/run.py"
    assert 1 <= B["run_seconds"] <= 51
    names = [c["name"] for c in B["configs"]] + \
        [w["name"] for w in B["workloads"]] + \
        [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in B["workloads"]]:
        assert NAME.match(n), n
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        assert any(w["config"] == c["name"] for w in B["workloads"])
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200


def test_metrics_contract():
    e2e = {m["name"]: m for m in B["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = [w["name"] for w in B["workloads"]]
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        moved = e2e[m["moves"]]
        for w in m.get("workloads", cells):
            assert "workloads" not in moved or w in moved["workloads"], m
        if m["name"].endswith("_roofline_pct.serve") or "roofline" in m["name"]:
            assert m["unit"] == "%"
    for w in cells:
        reported = [m for m in B["end_to_end"]
                    if "workloads" not in m or w in m["workloads"]]
        assert len(reported) >= 2
        assert any(w in m.get("workloads", cells) for m in B["per_layer"])


# ------------------------------------------------------------ found by name

@pytest.mark.parametrize("cell", [w["name"] for w in B["workloads"]])
def test_spec_finds_every_file_by_name(cell):
    s = spec_mod.Spec(BENCH, cell)
    assert s.conf["name"] == s.cell["config"]
    assert all(callable(getattr(s.system, f)) for f in spec_mod.SYSTEM_API)
    assert s.mix["driver"] in ("rest", "facade")
    assert set(s.limits) >= {"latent_err", "audio_err", "missing", "saved_bad"}
    for trace in (False, True):
        for m in s.metrics(trace):
            assert callable(spec_mod.reader(m["name"]).read)


def test_new_cell_config_mix_and_metric_are_new_files(tmp_path):
    """A copy of the benchmark gains a configuration, a mix, a cell and a
    per-layer metric by new files and new entries only."""
    root = tmp_path / "perfbench"
    shutil.copytree(PERFBENCH, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    before = {p: open(p, "rb").read() for p in map(str, root.rglob("*"))
              if os.path.isfile(p)}
    conf = json.load(open(root / "configs" / "acestep-v15-turbo.json"))
    conf["name"] = "dummy-config"
    (root / "configs" / "dummy-config.json").write_text(json.dumps(conf))
    mix = json.load(open(root / "traffic" / "rest-closed8-30s.json"))
    mix["clients"] = 2
    (root / "traffic" / "dummy-mix.json").write_text(json.dumps(mix))
    (root / "limits" / "dummy-cell.json").write_text(json.dumps(
        {"latent_err": 1, "audio_err": 1, "missing": 0, "saved_bad": 0}))
    (root / "metrics" / "dummy_metric.py").write_text(
        "def read(run):\n    return 42.0\n")
    bench = dict(B)
    bench["configs"] = B["configs"] + [dict(
        B["configs"][0], name="dummy-config",
        file="perfbench/configs/dummy-config.json")]
    bench["workloads"] = B["workloads"] + [dict(
        B["workloads"][0], name="dummy-cell", config="dummy-config",
        traffic="dummy-mix")]
    bench["per_layer"] = B["per_layer"] + [dict(
        B["per_layer"][0], name="dummy_metric.serve",
        workloads=["dummy-cell"])]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    s = spec_mod.Spec(str(tmp_path / "BENCHMARK.json"), "dummy-cell",
                      root=str(root))
    assert s.conf["name"] == "dummy-config" and s.mix["clients"] == 2
    assert s.limits["latent_err"] == 1
    assert [m["name"] for m in s.metrics(True)] == ["dummy_metric.serve"]
    got = spec_mod.read_all(s.metrics(True), None, root=str(root))
    assert got == {"dummy_metric.serve": {"value": 42.0, "unit": "s"}}
    after = {p: open(p, "rb").read() for p in before}
    assert after == before


# a system with a planner, written as new files into a copy of perfbench/
TINY_PLANNER = '''"""The DiT and VAE of `dit_vae` with a seeded planner (an `LLMHandler`
on `LMConfig.tiny()` with the `SimpleTokenizer`), judged only for songs
missing or saved badly."""

import torch

from harness import correct, drivers, program, traffic
from systems import dit_vae


def build(conf, seed, device):
    from acestep_torch.config import LMConfig
    from acestep_torch.llm.handler import LLMHandler
    from acestep_torch.llm.tokenizer import SimpleTokenizer

    tok = SimpleTokenizer(num_audio_codes=conf["planner"]["audio_codes"])
    llm = LLMHandler(dtype=getattr(torch, conf["dtype"]), device=device)
    llm.initialize(cfg=LMConfig.tiny(vocab_size=tok.vocab_size),
                   tokenizer=tok, seed=seed)
    return program.Handlers(dit=dit_vae.build(conf, seed, device).dit,
                            llm=llm)


def install(rec, handlers):
    pass


def warm(handlers, mix, seed, out_dir):
    req = traffic.requests(dict(mix, loop="closed"), seed ^ 0x5A5A5A5A, 0,
                           count=1)[0]
    res = drivers.Facade(handlers, mix, out_dir).one(req)
    if not res.success:
        raise RuntimeError(res.error)


def judge(conf, seed, records, songs, device, k, renders):
    return {"missing": sum(1 for r in records if not r["ok"]),
            "saved_bad": sum(1 for r in records if r["ok"] and (
                r["seed"] not in songs
                or not correct.saved_ok(r["file"], songs[r["seed"]][0]))),
            "sampled": len(correct.sample(records, seed, k, renders))}


def request_flops(conf, rec):
    return dit_vae.request_flops(conf, rec)
'''

PLAN_S = '''"""Median of the port's `plan` spans over the window (s)."""

from harness import spans


def read(run):
    got = spans.program_spans(run)
    if not got:
        return None
    return spans.median([s["end"] - s["start"] for s in got
                         if s["name"] == "plan"])
'''


def _files(root):
    return {p: open(p, "rb").read() for p in map(str, root.rglob("*"))
            if os.path.isfile(p) and "__pycache__" not in p}


@pytest.mark.parametrize("driver", ["facade", "rest"])
def test_a_system_with_a_planner_is_new_files(tmp_path, driver):
    """A copy of the benchmark gains a system with a planner (its module,
    configuration, a thinking mix, limits and a reader of the port's
    `plan` spans) by new files and entries only; a tiny traced run of the
    mix on the CPU is set up, driven through the planner, judged correct
    and read, and every file the copy had is left byte for byte."""
    root = tmp_path / "perfbench"
    shutil.copytree(PERFBENCH, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    before = _files(root)
    (root / "systems" / "tiny_planner.py").write_text(TINY_PLANNER)
    conf = dict(tiny_conf(), name="tiny-planner", system="tiny_planner",
                planner={"audio_codes": 32})
    (root / "configs" / "tiny-planner.json").write_text(json.dumps(conf))
    base = {"facade": "facade-wav-240s", "rest": "rest-closed8-30s"}[driver]
    mix = json.load(open(root / "traffic" / (base + ".json")))
    mix["request"].update(duration_s=10, thinking=True)
    mix.update(closed_count=5000, warm_batches=[1], late_s=30,
               correct_sample=2)
    if driver == "rest":
        mix["clients"] = 2
    (root / "traffic" / "tiny-think.json").write_text(json.dumps(mix))
    cell = "tiny-think-" + driver
    (root / "limits" / (cell + ".json")).write_text(json.dumps(
        {"missing": 0, "saved_bad": 0}))
    (root / "metrics" / "plan_s.py").write_text(PLAN_S)
    bench = dict(B)
    bench["configs"] = B["configs"] + [dict(
        B["configs"][0], name="tiny-planner",
        file="perfbench/configs/tiny-planner.json")]
    bench["workloads"] = B["workloads"] + [dict(
        B["workloads"][0], name=cell, config="tiny-planner",
        traffic="tiny-think")]
    bench["per_layer"] = B["per_layer"] + [dict(
        B["per_layer"][0], name="plan_s.think", unit="s", workloads=[cell])]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    s = spec_mod.Spec(str(tmp_path / "BENCHMARK.json"), cell, root=str(root))
    assert s.system.__file__ == str(root / "systems" / "tiny_planner.py")
    run, metrics, checks = run_py.execute(s, 2**31 + 99, 3.0, True,
                                          torch.device("cpu"))
    assert run_py.verdict(checks, s.limits)[0] is True, checks
    assert run.ok and all(r["ok"] for r in run.records)
    plans = [p for p in run.program_spans if p["name"] == "plan"]
    assert len(plans) >= len(run.ok)
    assert all("lm_time_cost" in r["time_costs"] for r in run.ok)
    assert list(metrics) == ["plan_s.think"]
    assert metrics["plan_s.think"]["value"] > 0
    after = _files(root)
    assert {p: after.get(p) for p in before} == before


@pytest.mark.parametrize("system", [None, "no_such_system"])
def test_a_configuration_must_name_its_system(tmp_path, system):
    """A configuration with no `"system"`, or naming no module under
    `perfbench/systems/`, fails at set-up, naming what it lacks."""
    conf = json.load(open(os.path.join(PERFBENCH, "configs",
                                       "acestep-v15-turbo.json")))
    del conf["system"]
    if system is not None:
        conf["system"] = system
    (tmp_path / "c.json").write_text(json.dumps(conf))
    bench = dict(B, configs=[dict(B["configs"][0], file="c.json")])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises((ValueError, FileNotFoundError)) as err:
        spec_mod.Spec(str(tmp_path / "BENCHMARK.json"), "turbo-rest-30s")
    assert "acestep-v15-turbo" in str(err.value)
    assert (system or "names no system") in str(err.value)


# ------------------------------------------------------------- result line

def test_result_line_of_a_tiny_run():
    """A whole run on the CPU at tiny widths (the card check skipped):
    correct under the cell's limits, the contract's keys, `checks` last."""
    spec = tiny_spec("turbo-rest-30s")
    run, metrics, checks = run_py.execute(spec, 2**31 + 12345, 4.0, False,
                                          torch.device("cpu"))
    line = run_py.result_line(spec, run, metrics, checks, False)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] == len(run.records) >= 8
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(metrics) == {m["name"] for m in spec.metrics(False)}
    for name, c in line["checks"].items():
        assert c["limit"] is not None and c["value"] <= c["limit"], name
    json.dumps(line)


def test_open_loop_tiny_run():
    """The REST driver's open loop (a mix with `rate_per_s` and
    `arrival_seed` in place of `clients`): every request sent on its
    schedule, timed from when it was due, and judged correct."""
    spec = tiny_spec("turbo-rest-30s")
    spec.mix = dict(spec.mix, loop="open", rate_per_s=6.0, arrival_seed=7)
    del spec.mix["clients"]
    run, metrics, checks = run_py.execute(spec, 31337, 3.0, False,
                                          torch.device("cpu"))
    assert len(run.records) == 18 and all(r["ok"] for r in run.records)
    assert all(r["start"] <= r["sent"] for r in run.records)
    assert run_py.verdict(checks, spec.limits)[0] is True, checks


def test_sample_holds_a_whole_fused_render():
    """Every slot of one of the largest renders is judged, with the
    longest song, and draws from the seed up to the sample's size."""
    from harness.correct import sample

    records = [{"seed": s, "ok": True, "duration_s": 30.0} for s in range(1, 41)]
    records[7]["duration_s"] = 60.0
    renders = [tuple(range(1 + 4 * i, 5 + 4 * i)) for i in range(10)]
    renders[3] = (13, 14)
    records.append({"seed": 99, "ok": False, "duration_s": 30.0})
    for seed in range(20):
        got = [r["seed"] for r in sample(records, seed, 6, renders)]
        assert len(got) == len(set(got)) == 6 and 99 not in got
        assert any(set(g) <= set(got) for g in renders if len(g) == 4)
        assert 8 in got


# ------------------------------------------------------------------- imports

def test_no_module_of_the_benchmark_imports_jax():
    for path in _sources("harness", "reference", "metrics", "systems"):
        assert not set(_imports(path)) & FORBIDDEN, path
    for path in (os.path.join(PERFBENCH, "run.py"),
                 os.path.join(PERFBENCH, "control.py")):
        assert not set(_imports(path)) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        assert set(_imports(path)) <= {"__future__", "math", "typing",
                                       "numpy", "torch"}, path


def test_load_generator_is_standard_library_only():
    path = os.path.join(PERFBENCH, "harness", "loadgen.py")
    assert set(_imports(path)) <= {"json", "sys", "threading", "time",
                                   "urllib"}


def test_a_loaded_process_holds_no_jax():
    """Everything a run imports, imported in a fresh process: no top-level
    module named jax, jaxlib, flax, acestep_tpu, bench or bench_torch."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import run, control\n"
        "from harness import correct, drivers, measure, program, roofline, "
        "spec, trace, traffic, weights, counts\n"
        "from systems import dit_vae\n"
        "import acestep_torch.serving.server, acestep_torch.inference\n"
        "import glob, os\n"
        "for p in glob.glob(os.path.join(%r, 'metrics', '*.py')):\n"
        "    spec.reader(os.path.basename(p)[:-3])\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & %r))\n"
        % (PERFBENCH, REPO, PERFBENCH, FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_kernels_pair_with_the_launch_that_made_them():
    """Each traced kernel goes to the last call logged before its launch;
    a K4 call counts only when all three of its unit kernels were traced,
    kernels of calls not logged (launched before the log began) and
    kernels the profiler dropped take no call with them."""
    from harness.program import Recorder
    from harness.trace import K4_NAMES, Tracer

    tr = Tracer(Recorder(), "cpu", 0.0, 1.0)
    calls = [(1.0, (1, 100, 128)), (2.0, (1, 100, 256)), (3.0, (2, 50, 128))]
    k = "snake_unit_kernel<128>"
    tr.events = [
        (k, 0.5, 0.6, 0.4),                       # launched before any call
        (k, 1.1, 1.2, 1.01), (k, 1.2, 1.3, 1.02), (k, 1.3, 1.4, 1.03),
        (k, 2.1, 2.3, 2.01), (k, 2.3, 2.5, 2.02),  # one of three dropped
        (k, 3.1, 3.2, 3.01), (k, 3.2, 3.3, 3.02), (k, 3.3, 3.4, 3.03),
        ("other_kernel", 3.5, 3.6, 3.5), (k, 4.0, 4.1, None)]
    got = tr.matched(K4_NAMES, calls, lambda s: 1 if s[2] <= 64 else 3)
    assert got["calls"] == 3 and got["kernels"] == 10
    assert [shape for shape, _s in got["pairs"]] == [(1, 100, 128),
                                                     (2, 50, 128)]
    assert [round(s, 6) for _shape, s in got["pairs"]] == [0.3, 0.3]


@pytest.mark.parametrize("lost,seconds,stretches", [
    ([0], 40.0, [20.0]),                  # complete: traced once
    ([60, 0], 40.0, [20.0, 25.0]),        # kernels dropped: the next stretch
    ([60, 60], 28.0, [20.0]),             # no second stretch fits
])
def test_a_trace_that_lost_kernels_is_taken_again(lost, seconds, stretches):
    from harness.program import Recorder
    from harness.trace import Tracer

    tr = Tracer(Recorder(), "cpu", 20.0, 24.0, seconds)
    seen = []

    def fake(start, span):
        assert span == 4.0
        seen.append(start)
        tr.events.append(("k", start, start + 1, start))
        tr.unmatched.append((1000, lost[len(seen) - 1]))

    tr._trace = fake
    tr.run(0.0)
    assert seen == stretches and tr.error is None
    assert len(tr.events) == 1


def test_a_stretch_that_lost_its_kernels_reads_no_device_metric():
    """The last take still lacks more than MAX_UNMATCHED of its kernels:
    the summary marks the stretch, the device metrics (idle, K1 and K4
    rooflines, the idle inside diffusion) read nothing and the result
    line carries no breakdown; the span readers still read."""
    from harness import measure
    from harness.program import Recorder
    from harness.trace import Tracer

    tr = Tracer(Recorder(), "cpu", 20.0, 24.0, 28.0)

    def fake(start, span):
        tr.t_start, tr.t_stop = start, start + span
        tr.events.append(("flash_fwd_kernel", start, start + 1, start))
        tr.launches = {"k1": 1, "k4": 0}
        tr.unmatched.append((1000, 60))

    tr._trace = fake
    tr.run(0.0)
    t = tr.summary()
    assert t["complete"] is False and t["lost"] == (60, 1000)
    spans = [{"id": 1, "name": "diffusion", "start": 20.0, "end": 24.0,
              "parent": None, "thread": 1, "requests": [], "attrs": {}},
             {"id": 2, "name": "dit.step", "start": 20.0, "end": 21.0,
              "parent": 1, "thread": 1, "requests": [], "attrs": {}}]
    run = measure.Run(conf={}, w0=0.0, records=[], setup_s=1.0,
                      memory_peak_bytes=0, card="NVIDIA H100 80GB HBM3",
                      trace=t, program_spans=spans)
    for name in ("idle_pct.serve", "k1_roofline_pct.serve",
                 "k4_roofline_pct.long", "diffusion_idle_pct.long"):
        assert spec_mod.reader(name).read(run) is None, name
    assert spec_mod.reader("dit_step_host_ms.serve").read(run) == 1000.0
    spec = spec_mod.Spec(BENCH, "turbo-rest-30s")
    line = run_py.result_line(spec, run, {}, {}, True)
    assert "breakdown" not in line
    assert line["device"]["window_s"] == 4.0
    run.trace = dict(t, complete=True)
    assert spec_mod.reader("idle_pct.serve").read(run) == pytest.approx(75.0)
    assert spec_mod.reader("diffusion_idle_pct.long").read(run) == \
        pytest.approx(75.0)
    assert "breakdown" in run_py.result_line(spec, run, {}, {}, True)
