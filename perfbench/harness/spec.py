"""What a run is asked to do, found by name from `BENCHMARK.json`:

- the cell (`workloads` entry) -> its configuration file (`configs`
  entry's `file`) and its traffic mix, `perfbench/traffic/<traffic>.json`;
- the limits of its correctness checks, `perfbench/limits/<cell>.json`;
- the metrics it reports: with `--trace 0` the `end_to_end` metrics, with
  `--trace 1` the `per_layer` ones, each kept when it has no `workloads`
  key or lists the cell;
- each metric's reader, `perfbench/metrics/<name>.py` or, for a name with
  a suffix (`diffusion_s.serve`), `perfbench/metrics/<part before the
  first dot>.py`: a module with `read(run) -> float | None`;
- the system under test, `perfbench/systems/<system>.py`, named by the
  configuration file's `"system"`: a module with the functions of
  `SYSTEM_API`, which builds the program's handlers, warms them, judges
  what they produced and counts a request's FLOPs.

A new cell, configuration, mix, metric or system is new files and entries
here.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from types import ModuleType
from typing import Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# what a system module provides (perfbench/systems/__init__.py gives each
# function's arguments and result)
SYSTEM_API = ("build", "install", "warm", "judge", "request_flops")


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    """One cell of `BENCHMARK.json` and everything it names."""

    def __init__(self, bench_path: str, workload: str, root: str = ROOT):
        self.bench = _json(bench_path)
        self.root = root
        self.repo = os.path.dirname(os.path.abspath(bench_path))
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                           f"(has {sorted(cells)})")
        self.cell = cells[workload]
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = configs[self.cell["config"]]
        self.conf = _json(os.path.join(self.repo, self.config_entry["file"]))
        self.system = system(self.conf, root)
        self.mix = _json(os.path.join(root, "traffic",
                                      self.cell["traffic"] + ".json"))
        limits = os.path.join(root, "limits", workload + ".json")
        self.limits = _json(limits) if os.path.exists(limits) else {}

    @property
    def name(self) -> str:
        return self.cell["name"]

    def metrics(self, trace: bool) -> List[dict]:
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if "workloads" not in m or self.name in m["workloads"]]


def _load(kind: str, stem: str, path: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_" + re.sub(r"\W", "_", stem), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def system(conf: dict, root: str = ROOT) -> ModuleType:
    """The system module the configuration `conf` names."""
    name = conf.get("system")
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"configuration {conf.get('name')!r} names no "
                         f"system (its \"system\" key: {name!r})")
    path = os.path.join(root, "systems", name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"configuration {conf.get('name')!r} names "
                                f"system {name!r}, and there is no {path}")
    mod = _load("system", name, path)
    missing = [f for f in SYSTEM_API if not callable(getattr(mod, f, None))]
    if missing:
        raise AttributeError(f"system {name!r} ({path}) lacks {missing}")
    return mod


def reader(name: str, root: str = ROOT) -> ModuleType:
    """The reader module of metric `name`."""
    for stem in (name, name.split(".", 1)[0]):
        path = os.path.join(root, "metrics", stem + ".py")
        if os.path.exists(path):
            return _load("metric", stem, path)
    raise FileNotFoundError(f"no reader for metric {name!r} under "
                            f"{os.path.join(root, 'metrics')}")


def read_all(metrics: List[dict], run, root: str = ROOT) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of every metric whose reader found
    something to read."""
    out = {}
    for m in metrics:
        value = reader(m["name"], root).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
