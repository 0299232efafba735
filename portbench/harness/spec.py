"""BENCHMARK.json and the files it names: a cell's configuration, traffic and
metrics, found by name.

- configuration: `configs[].file`, a JSON object with the model's sizes
  (`model`, ModelConfig's keys), the engine's settings (`engine`,
  EngineConfig's keys), the weights' settings (`weights`), the vocoder's
  sizes (`vocos`), the control's precisions (`control`) and the check's
  limits (`limits`);
- traffic: `portbench/traffic/<traffic>.json` (harness/traffic.py);
- metric: `portbench/metrics/<name>.py`, whose `read(run)` returns the
  number or None when the run has nothing for it to read.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
PORTBENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(PORTBENCH)


@dataclass
class Metric:
    name: str
    unit: str
    read: Callable


@dataclass
class Cell:
    root: str  # the checkout
    name: str
    workload: Dict
    config: Dict
    traffic: Dict
    end_to_end: List[Metric]
    per_layer: List[Metric]


def load_reader(root: str, name: str) -> Callable:
    path = os.path.join(root, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise SystemExit(f"unknown workload {name!r}; one of {sorted(by_name)}")
    w = by_name[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "portbench", "traffic", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)

    def metrics(key):
        return [Metric(m["name"], m["unit"], load_reader(root, m["name"]))
                for m in bench[key] if _applies(m, name)]
    return Cell(root, name, w, config, traffic, metrics("end_to_end"), metrics("per_layer"))
