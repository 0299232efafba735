"""BENCHMARK.json and the files it names: a cell's configuration, traffic,
architecture and metrics, found by name.

- configuration: `configs[].file`, a JSON object with the model's sizes
  (`model`), the engine's settings (`engine`, EngineConfig's keys), the
  weights' settings (`weights`), the vocoder's sizes (`vocos`), the
  control's precisions (`control`), the check's limits (`limits`) and,
  optionally, its `architecture` (`vallex` when absent);
- architecture: `portbench/archs/<architecture>.py`, the model's weight
  drawer, program configuration, reference and counts (README.md);
- traffic: `portbench/traffic/<traffic>.json` (harness/traffic.py);
- metric: `portbench/metrics/<name>.py`, whose `read(run)` returns the
  number or None when the run has nothing for it to read.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from dataclasses import dataclass
from types import ModuleType
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
PORTBENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(PORTBENCH)
DEFAULT_ARCH = "vallex"


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
    arch: Optional[ModuleType] = None  # portbench/archs/<architecture>.py


def _load(path: str, module: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(root: str, name: str) -> Callable:
    return _load(os.path.join(root, "portbench", "metrics", f"{name}.py"),
                 f"portbench_metric_{name}").read


def load_arch(root: str, name: str) -> ModuleType:
    """portbench/archs/<name>.py of the checkout `root`, else of this
    harness; SystemExit naming the files looked for when neither exists."""
    paths = [os.path.join(base, "archs", f"{name}.py")
             for base in dict.fromkeys((os.path.join(root, "portbench"), PORTBENCH))]
    if re.fullmatch(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}", name):
        for path in paths:
            if os.path.isfile(path):
                return _load(path, f"portbench_arch_{name}")
    raise SystemExit(f"unknown architecture {name!r}: no file {' or '.join(paths)}")


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
    return Cell(root, name, w, config, traffic, metrics("end_to_end"), metrics("per_layer"),
                load_arch(root, config.get("architecture", DEFAULT_ARCH)))
