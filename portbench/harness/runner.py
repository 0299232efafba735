"""One run of one cell: set-up, the timed window of whole batches through
`SynthesisPipeline.synthesize_batch`, then the check and the metrics.

The window's batches run back to back until `seconds` have passed; every
rate is taken over those whole batches. With `trace`, batch 1 (the first
sampling batch) runs under torch.profiler inside the window and the
per-layer metrics that read spans leave it out.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
from torch.profiler import record_function

from . import check as C
from . import trace as T
from .spec import Cell
from .traffic import Batch, Traffic
from .weights import vocos_tree

BANNED = ("jax", "jaxlib", "flax", "vallex_tpu")  # whole top-level module names
TRACED_BATCH = 1
TRACE_SPAN = "portbench.batch"


@dataclass
class Record:
    """One batch of the window."""
    batch: Batch
    wall: float  # s, host clock around synthesize_batch (which returns host arrays)
    seconds: Dict[str, float]  # the pipeline's phase seconds
    steps: int  # decode steps run: blocks × K
    requests: List[tuple]  # (x_len, prompt_len, gen_len) a request
    audio_s: float
    traced: bool = False


@dataclass
class Run:
    """What a metric reader gets."""
    cell: Cell
    setup_s: float
    peak_bytes: Optional[int]
    records: List[Record]
    trace: Optional[T.Trace] = None
    checks: Dict = field(default_factory=dict)

    @property
    def arch(self):
        """The cell's architecture module (portbench/archs/)."""
        return self.cell.arch

    @property
    def model(self) -> Dict:
        return self.cell.config["model"]

    @property
    def engine(self) -> Dict:
        return self.cell.config["engine"]

    def untraced(self) -> List[Record]:
        return [r for r in self.records if not r.traced]

    def traced(self) -> Optional[Record]:
        return next((r for r in self.records if r.traced), None)


def banned_modules() -> List[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(BANNED))


def engine_config(engine: Dict):
    from vallex_tpu_torch.config import EngineConfig

    return EngineConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in engine.items()})


def power_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def run_batch(pipeline, b: Batch, K: int) -> tuple:
    t0 = time.perf_counter()
    # greedy: top_k 1; otherwise None, the engine's own top_k and temperature
    res = pipeline.synthesize_batch(b.requests, top_k=1 if b.greedy else None, seed=b.seed,
                                    return_wave=True)
    wall = time.perf_counter() - t0
    reqs = [(len(t), len(p), len(res.outputs[r][0]) if r < len(res.outputs) else 0)
            for r, (t, _, p) in enumerate(b.requests)]
    audio = sum(len(w) for _, w in res.outputs if w is not None) / 24000.0
    steps = (res.ar.iterations if res.ar is not None else 0) * K
    return res, Record(b, wall, dict(res.seconds), steps, reqs, audio)


def draw_trees(cell: Cell, seed: int, dev: torch.device):
    """The weights from the seed on `dev` → (the architecture's tree in the
    serve type, Vocos tree in float32), in that order from one generator.
    Each call draws them anew, bit for bit the same."""
    conf = cell.config
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    serve = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        engine_config(conf["engine"]).compute_dtype]
    return (cell.arch.draw_tree(conf["model"], conf["weights"], gen, dev, serve),
            vocos_tree(conf["vocos"], gen, dev))


def setup(cell: Cell, seed: int, dev: torch.device):
    """The program's bundle over weights drawn from the seed. The program may
    keep the trees' storage as its parameters, so the reference draws its
    own (`draw_trees`) once the program is freed."""
    from vallex_tpu_torch import api

    conf = cell.config
    tree, vtree = draw_trees(cell, seed, dev)
    return api.preload_models(checkpoint_dir=os.path.join(cell.root, "portbench", "none"),
                              params=tree, vocos_params=vtree,
                              cfg=cell.arch.program_config(conf["model"]),
                              ecfg=engine_config(conf["engine"]), device=dev)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, log=print) -> Dict:
    """→ {"run": Run, "correct", "attempted", "failed", "checked", "banned",
    "device": {...}}. `t_start`: the host clock at process start."""
    from vallex_tpu_torch import api

    cfg_file, traffic = cell.config, cell.traffic
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    model = cfg_file["model"]
    marks = [("imports", time.perf_counter())]
    bundle = setup(cell, seed, dev)
    if cuda:
        torch.cuda.synchronize(dev)
    marks.append(("weights and bundle", time.perf_counter()))
    ecfg = bundle.ecfg
    K = max(2, ecfg.decode_steps)
    warm = Traffic(traffic, seed, cell.root, stream=1)
    b = dataclasses.replace(warm.next_batch(), greedy=False)
    run_batch(bundle.pipeline, b, K)  # the cell's own shapes, once
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    marks.append(("warm-up batch", time.perf_counter()))
    setup_s = time.perf_counter() - t_start

    # -- the window
    stream = Traffic(traffic, seed, cell.root, stream=0)
    records, outputs, events = [], [], None
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds or (trace and len(records) <= TRACED_BATCH):
        b = stream.next_batch()
        if trace and b.index == TRACED_BATCH:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                with record_function(TRACE_SPAN):
                    res, rec = run_batch(bundle.pipeline, b, K)
            rec.traced = True
            events = prof
        else:
            res, rec = run_batch(bundle.pipeline, b, K)
        records.append(rec)
        outputs.append(res.outputs)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    banned = banned_modules()
    log(f"card: {power_line()}" if cuda else "card: none (CPU run)")
    parts, prev = [], t_start
    for name, t in marks:
        parts.append(f"{name} {t - prev:.3f}")
        prev = t
    log("set-up s: " + ", ".join(parts))
    for r in records:
        log(f"batch {r.batch.index} greedy={int(r.batch.greedy)} wall={r.wall:.4f} "
            + " ".join(f"{k}={v:.4f}" for k, v in sorted(r.seconds.items()))
            + f" steps={r.steps} audio_s={r.audio_s:.3f} traced={int(r.traced)}")

    tr = None
    if events is not None:
        tr = T.read(T.trace_events(events), TRACE_SPAN)
        events = None

    # -- free the program's state, then the check
    bundle = None
    api._bundle = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    items, failed = [], 0
    for rec, outs in zip(records, outputs):
        got, bad = C.items_of(rec.batch, outs, ecfg.audio_buckets)
        items.extend(got)
        failed += bad
    outputs = None
    picked = C.sample(items, seed)
    from ..reference.vocos import Vocos

    tree, vtree = draw_trees(cell, seed, dev)
    ref = cell.arch.reference(tree, model)
    tree = None
    read = C.readings(ref, Vocos(vtree), picked)["program"]
    limits = cfg_file["limits"]
    checked_greedy = any(i.greedy for i in picked)
    correct = (failed == 0 and checked_greedy and bool(picked)
               and all(limits[k] is not None and read[k] <= limits[k] for k in limits))
    attempted = sum(len(r.batch.requests) for r in records)
    run = Run(cell, setup_s, peak, records, tr,
              {k: {"value": read[k], "limit": limits[k]} for k in limits})
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": peak}
    if trace and tr is not None:
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
    return {"run": run, "correct": correct, "attempted": attempted, "failed": failed,
            "checked": len(picked), "banned": banned, "device": device_info}
