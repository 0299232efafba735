"""One dp × tp training step from a full parameter tree, in each rank: the
job that holds a mesh's step against the single-process one.

    outs = run_ranks(mesh, step_job, StepJob(cfg, tree, batch, ...))

Every rank builds the model from the same full tree (or a file of one),
shards it (parallel/mesh.py), takes its dp rows of the global batch, runs
`steps` train steps and reports: the metrics (the global batch's), its
local parameter count, a digest of each replicated leaf (equal on every tp
rank), its kernel launches by site and its peak device memory; rank 0 also
the full gradients of the last step and the full parameters after it (put
back together over tp, summed over dp), as numpy trees by the JAX tree's
names, or with `save_to` in a torch file of {name: tensor} dicts (at the
shipped width a tree is 1.5 GB: a file beats a pipe), or with `compare_to`
their numbers against such files, which dp index 0's ranks work out on
their own slices (nothing is gathered). Every rank also
reports its host seconds by stage ("build", "steps", "gather", "compare",
"save").
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig


@dataclasses.dataclass
class StepJob:
    cfg: ModelConfig
    # the full parameter tree (numpy or CPU tensors), or a torch file of one
    # (read memory-mapped)
    tree: Any
    batch: Dict[str, np.ndarray]  # the global batch (collate / collate_packed)
    optimizer: str = "adamw"  # "adamw", "scaled_adam" or "eve"
    train_stage: int = 0  # 1 / 2: Masked to the AR / NAR leaves
    dtype: str = "float32"
    prefix_mode: int = 1
    use_flash: Any = False
    packed: bool = False
    draws: Optional[Tuple] = None  # (stage, prefix_len, global prompt_starts | None)
    seed: int = 0  # the draws' generator, when `draws` is None
    steps: int = 1
    base_lr: float = 0.05
    # a full optimizer state and step to resume from (a checkpoint's)
    opt_state: Optional[Dict[str, Any]] = None
    start_step: int = 0
    return_state: bool = False  # also the full optimizer state after the steps
    # full gradients (a JAX-layout tree, or a file save_to wrote) for the
    # optimizer to apply instead of the batch's: the update alone, free of
    # the backward's rounding
    grads: Any = None
    save_to: Optional[str] = None  # rank 0 torch.saves {kind: {leaf: tensor}} here
    save: Tuple[str, ...] = ("grads", "params")  # the kinds save_to holds
    # files save_to wrote (one path or several): rank 0 reports, for each,
    # {kind: {leaf: (cosine, max |this − that|, max |that|)}} of its own
    # gathered tensors against the file's
    compare_to: Any = None


def make_optimizer(job: StepJob, model, leaves):
    """The trainer's optimizer for the job's name, rate and stage (its
    other flags at their defaults)."""
    from .trainer import _make_optimizer, get_parser

    args = get_parser().parse_args(["--optimizer", job.optimizer, "--base-lr",
                                    str(job.base_lr), "--train-stage", str(job.train_stage)])
    return _make_optimizer(args, model, leaves)


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().float().cpu().contiguous().numpy().tobytes()).hexdigest()


def _tree(named: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """{port parameter name: full tensor} → the JAX tree (stacked leaves)."""
    from ..convert import _leaf_name

    groups: Dict[str, list] = {}
    for name, t in named.items():
        groups.setdefault(_leaf_name(name), []).append((name, t))
    tree: Dict[str, Any] = {}
    for leaf, items in groups.items():
        arr = (torch.stack([t for _, t in items]) if items[0][0] != leaf else items[0][1])
        node = tree
        *path, last = leaf.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = arr.float().cpu().numpy()
    return tree


def calls(ranks, todo) -> list:
    """[fn(ranks, arg) for fn, arg in todo]: several jobs in one launch."""
    return [fn(ranks, arg) for fn, arg in todo]


def draw_job(ranks, args) -> Tuple[int, int, Optional[np.ndarray]]:
    """args = (cfg, global audio_lens, prefix_mode, seed) → this rank's
    train/loss.py::draw_step over its dp rows (stage, prefix_len, its rows'
    window starts)."""
    from ..parallel.mesh import dp_rows
    from .loss import draw_step

    cfg, lens, mode, seed = args
    lo, hi = dp_rows(len(lens), ranks.dp_rank, ranks.mesh.dp)
    dp = ranks.dp if ranks.dp.size > 1 else None
    stage, prefix_len, starts = draw_step(torch.Generator().manual_seed(seed), cfg,
                                          torch.as_tensor(lens[lo:hi], device=ranks.device),
                                          mode, dp)
    return stage, prefix_len, None if starts is None else starts.cpu().numpy()


def _apply(state, opt, tree: Dict[str, Any], ranks):
    """One optimizer update with this rank's slices of the full gradients
    `tree` (the whole batch's: every dp rank holds them already)."""
    from ..convert import _leaf
    from ..parallel.mesh import local_part
    from .step import leaf_grads

    if isinstance(tree, str):
        tree = torch.load(tree, mmap=True, weights_only=True)["grads"]
    for leaf in state.leaves:
        full = _leaf(tree, leaf.name) if leaf.name not in tree else tree[leaf.name]
        full = torch.as_tensor(np.asarray(full) if not isinstance(full, torch.Tensor) else full,
                               device=leaf.params[0].device)
        stacked = leaf.ndim != leaf.params[0].ndim
        for i, p in enumerate(leaf.params):
            g = full[i] if stacked else full
            if leaf.split is not None:
                g = local_part(g, leaf.split.dim - int(stacked), leaf.split.parts,
                               ranks.tp_rank, ranks.mesh.tp)
            p.grad = g.contiguous()
    state.opt_state = opt.apply(state.leaves, leaf_grads(state.leaves), state.opt_state)
    state.step += 1
    return state


def _compare(leaves, mine: Dict[str, Dict[str, torch.Tensor]], ref, ranks):
    """{kind: {leaf: (cosine, max |this − that|, max |that|)}} of this tp
    group's local tensors `mine` ({kind: {leaf: stacked local tensor}})
    against the full tensors of `ref` (a file save_to wrote), leaf by leaf:
    each rank holds its slices of the split leaves against the same slices
    of the reference, tp rank 0 the replicated ones, and one all-reduce of
    the dot products and squared norms (summed in f64) and one of the
    maxima put the whole leaves' numbers together, as if they had been
    gathered."""
    from ..parallel.mesh import local_part

    by_name = {leaf.name: leaf for leaf in leaves}
    keys, sums, peaks = [], [], []
    for kind, tensors in ref.items():
        for name, full in tensors.items():
            leaf, a = by_name[name], mine[kind][name].float().flatten()
            b = full.to(device=a.device, dtype=torch.float32)
            if leaf.split is not None:
                b = local_part(b, leaf.split.dim, leaf.split.parts, ranks.tp_rank, ranks.mesh.tp)
            b = b.flatten()
            keys.append((kind, name))
            if leaf.split is None and ranks.tp_rank != 0:
                sums.append(torch.zeros(3, dtype=torch.float64, device=a.device))
                peaks.append(torch.zeros(2, device=a.device))
                continue
            ad, bd = a.double(), b.double()
            sums.append(torch.stack([ad @ bd, ad @ ad, bd @ bd]))
            peaks.append(torch.stack([(a - b).abs().max(), b.abs().max()]))
    sums = ranks.tp.sum(torch.stack(sums)).tolist()
    peaks = (-ranks.tp.min(-torch.stack(peaks))).tolist()
    out: Dict[str, Dict[str, Tuple[float, float, float]]] = {}
    for (kind, name), (dot, aa, bb), (diff, top) in zip(keys, sums, peaks):
        cos = 1.0 if aa == bb == 0 else dot / max((aa * bb) ** 0.5, 1e-30)
        out.setdefault(kind, {})[name] = (cos, diff, top)
    return out


def _leaf_tensors(leaves, named: Dict[str, torch.Tensor]):
    """{port parameter name: tensor} → one tensor a leaf (stacked)."""
    from ..convert import _leaf_name

    pieces: Dict[str, list] = {}
    for name, t in named.items():
        pieces.setdefault(_leaf_name(name), []).append(t)
    return [torch.stack(pieces[leaf.name]) if leaf.ndim != leaf.params[0].ndim
            else pieces[leaf.name][0] for leaf in leaves]


def step_job(ranks, job: StepJob) -> Dict[str, Any]:
    """Run a StepJob's steps in this rank (see the module doc)."""
    from ..convert import load_tree
    from ..kernels import loader
    from ..models.vallex import VALLE
    from ..parallel.mesh import dp_batch, full_part, gather_params, gather_tree, shard_params
    from ..parallel.mesh import shard_tree
    from .step import init_train_state, leaf_grads, model_leaves, train_step
    from .trainer import to_device

    dev = ranks.device
    clock = [time.perf_counter()]
    seconds: Dict[str, float] = {}

    def lap(stage: str) -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        seconds[stage] = seconds.get(stage, 0.0) + now - clock[0]
        clock[0] = now

    tree = (torch.load(job.tree, mmap=True, weights_only=True) if isinstance(job.tree, str)
            else job.tree)
    model = load_tree(VALLE(job.cfg), tree, dtype=torch.float32, device="cpu")
    shard_params(model, ranks.mesh, ranks.tp_rank, ranks).to(dev)
    opt = make_optimizer(job, model, model_leaves(model))
    state = init_train_state(model, opt)
    opt_leaves = opt.state_leaves(state.leaves)
    if job.opt_state is not None:
        full = {k: ([[t.to(dev) for t in ts] for ts in v] if isinstance(v, list) else v)
                for k, v in job.opt_state.items()}
        state.opt_state = shard_tree(full, opt_leaves, ranks.tp_rank, ranks.mesh.tp)
        state.step = job.start_step
    batch = to_device(dp_batch(job.batch, ranks.dp_rank, ranks.mesh.dp), dev) if job.batch else {}
    draws = job.draws
    if draws is not None and draws[2] is not None:  # this rank's window starts
        from ..parallel.mesh import dp_rows

        lo, hi = dp_rows(len(draws[2]), ranks.dp_rank, ranks.mesh.dp)
        draws = (draws[0], draws[1], torch.as_tensor(np.asarray(draws[2])[lo:hi], device=dev))
    rng = torch.Generator().manual_seed(job.seed)
    lap("build")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    loader.reset_launch_counts()
    for _ in range(job.steps):
        if job.grads is not None:
            state, metrics = _apply(state, opt, job.grads, ranks), {}
            continue
        state, metrics = train_step(state, batch, rng, cfg=job.cfg, optimizer=opt,
                                    dtype=job.dtype, prefix_mode=job.prefix_mode,
                                    use_flash=job.use_flash, packed=job.packed, draws=draws)
    lap("steps")
    out = {
        "rank": ranks.rank,
        "metrics": {k: float(v) for k, v in metrics.items()},
        "local_params": sum(p.numel() for p in model.parameters()),
        "replicated": {leaf.name: [_digest(p) for p in leaf.params]
                       for leaf in state.leaves if leaf.split is None and ranks.mesh.tp > 1},
        "launches": {f"{k}@{s}": n for (k, s), n in loader.launch_counts.items()},
        "peak_bytes": (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None),
    }
    # the last step's gradients (train_step leaves the whole batch's, summed
    # over dp, in .grad) and the parameters after it, one tensor a leaf
    def one(leaf, ts):
        return torch.stack(list(ts)) if leaf.ndim != leaf.params[0].ndim else ts[0]

    local = {"grads": {leaf.name: one(leaf, gs)
                       for leaf, gs in zip(state.leaves, leaf_grads(state.leaves))},
             "params": {leaf.name: one(leaf, [p.detach() for p in leaf.params])
                        for leaf in state.leaves}}
    if job.compare_to and ranks.dp_rank == 0:  # dp index 0's tp group
        paths = [job.compare_to] if isinstance(job.compare_to, str) else job.compare_to
        found = [_compare(state.leaves, local, torch.load(path, mmap=True, weights_only=True),
                          ranks) for path in paths]
        if ranks.rank == 0:
            out["compare"] = found[0] if isinstance(job.compare_to, str) else found
        lap("compare")
    if job.save_to or not job.compare_to:  # the full trees, put back together over tp
        full = {}
        for leaf, gs in zip(state.leaves, leaf_grads(state.leaves)):
            stacked = leaf.ndim != leaf.params[0].ndim
            if leaf.split is not None:
                gs = [full_part(g.contiguous(), leaf.split.dim - int(stacked), leaf.split.parts,
                                leaf.tp) for g in gs]
            full[leaf.name] = one(leaf, gs)
        params = {leaf.name: t for leaf, t in zip(
            state.leaves, _leaf_tensors(state.leaves, gather_params(model)))}
        mine = {"grads": full, "params": params}
        lap("gather")
        if ranks.rank == 0 and job.save_to:
            torch.save({kind: {k: v.cpu() for k, v in mine[kind].items()} for kind in job.save},
                       job.save_to)
        elif ranks.rank == 0:
            out["grads"], out["params"] = _tree(full), _tree(params)
    if job.return_state:
        full = gather_tree(state.opt_state, opt_leaves)
        out["opt_state"] = {k: ([[t.cpu() for t in ts] for ts in v] if isinstance(v, list)
                                else v) for k, v in full.items()}
        out["step"] = state.step
    lap("save")
    out["seconds"] = seconds
    return out
