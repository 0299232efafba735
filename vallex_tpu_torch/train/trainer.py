"""The trainer: the CLI of vallex_tpu/train/trainer.py over the port's
train step, on the GPUs (or the CPU with --device cpu).

    python -m vallex_tpu_torch.train.trainer --data-dir data --exp-dir exp \\
        --num-epochs 10 --train-stage 1 --dp 4 --tp 2

- model: random init from --seed (models/vallex.py::init_vallex), or with
  --init-checkpoint the weights of a native `.npz` (utils/checkpoint.py
  load_native) or of the reference's torch checkpoint (any other suffix,
  converted); f32 parameters, compute in --dtype (bfloat16 by default, as
  the JAX trainer);
- mesh: --dp data-parallel × --tp tensor-parallel ranks (parallel/mesh.py;
  --dp 0 = the GPUs over --tp, 1 on the CPU). Above one rank the trainer
  starts one process per rank on this host (parallel/launch.py), as one
  JAX process drives every local device; with --init-distributed it is one
  rank of a world that `torchrun` started (RANK, WORLD_SIZE, LOCAL_RANK;
  WORLD_SIZE must be dp · tp), on cuda:LOCAL_RANK. Every dp rank reads the
  same stream of global batches (shard (0, 1); under --init-distributed
  shard (node, nodes), as JAX shards by process) and trains on its rows;
  the step is the global batch's (train/loss.py, train/step.py);
- attention: --flash-attn auto is the flash kernels for batches of 800 or
  more frames on the card (the JAX package's routing) and the mask path on
  the CPU; on / off force either;
- optimizer: ScaledAdam (default), Eve or AdamW under an Eden schedule;
  --train-stage 1 / 2 trains the AR / NAR parameters only, the others stay
  as they are (optax.multi_transform with set_to_zero in the JAX trainer);
- checkpoints: `state-XXXXXXXX` (torch.save of the full, unsharded
  parameters by name, the optimizer state and the step) plus
  `state-XXXXXXXX.json` (epoch, step, args) at each epoch's end and every
  --save-every steps, written by rank 0; --resume picks up the newest in
  --exp-dir, at any (dp, tp);
- observability (rank 0): loss and grad-norm lines every --log-interval
  steps, gradient-norm quartiles and the dominant leaf every
  --diag-interval steps, the validation loss every --valid-interval steps,
  and with --visualize-dir heatmap PNGs of the first validation batch's
  activations (train/loss.py::debug_activations, utils/visualizer.py).

The losses are VALL-E's: --model-name VALL-F or Transformer raises when the
trainer is built (the JAX trainer builds them and then fails inside
total_loss, which reads VALL-E's parameters).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Optional

import numpy as np

log = logging.getLogger("vallex_tpu_torch.train")


def get_parser() -> argparse.ArgumentParser:
    from ..data.datamodule import TtsDataModule
    from ..models import add_model_arguments

    parser = argparse.ArgumentParser(
        description="Train VALL-E X (PyTorch, GPUs) — AR/NAR stages"
    )
    add_model_arguments(parser)
    TtsDataModule.add_arguments(parser)
    g = parser.add_argument_group("training")
    g.add_argument("--exp-dir", type=str, default="exp")
    g.add_argument("--num-epochs", type=int, default=20)
    g.add_argument(
        "--train-stage", type=int, default=0, choices=(0, 1, 2),
        help="0 = joint, 1 = AR params only, 2 = NAR params only "
             "(reference models/vallex.py:266-292)",
    )
    g.add_argument(
        "--optimizer", type=str, default="scaled_adam",
        choices=("scaled_adam", "adamw", "eve"),
    )
    g.add_argument(
        "--flash-attn", type=str, default="auto",
        choices=("auto", "on", "off"),
        help="route the training attention through the flash kernels "
             "(auto = from 800 frames on the GPU, off on the CPU)",
    )
    g.add_argument("--base-lr", type=float, default=0.05)
    g.add_argument("--warmup-steps", type=int, default=500)
    g.add_argument("--weight-decay", type=float, default=1e-4)
    g.add_argument("--dtype", type=str, default="bfloat16")
    g.add_argument("--dp", type=int, default=0,
                   help="0 = auto (the GPUs over --tp; 1 on the CPU)")
    g.add_argument("--tp", type=int, default=1)
    g.add_argument("--save-every", type=int, default=2000)
    g.add_argument("--log-interval", type=int, default=50)
    g.add_argument("--diag-interval", type=int, default=500)
    g.add_argument("--valid-interval", type=int, default=2000)
    g.add_argument("--resume", action="store_true")
    g.add_argument(
        "--init-checkpoint", type=str, default=None,
        help="warm-start params from a .npz/.pt checkpoint",
    )
    g.add_argument(
        "--visualize-dir", type=str, default=None,
        help="dump validation heatmap PNGs here (needs matplotlib)",
    )
    g.add_argument(
        "--init-distributed", action="store_true",
        help="join a world that torchrun started (RANK, WORLD_SIZE, LOCAL_RANK)",
    )
    g.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    return parser


def _check_args(args) -> None:
    if args.model_name.lower().replace("-", "") != "valle":
        raise ValueError(
            f"--model-name {args.model_name}: the training losses (train/loss.py) are"
            " VALL-E's; VALL-F and the Transformer TTS have no training objective here (the"
            " JAX trainer fails inside total_loss for them)")


def _make_optimizer(args, model, leaves):
    from ..models.vallex import stage_param_labels
    from .scaled_adam import eden_schedule, eve, scaled_adam
    from .step import Masked
    from .step import make_optimizer as make_adamw

    sched = eden_schedule(args.base_lr, warmup=float(args.warmup_steps))
    if args.optimizer == "scaled_adam":
        base = scaled_adam(sched)
    elif args.optimizer == "eve":
        base = eve(sched, weight_decay=args.weight_decay)
    else:
        base = make_adamw(args.base_lr, args.weight_decay, warmup=float(args.warmup_steps))
    if args.train_stage in (1, 2):
        labels = stage_param_labels(model, args.train_stage)
        by_id = {id(p): labels[n] for n, p in model.named_parameters()}
        return Masked(base, [by_id[id(leaf.params[0])] for leaf in leaves])
    return base


def _latest_checkpoint(exp_dir: str) -> Optional[str]:
    if not os.path.isdir(exp_dir):
        return None
    cands = [os.path.join(exp_dir, d) for d in os.listdir(exp_dir)
             if d.startswith("state-") and not d.endswith(".json")
             and os.path.isfile(os.path.join(exp_dir, d))]
    return max(cands, key=lambda p: (os.path.getmtime(p), p)) if cands else None


def to_device(batch: dict, device) -> dict:
    """A collated numpy batch → tensors on `device` (non-array fields drop)."""
    import torch

    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()
            if isinstance(v, np.ndarray)}


def mesh_dims(args) -> tuple:
    """(dp, tp): --dp 0 is the GPUs over --tp (WORLD_SIZE over --tp under
    --init-distributed), 1 on the CPU."""
    import torch

    dp = args.dp
    if dp == 0:
        if args.init_distributed:
            dp = int(os.environ.get("WORLD_SIZE", args.tp)) // args.tp
        elif args.device == "cuda":
            dp = torch.cuda.device_count() // args.tp
        dp = max(dp, 1)
    return dp, args.tp


def run(args) -> dict:
    """Train as args say → {"step", "metrics"} (and "state" when one
    process trains; otherwise rank 0's step and metrics)."""
    import torch

    from ..parallel.launch import run_ranks
    from ..parallel.mesh import make_mesh

    _check_args(args)
    dp, tp = mesh_dims(args)
    if args.init_distributed:
        import torch.distributed as dist

        ranks = _join_torchrun(args, dp, tp)
        try:
            out = train(args, ranks)
        finally:
            dist.destroy_process_group()
        return out
    if dp * tp == 1:
        return train(args, None)
    if args.device == "cuda":
        n = torch.cuda.device_count()
        if n < dp * tp:
            raise RuntimeError(f"--dp {dp} --tp {tp} needs {dp * tp} GPUs; {n} visible")
        from ..kernels import loader

        loader.build()  # once, before the ranks load it
        devices = [f"cuda:{i}" for i in range(dp * tp)]
    else:
        devices = ["cpu"] * (dp * tp)
    # by its module's name, which the ranks import (not this __main__)
    from .trainer import _rank_main

    out = run_ranks(make_mesh(dp, tp, devices), _rank_main, args,
                    threads=1 if args.device == "cpu" else None)
    return out[0]


def _rank_main(ranks, args) -> dict:
    logging.basicConfig(level=logging.INFO if ranks.rank == 0 else logging.WARNING,
                        format="%(asctime)s %(levelname)s [%(name)s] %(message)s")
    out = train(args, ranks)
    out.pop("state")
    return out


def _join_torchrun(args, dp: int, tp: int):
    """This process's rank in the world torchrun started (its env://)."""
    from ..parallel.mesh import Mesh, init_process_groups

    try:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    except KeyError as e:
        raise RuntimeError(f"--init-distributed: {e.args[0]} is not set; start the"
                           " trainer with torchrun") from None
    if world != dp * tp:
        raise RuntimeError(f"--init-distributed: WORLD_SIZE {world} != --dp {dp} x --tp {tp}")
    nodes = world // local_world
    if local_world % tp or dp % nodes:
        raise RuntimeError(f"--init-distributed: {nodes} nodes of {local_world} ranks do not"
                           f" hold whole tp groups of {tp} and equal shares of dp {dp}")
    devices = [(f"cuda:{r % local_world}" if args.device == "cuda" else "cpu")
               for r in range(world)]
    args.data_shard = (rank // local_world, nodes)
    return init_process_groups(Mesh(dp, tp, devices), rank)


def _rows_of(args, ranks):
    """(this rank's dp index among the ranks that read its node's batches,
    their number)."""
    if ranks is None:
        return 0, 1
    nodes = getattr(args, "data_shard", (0, 1))[1]
    per_node = ranks.mesh.dp // nodes
    return ranks.dp_rank % per_node, per_node


def train(args, ranks=None) -> dict:
    """The training loop of one process: alone (`ranks` None) or one rank
    of a dp × tp mesh (parallel/mesh.py::Ranks)."""
    import torch

    from ..convert import load_tree
    from ..data.datamodule import TtsDataModule
    from ..kernels import check_head_dim
    from ..models import get_model, model_config_from_args
    from ..models.vallex import VALLE
    from ..parallel.mesh import dp_batch, gather_params, gather_tree, shard_params, shard_tree
    from ..utils.checkpoint import load_native, load_torch_checkpoint
    from .loss import debug_activations, total_loss
    from .scaled_adam import format_grad_diagnostics, grad_diagnostics
    from .step import (dp_sum_grads, init_train_state, leaf_grads, model_leaves,
                       train_step)

    _check_args(args)
    device = ranks.device if ranks is not None else torch.device(args.device)
    lead = ranks is None or ranks.rank == 0  # logs and writes
    cfg = model_config_from_args(args)
    check_head_dim(cfg.head_dim, device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to train on the CPU")
    init_fn, _module = get_model(args.model_name, cfg)
    if not args.init_checkpoint:
        tree = init_fn(cfg, torch.Generator().manual_seed(args.seed))
    elif args.init_checkpoint.endswith(".npz"):
        tree = load_native(args.init_checkpoint)
    else:  # the reference's vallex-checkpoint.pt ({"model": state_dict})
        tree = load_torch_checkpoint(args.init_checkpoint, cfg)
    # full parameters first (on the CPU when they are to be sharded)
    model = load_tree(VALLE(cfg), tree, dtype=torch.float32,
                      device=device if ranks is None else "cpu")
    dtype = getattr(torch, args.dtype)

    use_flash = {"on": True, "off": False,
                 "auto": "auto" if device.type == "cuda" else False}[args.flash_attn]
    if getattr(args, "pack", 1) > 1 and cfg.prefix_mode not in (0, 1):
        raise SystemExit(
            "--pack requires prefix_mode 0 or 1 (modes 2/4 prepend prompt "
            "buffers and train unpacked)"
        )
    start_epoch, global_step = 0, 0
    saved = None
    ck = _latest_checkpoint(args.exp_dir) if args.resume else None
    if ck:
        # full tensors, whatever (dp, tp) wrote them
        saved = torch.load(ck, map_location=device, weights_only=True)
        model.load_state_dict({k: v.to(model.pe.device) for k, v in saved["model"].items()})
        with open(ck + ".json") as f:
            meta = json.load(f)
        start_epoch, global_step = meta["epoch"], meta["step"]
    if ranks is not None:
        shard_params(model, ranks.mesh, ranks.tp_rank, ranks).to(device)
    optimizer = _make_optimizer(args, model, model_leaves(model))
    state = init_train_state(model, optimizer)
    opt_leaves = optimizer.state_leaves(state.leaves)
    if saved is not None:
        state.opt_state, state.step = saved["opt_state"], saved["step"]
        if ranks is not None:
            state.opt_state = shard_tree(state.opt_state, opt_leaves, ranks.tp_rank,
                                         ranks.mesh.tp)
        if lead:
            log.info("resumed %s (epoch %d step %d)", ck, start_epoch, global_step)
    dp = ranks.dp if ranks is not None and ranks.dp.size > 1 else None
    row_rank, row_ranks = _rows_of(args, ranks)

    datamodule = TtsDataModule(args)
    if lead:
        os.makedirs(args.exp_dir, exist_ok=True)

    def save(epoch: int) -> None:
        # the dp index 0 ranks gather the tp slices, rank 0 writes
        if ranks is not None and ranks.dp_rank != 0:
            return
        params = gather_params(model) if ranks is not None else model.state_dict()
        opt = gather_tree(state.opt_state, opt_leaves) if ranks is not None else state.opt_state
        if not lead:
            return
        path = os.path.join(args.exp_dir, f"state-{global_step:08d}")
        torch.save({"model": params, "opt_state": opt, "step": state.step}, path)
        with open(path + ".json", "w") as f:
            json.dump({"epoch": epoch, "step": global_step, "args": vars(args)}, f,
                      default=str)
        log.info("saved %s", path)

    def step_generator(seed_state: torch.Tensor) -> torch.Generator:
        g = torch.Generator()
        g.set_state(seed_state)
        return g

    def rows(np_batch: dict) -> dict:
        return to_device(dp_batch(np_batch, row_rank, row_ranks), device)

    rng = torch.Generator().manual_seed(args.seed)
    last_metrics = {}
    t0 = time.time()
    for epoch in range(start_epoch, args.num_epochs):
        for np_batch in datamodule.train_dataloaders(epoch):
            batch = rows(np_batch)
            # --pack N batches arrive packed (p_* arrays); a residual small
            # batch comes unpacked, so dispatch per batch
            packed = "p_text_ids" in batch
            step_rng = rng.get_state()  # what this step draws from, for the diagnostics
            state, metrics = train_step(
                state, batch, rng, cfg=cfg, optimizer=optimizer, dtype=args.dtype,
                prefix_mode=cfg.prefix_mode, use_flash=use_flash, packed=packed)
            global_step += 1
            if global_step % args.log_interval == 0:
                last_metrics = {k: float(v) for k, v in metrics.items()}
                rate = args.log_interval / (time.time() - t0)
                t0 = time.time()
                if lead:
                    log.info("epoch %d step %d %s (%.2f it/s)", epoch, global_step,
                             " ".join(f"{k}={v:.4f}" for k, v in last_metrics.items()), rate)
            if global_step % args.diag_interval == 0 and not packed:
                # the unpacked objective at the updated parameters, with
                # the step's draws
                for leaf in state.leaves:
                    for p in leaf.params:
                        p.grad = None
                loss = total_loss(model, cfg, batch, step_generator(step_rng), dtype,
                                  cfg.prefix_mode, use_flash)[0]
                if loss.requires_grad:
                    loss.backward()
                grads = leaf_grads(state.leaves)
                if dp is not None:
                    grads = dp_sum_grads(dp, grads)
                diag = format_grad_diagnostics(grad_diagnostics(state.leaves, grads))
                if lead:
                    log.info("%s", diag)
                for leaf in state.leaves:
                    for p in leaf.params:
                        p.grad = None
            if global_step % args.save_every == 0:
                save(epoch)
            if global_step % args.valid_interval == 0:
                losses = []
                with torch.no_grad():
                    for i, vb in enumerate(datamodule.valid_dataloaders()):
                        if i >= 20:
                            break
                        tb = rows(vb)
                        loss = total_loss(model, cfg, tb, step_generator(step_rng), dtype,
                                          cfg.prefix_mode, use_flash)[0]
                        losses.append(float(loss if dp is None else dp.sum(loss)))
                        if (i == 0 and args.visualize_dir and len(tb["codes"])
                                and (ranks is None or ranks.dp_rank == 0)):
                            from ..utils.visualizer import visualize

                            act = debug_activations(model, cfg, tb, dtype)
                            if lead:
                                visualize(act, dp_batch(vb, row_rank, row_ranks),
                                          args.visualize_dir)
                if losses and lead:
                    log.info("valid loss %.4f (%d batches)", float(np.mean(losses)),
                             len(losses))
        save(epoch + 1)
    return {"step": global_step, "metrics": last_metrics, "state": state}


def main() -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s [%(name)s] %(message)s",
    )
    run(get_parser().parse_args())


if __name__ == "__main__":
    main()
