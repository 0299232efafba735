"""The trainer: the CLI of vallex_tpu/train/trainer.py over the port's
train step, on one GPU (or the CPU with --device cpu).

    python -m vallex_tpu_torch.train.trainer --data-dir data --exp-dir exp \\
        --num-epochs 10 --train-stage 1

- model: random init from --seed (models/vallex.py::init_vallex), or with
  --init-checkpoint the weights of a native `.npz` (utils/checkpoint.py
  load_native) or of the reference's torch checkpoint (any other suffix,
  converted); f32 parameters, compute in --dtype (bfloat16 by default, as
  the JAX trainer);
- attention: --flash-attn auto is the flash kernels for batches of 800 or
  more frames on the card (the JAX package's routing) and the mask path on
  the CPU; on / off force either;
- optimizer: ScaledAdam (default), Eve or AdamW under an Eden schedule;
  --train-stage 1 / 2 trains the AR / NAR parameters only, the others stay
  as they are (optax.multi_transform with set_to_zero in the JAX trainer);
- checkpoints: `state-XXXXXXXX` (torch.save of the model's state_dict, the
  optimizer state and the step) plus `state-XXXXXXXX.json` (epoch, step,
  args) at each epoch's end and every --save-every steps; --resume picks up
  the newest in --exp-dir;
- observability: loss and grad-norm lines every --log-interval steps,
  gradient-norm quartiles and the dominant leaf every --diag-interval
  steps, the validation loss every --valid-interval steps, and with
  --visualize-dir heatmap PNGs of the first validation batch's
  activations (train/loss.py::debug_activations, utils/visualizer.py).

The losses are VALL-E's: --model-name VALL-F or Transformer raises when the
trainer is built (the JAX trainer builds them and then fails inside
total_loss, which reads VALL-E's parameters). Not ported yet, raising
NotImplementedError: --dp / --tp above 1 and --init-distributed (multi-GPU
training, ROADMAP §1 items 7-8).
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
        description="Train VALL-E X (PyTorch, one GPU) — AR/NAR stages"
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
    g.add_argument("--dp", type=int, default=0, help="0 = auto (one GPU)")
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
        help="multi-process training (not ported yet)",
    )
    g.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    return parser


def _check_args(args) -> None:
    if args.init_distributed or args.dp > 1 or args.tp > 1:
        raise NotImplementedError(
            "multi-GPU training (--dp/--tp above 1, --init-distributed) is not ported to"
            " vallex_tpu_torch yet (ROADMAP §1 items 7-8)")
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


def run(args) -> dict:
    import torch

    from ..convert import load_tree
    from ..data.datamodule import TtsDataModule
    from ..kernels import check_head_dim
    from ..models import get_model, model_config_from_args
    from ..models.vallex import VALLE
    from ..utils.checkpoint import load_native, load_torch_checkpoint
    from .loss import debug_activations, total_loss
    from .scaled_adam import format_grad_diagnostics, grad_diagnostics
    from .step import init_train_state, leaf_grads, model_leaves, train_step

    _check_args(args)
    device = torch.device(args.device)
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
    model = load_tree(VALLE(cfg), tree, dtype=torch.float32, device=device)
    dtype = getattr(torch, args.dtype)

    use_flash = {"on": True, "off": False,
                 "auto": "auto" if device.type == "cuda" else False}[args.flash_attn]
    if getattr(args, "pack", 1) > 1 and cfg.prefix_mode not in (0, 1):
        raise SystemExit(
            "--pack requires prefix_mode 0 or 1 (modes 2/4 prepend prompt "
            "buffers and train unpacked)"
        )
    optimizer = _make_optimizer(args, model, model_leaves(model))
    state = init_train_state(model, optimizer)

    start_epoch, global_step = 0, 0
    if args.resume:
        ck = _latest_checkpoint(args.exp_dir)
        if ck:
            saved = torch.load(ck, map_location=device, weights_only=True)
            model.load_state_dict(saved["model"])
            state.opt_state, state.step = saved["opt_state"], saved["step"]
            with open(ck + ".json") as f:
                meta = json.load(f)
            start_epoch, global_step = meta["epoch"], meta["step"]
            log.info("resumed %s (epoch %d step %d)", ck, start_epoch, global_step)

    datamodule = TtsDataModule(args)
    os.makedirs(args.exp_dir, exist_ok=True)

    def save(epoch: int) -> None:
        path = os.path.join(args.exp_dir, f"state-{global_step:08d}")
        torch.save({"model": model.state_dict(), "opt_state": state.opt_state,
                    "step": state.step}, path)
        with open(path + ".json", "w") as f:
            json.dump({"epoch": epoch, "step": global_step, "args": vars(args)}, f,
                      default=str)
        log.info("saved %s", path)

    def step_generator(seed_state: torch.Tensor) -> torch.Generator:
        g = torch.Generator()
        g.set_state(seed_state)
        return g

    rng = torch.Generator().manual_seed(args.seed)
    last_metrics = {}
    t0 = time.time()
    for epoch in range(start_epoch, args.num_epochs):
        for np_batch in datamodule.train_dataloaders(epoch):
            batch = to_device(np_batch, device)
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
                log.info("epoch %d step %d %s (%.2f it/s)", epoch, global_step,
                         " ".join(f"{k}={v:.4f}" for k, v in last_metrics.items()), rate)
            if global_step % args.diag_interval == 0 and not packed:
                # the unpacked objective at the updated parameters, with
                # the step's draws
                for leaf in state.leaves:
                    for p in leaf.params:
                        p.grad = None
                total_loss(model, cfg, batch, step_generator(step_rng), dtype,
                           cfg.prefix_mode, use_flash)[0].backward()
                log.info("%s", format_grad_diagnostics(
                    grad_diagnostics(state.leaves, leaf_grads(state.leaves))))
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
                        tb = to_device(vb, device)
                        losses.append(float(total_loss(
                            model, cfg, tb, step_generator(step_rng),
                            dtype, cfg.prefix_mode, use_flash)[0]))
                        if i == 0 and args.visualize_dir:
                            from ..utils.visualizer import visualize

                            visualize(debug_activations(model, cfg, tb, dtype), vb,
                                      args.visualize_dir)
                if losses:
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
