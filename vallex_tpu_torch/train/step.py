"""Training step: AdamW under the Eden schedule with global-norm clipping,
and the loss → backward → update of one step (port of
vallex_tpu/train/step.py).

The optimizers here are functional, as optax's are: `init(leaves)` makes
the state and `apply(leaves, grads, state)` updates the parameters in place
and returns the new state. A leaf is one array of the JAX package's
parameter tree: a single parameter, or the per-layer parameters
`layers.<i>.…` that the JAX tree stacks into one [NL, ...] array. Every
update here is elementwise except the norms, which the leaves make equal to
the JAX tree's (a per-tensor RMS is over the stacked array, as there).
Arithmetic is f32, as optax runs it on f32 parameters.

`make_optimizer` equals optax.chain(clip_by_global_norm(clip_norm),
adamw(eden, b1=0.9, b2=0.95, eps=1e-8, weight_decay)): the learning rate is
evaluated at optax's count, 0 on the first step, and the decay is
decoupled (added to the Adam direction before the learning rate).
`Masked` is optax.multi_transform({"train": tx, "freeze": set_to_zero()}):
the inner transform, its clipping norm included, sees only the trained
leaves; the others never move. `train_step`'s metrics["grad_norm"] is the
norm of every gradient before clipping.

dp × tp (a model sharded by parallel/mesh.py): a leaf that tp splits
carries its `split` and its tp group, and every whole-leaf reduction here
(the global norm, a leaf's RMS) sums its squares over tp, counting a
replicated leaf once, so each rank sees the single-process value;
`train_step` sums the gradients and the metrics over dp (the losses are
each rank's share of the global objective, train/loss.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..config import ModelConfig
from ..convert import jax_leaves

Schedule = Callable[[int], float]
Grads = List[List[torch.Tensor]]


class Leaf(NamedTuple):
    name: str  # the JAX tree path, dotted
    params: Tuple[torch.Tensor, ...]  # one, or the NL pieces of a stacked leaf
    ndim: int  # the JAX array's ndim
    split: Any = None  # parallel/mesh.py::Split when tp splits the leaf
    tp: Any = None  # and its tp group


def model_leaves(module: torch.nn.Module) -> List[Leaf]:
    """The module's parameters as the JAX tree's leaves, in its (sorted) order."""
    specs = getattr(module, "tp_specs", {})
    out = []
    for name, (params, stacked) in sorted(jax_leaves(module).items()):
        split = specs.get(name)
        out.append(Leaf(name, tuple(params), params[0].ndim + int(stacked), split,
                        module.tp if split is not None else None))
    return out


def leaf_grads(leaves: Sequence[Leaf]) -> Grads:
    """The leaves' .grad, zeros where autograd left None (optax sees zeros)."""
    return [[p.grad if p.grad is not None else torch.zeros_like(p) for p in leaf.params]
            for leaf in leaves]


def _sq(ts) -> torch.Tensor:
    return sum(t.float().square().sum() for t in ts)


def leaf_sq_sums(leaves: Optional[Sequence[Leaf]], grads: Grads) -> torch.Tensor:
    """[Σ g² per leaf], f32; a split leaf's over its tp group (one all-reduce
    for all of them)."""
    sums = torch.stack([_sq(gs) for gs in grads])
    tp = next((leaf.tp for leaf in leaves or () if leaf.tp is not None), None)
    if tp is None:
        return sums
    split = torch.tensor([leaf.tp is not None for leaf in leaves], device=sums.device)
    return torch.where(split, tp.sum(torch.where(split, sums, 0.0)), sums)


def global_norm(grads: Grads, leaves: Optional[Sequence[Leaf]] = None) -> torch.Tensor:
    """sqrt(Σ g²) over every tensor, f32, on the tensors' device (the whole
    model's under tp, given the leaves)."""
    if leaves is None or all(leaf.tp is None for leaf in leaves):
        return torch.sqrt(sum(g.float().square().sum() for gs in grads for g in gs))
    return torch.sqrt(leaf_sq_sums(leaves, grads).sum())


def leaf_rms(leaf: Leaf) -> torch.Tensor:
    """sqrt(mean(p²)) over the whole (stacked) leaf, all its tp slices."""
    n = sum(p.numel() for p in leaf.params)
    if leaf.tp is None:
        return torch.sqrt(_sq(leaf.params) / n)
    return torch.sqrt(leaf.tp.sum(_sq(leaf.params)) / (n * leaf.tp.size))


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def eden_schedule(base_lr: float = 0.05, lr_batches: float = 5000.0,
                  warmup: float = 500.0) -> Schedule:
    """Eden LR curve (reference: modules/optim.py:759-807, step term):
    lr = base · ((step² + B²)/B²)^-0.25 · min(1, 0.5 + 0.5·step/warmup), in
    f32 as the JAX schedule."""

    def fn(step: int) -> float:
        t = _f32(step)
        decay = ((t ** 2 + lr_batches ** 2) / lr_batches ** 2) ** -0.25
        ramp = torch.clamp(0.5 + 0.5 * t / warmup, max=1.0)
        return float(base_lr * decay * ramp)

    return fn


class Optimizer:
    """init(leaves) → state; apply(leaves, grads, state) → state, updating
    the parameters in place."""

    def init(self, leaves: Sequence[Leaf]) -> Dict[str, Any]:
        return {"count": 0,
                "mu": [[torch.zeros_like(p) for p in leaf.params] for leaf in leaves],
                "nu": [[torch.zeros_like(p) for p in leaf.params] for leaf in leaves]}

    def apply(self, leaves: Sequence[Leaf], grads: Grads, state: Dict[str, Any]
              ) -> Dict[str, Any]:
        raise NotImplementedError

    def state_leaves(self, leaves: Sequence[Leaf]) -> List[Leaf]:
        """The leaves the state's per-leaf lists follow."""
        return list(leaves)


def clip_by_global_norm(grads: Grads, max_norm: float,
                        leaves: Optional[Sequence[Leaf]] = None) -> Grads:
    """optax.clip_by_global_norm: g, or g / ‖g‖ · max_norm when ‖g‖ >= max_norm."""
    gn = global_norm(grads, leaves)
    keep = gn < max_norm
    return [[torch.where(keep, g, g / gn * max_norm) for g in gs] for gs in grads]


class AdamW(Optimizer):
    """(optional global-norm clipping) → optax.adamw: Adam's direction plus
    weight_decay · p, times −lr(count)."""

    def __init__(self, learning_rate: Schedule, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 1e-4,
                 clip_norm: Optional[float] = None):
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.weight_decay, self.clip_norm = weight_decay, clip_norm

    @torch.no_grad()
    def apply(self, leaves, grads, state):
        if self.clip_norm is not None:
            grads = clip_by_global_norm(grads, self.clip_norm, leaves)
        count = state["count"]
        lr = self.lr(count)
        c1 = 1.0 - float(_f32(self.b1) ** (count + 1))
        c2 = 1.0 - float(_f32(self.b2) ** (count + 1))
        for leaf, gs, ms, vs in zip(leaves, grads, state["mu"], state["nu"]):
            for p, g, m, v in zip(leaf.params, gs, ms, vs):
                g = g.float()
                m.mul_(self.b1).add_((1 - self.b1) * g)
                v.mul_(self.b2).add_((1 - self.b2) * g.square())
                u = (m / c1) / (torch.sqrt(v / c2) + self.eps)
                u = u + self.weight_decay * p
                p.add_(-lr * u)
        return {**state, "count": count + 1}


def make_optimizer(base_lr: float = 0.05, weight_decay: float = 1e-4, clip_norm: float = 1.0,
                   warmup: float = 500.0) -> AdamW:
    return AdamW(eden_schedule(base_lr, warmup=warmup), b1=0.9, b2=0.95,
                 weight_decay=weight_decay, clip_norm=clip_norm)


class Masked(Optimizer):
    """optax.multi_transform({"train": inner, "freeze": set_to_zero()}, labels):
    `inner` sees only the leaves whose label is True."""

    def __init__(self, inner: Optimizer, train: Sequence[bool]):
        self.inner, self.train = inner, list(train)

    def _pick(self, xs):
        return [x for x, t in zip(xs, self.train) if t]

    def init(self, leaves):
        return self.inner.init(self._pick(leaves))

    def state_leaves(self, leaves):
        return self._pick(leaves)

    def apply(self, leaves, grads, state):
        return self.inner.apply(self._pick(leaves), self._pick(grads), state)


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    leaves: List[Leaf]
    opt_state: Dict[str, Any]
    step: int = 0


def init_train_state(model: torch.nn.Module, optimizer: Optimizer) -> TrainState:
    """Unfreezes the model's parameters (they are built frozen) and makes
    the optimizer's state."""
    model.requires_grad_(True)
    leaves = model_leaves(model)
    return TrainState(model, leaves, optimizer.init(leaves), 0)


def dp_sum_grads(dp, grads: Grads) -> Grads:
    """Σ over the dp group of every gradient, as one flat all-reduce a dtype."""
    flat = [g for gs in grads for g in gs]
    out = {}
    for dtype in {g.dtype for g in flat}:
        same = [g for g in flat if g.dtype == dtype]
        buf = dp.sum_(torch.cat([g.reshape(-1) for g in same]))
        out.update(zip(map(id, same), buf.split([g.numel() for g in same])))
    return [[out[id(g)].view_as(g) for g in gs] for gs in grads]


def train_step(
    state: TrainState,
    batch: Dict[str, torch.Tensor],
    rng: torch.Generator,
    *,
    cfg: ModelConfig,
    optimizer: Optimizer,
    dtype: str = "bfloat16",
    prefix_mode: int = 1,
    use_flash=False,
    remat: bool = True,
    packed: bool = False,
    draws=None,
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step: loss, backward, update (in place). packed=True
    takes a collate_packed batch through total_loss_packed; `draws` fixes
    the step's (stage, prefix_len, prompt_starts). The metrics are detached
    device scalars, the global batch's under dp, where each parameter's
    .grad is left holding the global batch's gradient (summed over dp)."""
    from .loss import _dp, total_loss, total_loss_packed

    model, dt = state.model, getattr(torch, dtype)
    for leaf in state.leaves:
        for p in leaf.params:
            p.grad = None
    if packed:
        loss, metrics = total_loss_packed(model, cfg, batch, rng, dt, prefix_mode, remat,
                                          draws=draws)
    else:
        loss, metrics = total_loss(model, cfg, batch, rng, dt, prefix_mode, use_flash, remat,
                                   draws=draws)
    if loss.requires_grad:  # a dp rank with no rows has no graph: its gradients are zeros
        loss.backward()
    grads = leaf_grads(state.leaves)
    dp = _dp(model)
    if dp is not None:
        grads = dp_sum_grads(dp, grads)
        for leaf, gs in zip(state.leaves, grads):  # .grad: the whole batch's gradient
            for p, g in zip(leaf.params, gs):
                p.grad = g
        metrics = dict(zip(metrics, dp.sum(torch.stack(list(metrics.values())).detach())))
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["grad_norm"] = global_norm(grads, state.leaves)
    state.opt_state = optimizer.apply(state.leaves, grads, state.opt_state)
    state.step += 1
    return state, metrics
