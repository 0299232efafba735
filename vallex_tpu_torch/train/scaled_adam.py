"""ScaledAdam and Eve with the Eden and Noam schedules (port of
vallex_tpu/train/scaled_adam.py), on the leaves of train/step.py.

- ScaledAdam: Adam whose step is proportional to the parameter's RMS
  (per JAX leaf, clipped to [1e-5, 3]), with the gradients clipped to a
  global norm of 2; its schedule is evaluated at count + 1, as the JAX
  transform's.
- Eve: AdamW whose decay applies only to leaves of more than one dimension,
  scaled by clip(rms / target_rms, 0, 2); the decay is added to the Adam
  direction before the whole is scaled by −lr (so weights shrink), and the
  schedule is evaluated at Adam's count after its increment.
- grad_diagnostics / format_grad_diagnostics: per-leaf gradient norms, their
  quartiles and the dominant leaf.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from .step import Grads, Leaf, Optimizer, Schedule, _f32, global_norm, leaf_rms


def eden_schedule(base_lr: float = 0.05, lr_batches: float = 5000.0, lr_epochs: float = 4.0,
                  steps_per_epoch: float = 10000.0, warmup: float = 500.0) -> Schedule:
    """Eden: lr = base · ((t²+B²)/B²)^-¼ · ((e²+E²)/E²)^-¼ · warmup, f32."""

    def fn(step: int) -> float:
        t = _f32(step)
        e = t / steps_per_epoch
        decay_b = ((t ** 2 + lr_batches ** 2) / lr_batches ** 2) ** -0.25
        decay_e = ((e ** 2 + lr_epochs ** 2) / lr_epochs ** 2) ** -0.25
        ramp = torch.clamp(0.5 + 0.5 * t / warmup, max=1.0)
        return float(base_lr * decay_b * decay_e * ramp)

    return fn


def noam_schedule(base_lr: float, d_model: int = 1024, warmup: float = 4000.0) -> Schedule:
    """NoamScheduler curve (reference: modules/scheduler.py:24-27)."""

    def fn(step: int) -> float:
        t = torch.clamp(_f32(step), min=1.0)
        return float(base_lr * d_model ** -0.5 * torch.minimum(t ** -0.5, t * warmup ** -1.5))

    return fn


def _lr(learning_rate, count: int) -> float:
    return learning_rate(count) if callable(learning_rate) else float(learning_rate)


class ScaledAdam(Optimizer):
    """Adam with a parameter-RMS-proportional step and global RMS clipping."""

    def __init__(self, learning_rate, b1: float = 0.9, b2: float = 0.98, eps: float = 1e-8,
                 clipping_scale: float = 2.0, param_min_rms: float = 1e-5,
                 param_max_rms: float = 3.0):
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.clipping_scale = clipping_scale
        self.param_min_rms, self.param_max_rms = param_min_rms, param_max_rms

    @torch.no_grad()
    def apply(self, leaves, grads, state):
        count = state["count"] + 1
        lr = _lr(self.lr, count)
        clip = torch.clamp(self.clipping_scale / torch.clamp(global_norm(grads), min=1e-12),
                           max=1.0)
        c1 = 1.0 - float(_f32(self.b1) ** count)
        c2 = 1.0 - float(_f32(self.b2) ** count)
        for leaf, gs, ms, vs in zip(leaves, grads, state["mu"], state["nu"]):
            scale = torch.clamp(leaf_rms(leaf), self.param_min_rms, self.param_max_rms)
            for p, g, m, v in zip(leaf.params, gs, ms, vs):
                g = g.float() * clip
                m.copy_(self.b1 * m + (1 - self.b1) * g)
                v.copy_(self.b2 * v + (1 - self.b2) * g * g)
                p.add_(-lr * scale * (m / c1) / (torch.sqrt(v / c2) + self.eps))
        return {**state, "count": count}


def scaled_adam(learning_rate, **kw) -> ScaledAdam:
    return ScaledAdam(learning_rate, **kw)


class Eve(Optimizer):
    """optax.scale_by_adam, + decay · p on leaves of ndim > 1, times −lr."""

    def __init__(self, learning_rate, b1: float = 0.9, b2: float = 0.98, eps: float = 1e-8,
                 weight_decay: float = 1e-3, target_rms: float = 0.1):
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.weight_decay, self.target_rms = weight_decay, target_rms

    @torch.no_grad()
    def apply(self, leaves, grads, state):
        count = state["count"] + 1
        lr = _lr(self.lr, count)
        c1 = 1.0 - float(_f32(self.b1) ** count)
        c2 = 1.0 - float(_f32(self.b2) ** count)
        for leaf, gs, ms, vs in zip(leaves, grads, state["mu"], state["nu"]):
            decay = None
            if leaf.ndim > 1:  # no decay on biases and scales
                decay = self.weight_decay * torch.clamp(leaf_rms(leaf) / self.target_rms,
                                                        0.0, 2.0)
            for p, g, m, v in zip(leaf.params, gs, ms, vs):
                g = g.float()
                m.mul_(self.b1).add_((1 - self.b1) * g)
                v.mul_(self.b2).add_((1 - self.b2) * g.square())
                u = (m / c1) / (torch.sqrt(v / c2) + self.eps)
                if decay is not None:
                    u = u + decay * p
                p.add_(-lr * u)
        return {**state, "count": count}


def eve(learning_rate, **kw) -> Eve:
    return Eve(learning_rate, **kw)


def grad_diagnostics(leaves: Sequence[Leaf], grads: Grads) -> Dict:
    """Per-leaf gradient norms, their total, quartiles and the dominant leaf
    (the ScaledAdam reports of modules/optim.py:370-420)."""
    norms = torch.stack([torch.sqrt(sum(g.float().square().sum() for g in gs))
                         for gs in grads])
    total = torch.sqrt((norms ** 2).sum())
    quart = torch.quantile(norms, torch.tensor([0.0, 0.25, 0.5, 0.75, 1.0],
                                               device=norms.device))
    dom = int(torch.argmax(norms))
    return {
        "names": [leaf.name for leaf in leaves],
        "norms": norms,
        "total_norm": total,
        "quartiles": quart,
        "dominant_idx": dom,
        "dominant_frac": (norms[dom] / torch.clamp(total, min=1e-12)) ** 2,
    }


def format_grad_diagnostics(diag: Dict) -> str:
    q = diag["quartiles"].tolist()
    i = int(diag["dominant_idx"])
    return (
        f"grad-norm quartiles [min/25/50/75/max] = "
        f"{q[0]:.3e}/{q[1]:.3e}/{q[2]:.3e}/{q[3]:.3e}/{q[4]:.3e}, "
        f"total={float(diag['total_norm']):.3e}; dominant param "
        f"{diag['names'][i]} ({100 * float(diag['dominant_frac']):.1f}% "
        f"of squared grad norm)"
    )
