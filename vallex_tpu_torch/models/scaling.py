"""Training-stability toolkit: the icefall "scaling" modules (port of
vallex_tpu/models/scaling.py; reference: modules/scaling.py,
modules/transformer.py:133-175).

- `double_swish`: x·σ(x − 1) (reference: modules/scaling.py:1156-1222);
- `BasicNorm`: x·(mean(x²) + exp(eps_log))^−½ with a learnable log-eps
  (modules/scaling.py:360-424); `BalancedBasicNorm` puts the activation
  balancer in front; `IdentityNorm` passes x through;
- `ScaledLinear`: a Linear ([in, out] kernel) with learnable log-scales on
  weight and bias (modules/scaling.py:427-449), and its effective weight;
- `activation_balancer`, `whiten`, `max_eig`: identity in the forward
  pass; their backward passes reshape the gradient as the JAX package's
  custom_vjp rules do (the balancer nudges gradients so each channel keeps
  its positive fraction and mean magnitude inside bounds; whiten pushes the
  activation covariance toward whiteness; max_eig shrinks a dominant
  direction). Each is a torch.autograd.Function.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


def double_swish(x: torch.Tensor) -> torch.Tensor:
    """DoubleSwish(x) = x · sigmoid(x − 1)."""
    return x * torch.sigmoid(x - 1.0)


# ---------------------------------------------------------------------------
# Gradient-only regularizers (identity forward)
# ---------------------------------------------------------------------------

class _ActivationBalancer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, min_positive, max_positive, max_factor, min_abs, max_abs):
        ctx.save_for_backward(x)
        ctx.bounds = (min_positive, max_positive, max_factor, min_abs, max_abs)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        min_positive, max_positive, max_factor, min_abs, max_abs = ctx.bounds
        xf = x.float()
        dims = tuple(range(x.dim() - 1))
        # sign constraint: the fraction of positive activations per channel
        frac_pos = (xf > 0).float().mean(dims, keepdim=True)
        factor_sign = torch.where(
            frac_pos < min_positive, -max_factor,
            torch.where(frac_pos > max_positive, max_factor, 0.0))
        # magnitude constraint: mean |x| per channel
        mean_abs = xf.abs().mean(dims, keepdim=True)
        factor_mag = ((mean_abs > max_abs).float() - (mean_abs < min_abs).float()) * max_factor
        gf = g.float()
        nudge = gf.abs() * (factor_sign * torch.sign(xf) + factor_mag * torch.sign(xf))
        return (gf + nudge).to(g.dtype), None, None, None, None, None


def activation_balancer(x: torch.Tensor, min_positive: float = 0.05,
                        max_positive: float = 0.95, max_factor: float = 0.01,
                        min_abs: float = 0.2, max_abs: float = 100.0) -> torch.Tensor:
    """Identity; the backward adds |g|-scaled nudges toward the bounds
    (reference: modules/scaling.py:639-761)."""
    return _ActivationBalancer.apply(x, min_positive, max_positive, max_factor, min_abs,
                                     max_abs)


class _Whiten(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, whitening_limit, grad_scale):
        ctx.save_for_backward(x)
        ctx.args = (whitening_limit, grad_scale)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        limit, scale = ctx.args
        xf = x.float().reshape(-1, x.shape[-1])
        cov = xf.T @ xf / max(xf.shape[0], 1)
        diag_mean = torch.diagonal(cov).mean()
        # whiteness: sum(cov²) / mean(diag)² is the dimension when white;
        # above `limit` times the dimension the penalty gradient acts
        metric = (cov ** 2).sum() / torch.clamp(diag_mean ** 2, min=1e-20)
        penalty = (xf @ cov).reshape(x.shape) * (
            4.0 * scale / torch.clamp((cov ** 2).sum(), min=1e-20))
        active = (metric > limit * x.shape[-1]).float()
        return (g.float() + active * penalty).to(g.dtype), None, None


def whiten(x: torch.Tensor, whitening_limit: float = 5.0,
           grad_scale: float = 0.01) -> torch.Tensor:
    """Identity; the backward adds a penalty gradient that pushes the
    activation covariance toward whiteness (reference: scaling.py:882+)."""
    return _Whiten.apply(x, whitening_limit, grad_scale)


class _MaxEig(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, max_var_per_eig, grad_scale):
        ctx.save_for_backward(x)
        ctx.args = (max_var_per_eig, grad_scale)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        max_var, scale = ctx.args
        xf = x.float().reshape(-1, x.shape[-1])
        xf = xf - xf.mean(0, keepdim=True)
        # one power-iteration step for the dominant direction, from the
        # column sums of the centred rows, as the JAX package's rule
        v = xf.sum(0)
        v = v / torch.clamp(torch.linalg.vector_norm(v), min=1e-20)
        proj = xf @ v  # [N]
        var_frac = (proj ** 2).sum() / torch.clamp((xf ** 2).sum(), min=1e-20)
        active = (var_frac > max_var).float()
        penalty = (proj[:, None] * v[None, :]).reshape(x.shape) * (
            2.0 * scale / torch.clamp((proj ** 2).sum(), min=1e-20))
        return (g.float() + active * penalty).to(g.dtype), None, None


def max_eig(x: torch.Tensor, max_var_per_eig: float = 0.2,
            grad_scale: float = 0.01) -> torch.Tensor:
    """Identity; the backward shrinks a dominant eigendirection of the
    activations (reference: scaling.py:1002+)."""
    return _MaxEig.apply(x, max_var_per_eig, grad_scale)


def balanced_double_swish(x: torch.Tensor) -> torch.Tensor:
    """ActivationBalancer + DoubleSwish (reference: modules/scaling.py:1225-1237)."""
    return double_swish(activation_balancer(x))


# ---------------------------------------------------------------------------
# Norms and ScaledLinear (trainable parameters, JAX leaf names)
# ---------------------------------------------------------------------------

class BasicNorm(nn.Module):
    def __init__(self, eps: float = 0.25):
        super().__init__()
        self.eps_log = nn.Parameter(torch.tensor(math.log(eps)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        scale = torch.rsqrt((xf ** 2).mean(-1, keepdim=True) + torch.exp(self.eps_log))
        return (xf * scale).to(x.dtype)


class BalancedBasicNorm(BasicNorm):
    """The activation balancer, then BasicNorm (the balancer holds no
    parameters)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(activation_balancer(x))


class IdentityNorm(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


class ScaledLinear(nn.Module):
    """y = x·(w·exp(w_scale_log)) + b·exp(b_scale_log), w stored [in, out];
    w and b drawn as torch's nn.Linear does (from `generator`)."""

    def __init__(self, d_in: int, d_out: int, initial_scale: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        bound = 1.0 / math.sqrt(d_in)
        self.w = nn.Parameter((torch.rand(d_in, d_out, generator=generator) * 2 - 1) * bound)
        self.b = nn.Parameter((torch.rand(d_out, generator=generator) * 2 - 1) * bound)
        self.w_scale_log = nn.Parameter(torch.tensor(math.log(initial_scale)))
        self.b_scale_log = nn.Parameter(torch.tensor(math.log(initial_scale)))

    def effective_weight(self) -> torch.Tensor:
        return self.w * torch.exp(self.w_scale_log)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = self.b * torch.exp(self.b_scale_log)
        return x @ self.effective_weight().to(x.dtype) + b.to(x.dtype)
