"""Parameter trees → the port's modules.

`params_from_jax(tree)` takes the JAX package's parameters as a nested dict
of numpy arrays — `jax.tree.map(np.asarray, params)` of `init_vallex` /
`init_vocos` or a loaded checkpoint — and returns the port's `VALLE` or
`Vocos` module holding the same values. Module paths mirror the tree: a
stacked leaf `[NL, ...]` under `layers` (or `blocks`) feeds the NL
per-layer modules `layers.<i>.…`. The random inits of this package build
the same tree, so one loader serves both.

`tree_from_module(module)` is the inverse: the module's parameters, or
their gradients, as that tree of numpy arrays (the per-layer pieces stacked
into one [NL, ...] leaf again), so a test can hold the port's gradients
against `jax.grad` leaf by leaf. `jax_leaves(module)` groups the parameters
by the leaf they came from.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .config import ModelConfig


def _leaf(tree: Dict[str, Any], name: str):
    node, index = tree, None
    for part in name.split("."):
        if part.isdigit():
            index = int(part)
            continue
        node = node[part]
    return node if index is None else node[index]


def _leaf_name(name: str) -> str:
    return ".".join(q for q in name.split(".") if not q.isdigit())


def jax_leaves(module: nn.Module) -> Dict[str, Tuple[List[nn.Parameter], bool]]:
    """{JAX leaf name (dotted): (its parameters in layer order, stacked)};
    a stacked leaf is the [NL, ...] array the per-layer parameters
    `layers.<i>.…` came from."""
    out: Dict[str, Tuple[List[nn.Parameter], bool]] = {}
    for name, p in module.named_parameters():
        key = _leaf_name(name)
        out.setdefault(key, ([], key != name))[0].append(p)
    return out


def tree_from_module(module: nn.Module, *, grad: bool = False) -> Dict[str, Any]:
    """The module's parameters (or with `grad`, their .grad; None counts as
    zeros) → the JAX parameter tree, f32 numpy leaves (copies)."""
    tree: Dict[str, Any] = {}
    for name, (params, stacked) in jax_leaves(module).items():
        vals = [(p.grad if p.grad is not None else torch.zeros_like(p)) if grad
                else p.detach() for p in params]
        arr = torch.stack(vals) if stacked else vals[0]
        node = tree
        *path, last = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = np.array(arr.float().cpu().numpy())
    return tree


def _count_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count_leaves(v) for v in tree.values())
    return 1


def load_tree(module: nn.Module, tree: Dict[str, Any], *,
              dtype: torch.dtype, device) -> nn.Module:
    """Copy every parameter of `module` from `tree` (numpy or torch leaves)
    in `dtype` on `device`; float buffers move to `device` in f32. Raises
    on a missing leaf, a shape mismatch or a leaf no parameter consumed."""
    used = set()
    for name, p in module.named_parameters():
        leaf = _leaf(tree, name)
        src = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(
            np.array(leaf, dtype=np.float32))
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{name}: tree has {tuple(src.shape)}, module wants {tuple(p.shape)}")
        p.data = src.to(device=device, dtype=dtype).contiguous()
        used.add(_leaf_name(name))
    if len(used) != _count_leaves(tree):
        raise ValueError(f"tree has {_count_leaves(tree)} leaves, module consumed {len(used)}")
    for name, b in module.named_buffers():
        module.get_buffer(name).data = b.to(device=device, dtype=torch.float32)
    return module


def params_from_jax(
    tree: Dict[str, Any], *, cfg: Optional[ModelConfig] = None,
    device="cpu", dtype: torch.dtype = torch.float32,
) -> nn.Module:
    """JAX parameter tree (numpy leaves) → `VALLE` of `cfg` (default: the
    shipped config) in the compute `dtype`, or `Vocos` (always f32, as the
    JAX package runs it)."""
    if "codebook_weights" in tree:
        from .codec.vocos import Vocos

        return load_tree(Vocos(), tree, dtype=torch.float32, device=device)
    from .models.vallex import VALLE

    return load_tree(VALLE(cfg or ModelConfig()), tree, dtype=dtype,
                     device=device)
