"""Checkpoint files (port of the reading half of vallex_tpu/utils/checkpoint.py):
the reference's torch `vallex-checkpoint.pt` → parameter tree, and the
native flat npz (`vallex-jax.npz`, `vocos-jax.npz`, `encodec-jax.npz`).

The shipped checkpoint is {"model": state_dict} (or a bare state dict)
with keys prefixed ar_*/nar_* (reference: utils/generation.py:79-83).
Linear kernels are transposed to [in, out]; the NAR audio embeddings are
stacked to [8, 1025, D] (codebooks 1..7 padded with a zero EOS row); the
NAR predict heads are stacked to [7, D, 1024] (heads 0..5 arrive
weight-tied to embeddings 2..7 in the state dict; reference:
models/vallex.py:254-264). The tree is the JAX package's, numpy f32 leaves.

The native npz holds one array per leaf under its `/`-joined path, so a
file written by either package loads in the other. Torch leaves are
written as numpy (floating ones as f32: numpy has no bf16). List nodes
(the EnCodec tree's stages and LSTM layers) are written as one key per
index, `encoder/stages/0/down/w`, and read back as lists; the JAX
package's `save_native` writes such a node as a pickled object array,
which `np.load` refuses.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import numpy as np

from ..config import ModelConfig

Params = Dict[str, Any]


def _t(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a.T)


def convert_torch_state_dict(sd: Mapping[str, Any], cfg: ModelConfig) -> Params:
    """A numpy-ified torch state dict → the model's parameter tree."""
    g = lambda k: np.asarray(sd[k], dtype=np.float32)  # noqa: E731
    L = cfg.num_layers

    def per_layer(prefix: str, name: str, transpose: bool = False) -> np.ndarray:
        return np.stack([_t(g(f"{prefix}.layers.{i}.{name}")) if transpose
                         else g(f"{prefix}.layers.{i}.{name}") for i in range(L)])

    def stack(prefix: str, adaptive: bool) -> Params:
        layers: Params = {
            "self_attn": {
                "in_proj_w": per_layer(prefix, "self_attn.in_proj_weight", True),
                "in_proj_b": per_layer(prefix, "self_attn.in_proj_bias"),
                "out_w": per_layer(prefix, "self_attn.out_proj.weight", True),
                "out_b": per_layer(prefix, "self_attn.out_proj.bias"),
            },
            "linear1": {"w": per_layer(prefix, "linear1.weight", True),
                        "b": per_layer(prefix, "linear1.bias")},
            "linear2": {"w": per_layer(prefix, "linear2.weight", True),
                        "b": per_layer(prefix, "linear2.bias")},
        }
        for norm in ("norm1", "norm2"):
            if adaptive:
                layers[norm] = {
                    "w": per_layer(prefix, f"{norm}.project_layer.weight", True),
                    "b": per_layer(prefix, f"{norm}.project_layer.bias"),
                    "scale": per_layer(prefix, f"{norm}.norm.weight"),
                    "bias": per_layer(prefix, f"{norm}.norm.bias"),
                }
            else:
                layers[norm] = {"scale": per_layer(prefix, f"{norm}.weight"),
                                "bias": per_layer(prefix, f"{norm}.bias")}
        if adaptive:
            final = {"w": _t(g(f"{prefix}.norm.project_layer.weight")),
                     "b": g(f"{prefix}.norm.project_layer.bias"),
                     "scale": g(f"{prefix}.norm.norm.weight"),
                     "bias": g(f"{prefix}.norm.norm.bias")}
        else:
            final = {"scale": g(f"{prefix}.norm.weight"), "bias": g(f"{prefix}.norm.bias")}
        return {"layers": layers, "norm": final}

    def embedding(prefix: str) -> Params:
        return {"weight": g(f"{prefix}.word_embeddings.weight")}

    def alpha(prefix: str) -> Params:
        return {"alpha": g(f"{prefix}.alpha").reshape(())}

    q, A = cfg.num_quantizers, cfg.num_audio_tokens
    nar_audio = np.zeros((q, A + 1, cfg.d_model), np.float32)
    nar_audio[0] = g("nar_audio_embeddings.0.word_embeddings.weight")
    for j in range(1, q):
        nar_audio[j, :A] = g(f"nar_audio_embeddings.{j}.word_embeddings.weight")
    nar_predict = np.stack([_t(g(f"nar_predict_layers.{j}.weight")) for j in range(q - 1)])
    nar_stage = np.concatenate(
        [g(f"nar_stage_embeddings.{j}.word_embeddings.weight") for j in range(q - 1)], axis=0)

    return {
        "ar_text_embedding": embedding("ar_text_embedding"),
        "nar_text_embedding": embedding("nar_text_embedding"),
        "ar_audio_embedding": embedding("ar_audio_embedding"),
        "ar_text_position": alpha("ar_text_position"),
        "ar_audio_position": alpha("ar_audio_position"),
        "nar_text_position": alpha("nar_text_position"),
        "nar_audio_position": alpha("nar_audio_position"),
        "ar_decoder": stack("ar_decoder", adaptive=False),
        "nar_decoder": stack("nar_decoder", adaptive=True),
        "ar_predict_layer": {"w": _t(g("ar_predict_layer.weight"))},
        "nar_audio_embeddings": {"weight": nar_audio},
        "nar_predict_layers": {"w": nar_predict},
        "nar_stage_embeddings": {"weight": nar_stage},
        "ar_language_embedding": embedding("ar_language_embedding"),
        "nar_language_embedding": embedding("nar_language_embedding"),
    }


def _to_numpy(v) -> np.ndarray:
    """A numpy array, or a torch tensor (floating ones as f32, any dtype:
    numpy has no bf16) → numpy."""
    import torch

    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.is_floating_point() else v).numpy()
    return np.asarray(v)


def state_dict_to_numpy(sd: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """A torch state dict → numpy (floating leaves as f32)."""
    return {k: _to_numpy(v) for k, v in sd.items()}


def load_torch_checkpoint(path: str, cfg: ModelConfig) -> Params:
    """The reference's `vallex-checkpoint.pt` ({"model": state_dict} or a
    bare state dict; bf16 leaves too) → the parameter tree."""
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt["model"] if "model" in ckpt else ckpt
    return convert_torch_state_dict(state_dict_to_numpy(sd), cfg)


# ---------------------------------------------------------------------------
# Native flat-npz checkpoints
# ---------------------------------------------------------------------------

def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    items = (tree.items() if isinstance(tree, dict)
             else ((str(i), v) for i, v in enumerate(tree)))
    out: Dict[str, np.ndarray] = {}
    for k, v in items:
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, (dict, list, tuple)):
            out.update(_flatten(v, key))
        else:
            out[key] = _to_numpy(v)
    return out


def _lists(node):
    """Dicts keyed 0..n-1 (the list nodes `_flatten` wrote) → lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and sorted(node) == sorted(str(i) for i in range(len(node))):
        return [node[str(i)] for i in range(len(node))]
    return node


def _unflatten(flat: Mapping[str, np.ndarray]) -> Params:
    tree: Params = {}
    for k, v in flat.items():
        *parts, last = k.split("/")
        node = tree
        for p in parts:
            node = node.setdefault(p, {})
        node[last] = v
    return _lists(tree)


def save_native(path: str, params: Params) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **_flatten(params))


def load_native(path: str) -> Params:
    with np.load(path) as f:
        return _unflatten({k: f[k] for k in f.files})
