"""AR decoder weight preparation for the decode kernels (port of the weight
half of vallex_tpu/ops/decode_step.py: pack_layer_weights, _pad_vocab,
quantize_weights).

The port's own layout: every streamed matrix is stacked per layer as
[NL, N, K] (output rows, input contiguous), which is what `gemm_small_m`
streams with coalesced loads; vectors (biases, LayerNorm parameters,
scales) are f32. The TPU package's [in, out] blocks and (1, 1, dim)
vector planes existed for Mosaic's tiling and are not copied.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

VOCAB_PAD = 128  # head rows padded to a multiple (1025 → 1152)

QUANTIZED = (("wqkv", "sqkv"), ("wout", "sout"), ("w1", "s1"), ("w2", "s2"),
             ("wpred", "spred"))


def _pad_vocab(w: torch.Tensor) -> torch.Tensor:
    """[V, D] head rows → [VP, D], zero rows appended (the engine masks
    logits at lanes >= vocab)."""
    V, D = w.shape
    VP = -(-V // VOCAB_PAD) * VOCAB_PAD
    if VP == V:
        return w
    return torch.cat([w, w.new_zeros((VP - V, D))], dim=0)


def pack_layer_weights(model, dtype: torch.dtype) -> Dict[str, Optional[torch.Tensor]]:
    """AR decoder of `model` (models.vallex.VALLE) → the decode kernels'
    weight dict: matrices [NL, N, K] in `dtype`, vectors f32, scales None
    (bf16 weights; quantize_weights fills them)."""
    layers = model.ar_decoder.layers

    def mat(get):  # [in, out] per layer → [NL, out, in]
        return torch.stack([get(l).t() for l in layers]).to(dtype).contiguous()

    def vec(get):
        return torch.stack([get(l) for l in layers]).float().contiguous()

    fn = model.ar_decoder.norm
    return {
        "wqkv": mat(lambda l: l.self_attn.in_proj_w),
        "bqkv": vec(lambda l: l.self_attn.in_proj_b),
        "wout": mat(lambda l: l.self_attn.out_w),
        "bout": vec(lambda l: l.self_attn.out_b),
        "w1": mat(lambda l: l.linear1.w),
        "b1": vec(lambda l: l.linear1.b),
        "w2": mat(lambda l: l.linear2.w),
        "b2": vec(lambda l: l.linear2.b),
        "ln1s": vec(lambda l: l.norm1.scale),
        "ln1b": vec(lambda l: l.norm1.bias),
        "ln2s": vec(lambda l: l.norm2.scale),
        "ln2b": vec(lambda l: l.norm2.bias),
        "fns": fn.scale.float().contiguous(),
        "fnb": fn.bias.float().contiguous(),
        "wpred": _pad_vocab(model.ar_predict_layer.w.t()).to(dtype).contiguous(),
        "sqkv": None, "sout": None, "s1": None, "s2": None, "spred": None,
        "emb": model.ar_audio_embedding.weight.to(dtype).contiguous(),
        "alpha": model.ar_audio_position.alpha.float(),
    }


def quantize_weights(lw: Dict[str, Optional[torch.Tensor]]) -> Dict[str, Optional[torch.Tensor]]:
    """Per-output-channel symmetric int8 (W8A16): for each output row n,
    scale[n] = max|w[n, :]| / 127 and q = clip(round(w / scale), ±127).
    The kernels multiply bf16 activations by the int8 values in f32 and
    apply the scale to the sum."""
    out = dict(lw)
    for name, sname in QUANTIZED:
        w = lw[name].float()  # [.., N, K]
        amax = w.abs().amax(dim=-1, keepdim=True)
        scale = torch.clamp(amax, min=1e-8) / 127.0
        out[name] = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8).contiguous()
        out[sname] = scale[..., 0].contiguous()
    return out
