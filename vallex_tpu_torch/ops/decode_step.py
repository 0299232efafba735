"""One AR decode step, and the decoder weight preparation of every decode
kernel (port of vallex_tpu/ops/decode_step.py: decode_step,
decode_step_fused, pack_layer_weights, _pad_vocab, quantize_weights).

The port's own layout: every streamed matrix is stacked per layer as
[NL, N, K] (output rows, input contiguous), which is what `gemm_small_m`
streams with coalesced loads; vectors (biases, LayerNorm parameters,
scales) are f32. The TPU package's [in, out] blocks and (1, 1, dim)
vector planes existed for Mosaic's tiling and are not copied. int8 and
w8a8 serving share the int8 weights of `quantize_weights`: w8a8
(`act_quant`) is a mode of the products at run time, as in the JAX
package.

The TPU kernel runs a whole step in one launch (a two-phase weight stream
over the grid of layers); here a step is the launches of the hand-written
kernels in order, as for the K-step blocks (ops/decode_block.py).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..kernels import sample_epilogue
from ..kernels.masked_attention import attention_bounds
from .decode_verify import decoder_layers, embed

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


SITE_STEP = "decode_step"
SITE_STEP_FUSED = "decode_step_fused"


def decode_step(
    x: torch.Tensor,  # [B, D] f32 step input: emb[token] + alpha · PE[audio_pos]
    lw: Dict,
    cache_k: torch.Tensor,  # [NL, B, H, C, hd], updated in place
    cache_v: torch.Tensor,
    *,
    x_len,
    audio_pos: int,
    s_text: int,
    act_quant: bool = False,
    site: str = SITE_STEP,
) -> torch.Tensor:
    """One AR step for the B rows of one request (its best_of samples, one
    cache row each) → logits [B, VP] f32 (port of
    vallex_tpu/ops/decode_step.py::decode_step). All layers, the final
    norm and the head, as launches of `gemm_small_m` (W8A8 with
    act_quant, W8A16 with int8 weights) and of `masked_attention` in its
    own-column mode: the walk covers the text rows < x_len and the audio
    rows before the slot s_text + audio_pos, this step's k/v are folded in
    unrounded, and the kernel writes them into the slot."""
    bounds = attention_bounds(x.shape[0], x_len=x_len, s_text=s_text, audio_len=audio_pos,
                              q_off=0, device=x.device)
    return decoder_layers(x, lw, cache_k, cache_v, slot=s_text + audio_pos, bounds=bounds,
                          site=site, act_quant=act_quant, own_column=True)


def decode_step_fused(
    tokens: torch.Tensor,  # [B] this step's input tokens
    lw: Dict,
    cache_k: torch.Tensor,  # [NL, B, H, C, hd], updated in place
    cache_v: torch.Tensor,
    pe_table: torch.Tensor,  # [max_position, D] f32
    *,
    x_len,
    audio_pos: int,
    s_text: int,
    vocab: int,
    temperature: float,
    greedy: bool,
    generator: Optional[torch.Generator] = None,
    act_quant: bool = False,
):
    """Token in, token out (port of vallex_tpu/ops/decode_step.py::
    decode_step_fused): the embedding and PE row, `decode_step`, then the
    plain sampling epilogue (`sample_epilogue`: argmax when greedy, else
    Gumbel-argmax of logits/T with uniforms [B, VP] drawn from
    `generator`) → (next tokens [B] int32, their logprobs [B] f32)."""
    logits = decode_step(embed(tokens, lw, pe_table[audio_pos]), lw, cache_k, cache_v, x_len=x_len, audio_pos=audio_pos,
                         s_text=s_text, act_quant=act_quant, site=SITE_STEP_FUSED)
    u = None if greedy else torch.rand(logits.shape, generator=generator, device=logits.device)
    return sample_epilogue(logits, u, vocab=vocab, temperature=temperature, greedy=greedy,
                           site=SITE_STEP_FUSED)
