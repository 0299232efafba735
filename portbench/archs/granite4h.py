"""Granite-4.0-H as VALL-E X's AR (configs/granite-4.0-h-micro-bf16.json):
the published hybrid stack (36 Mamba-2 and 4 grouped-query attention
layers, each followed by a SwiGLU MLP) behind VALL-E X's token tables and
codebook-0 head, with VALL-E X's NAR and Vocos. The configuration's `model`
holds the NAR's VALL-E X sizes and, under `ar_stack`, the
`granitemoehybrid` keys of the AR (README.md, "Adding a model architecture").

- `draw_tree(model, weights, gen, device, dtype)`: VALL-E X's tree from the
  generator (harness/weights.py; its AR dropped), then the hybrid AR's
  (`hybrid_ar_tree`);
- `program_config(model)`: the program's ModelConfig with its HybridARConfig;
- `reference(tree, model)`: reference/granite4h.py's AR, reference/vallex.py's
  NAR;
- `ssm_step_bound_s`: the least time of a batch's Mamba-2 step updates,
  read by `ssm_step_roofline`;
- `request_flops`, `gemm_small_m_bound_s`, `masked_attention_bound_s`:
  roofline/counts.py's for this AR (grouped K/V heads, no positions), so
  that `mfu` and the two rooflines read the cell once their `workloads`
  name it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from portbench.harness.weights import _Draw, vallex_tree
from portbench.reference import granite4h as RG
from portbench.reference import vallex as RV
from portbench.reference.quant import FLOAT32
from portbench.roofline.counts import (PEAKS, Request, _bound_s, decode_keys, live_rows,
                                       nar_flops, vocos_flops)


def program_config(model: Dict):
    from vallex_tpu_torch.config import HybridARConfig, ModelConfig

    nar = {k: v for k, v in model.items() if k != "ar_stack"}
    return ModelConfig(**nar, ar_stack=HybridARConfig.from_hf(model["ar_stack"]))


def hybrid_ar_tree(h: Dict, weights: Dict, gen: torch.Generator, device, dtype,
                   vocab: Dict) -> Dict:
    """The AR's tables, stack and head ([out, in] matrices, the program's
    layout): tables N(0, `weights["embedding_std"]`²), Linear weights
    U(±1/√in), the convolution and its bias U(±1/√4), gains one, D one;
    dt = exp(U(log 0.001, log 0.1)) through softplus⁻¹ as dt_bias, A ~ U[1,
    16] as A_log (mamba_ssm's inits); the head Xavier-uniform. EOS held off:
    channel 0 of every text and audio row is `eos_channel` (language rows 0
    there), so the final RMSNorm's channel 0 stays well above zero, and the
    head's EOS column is −`eos_weight` there and 0 elsewhere."""
    D, F_, NL = h["hidden_size"], h["shared_intermediate_size"], h["num_hidden_layers"]
    types = h["layer_types"]
    nm, na = types.count("mamba"), types.count("attention")
    H, P, N = h["mamba_n_heads"], h["mamba_d_head"], h["mamba_d_state"]
    inner, K = H * P, h["mamba_d_conv"]
    Cd = inner + 2 * h["mamba_n_groups"] * N
    Hq, Hkv = h["num_attention_heads"], h["num_key_value_heads"]
    hd = D // Hq
    A_out = vocab["audio"] + 1
    std = weights["embedding_std"]
    d = _Draw()
    d.add("ar_text_embedding/weight", (vocab["text"], D), "normal", std)
    d.add("ar_language_embedding/weight", (vocab["languages"], D), "normal", std)
    d.add("ar_audio_embedding/weight", (vocab["audio"] + 2, D), "normal", std)
    s = "ar_decoder/layers"
    d.add(f"{s}/norm1", (NL, D), "const", 1.0)
    d.add(f"{s}/norm2", (NL, D), "const", 1.0)
    d.add(f"{s}/mlp_in", (NL, 2 * F_, D), "uniform", 1 / math.sqrt(D))
    d.add(f"{s}/mlp_out", (NL, D, F_), "uniform", 1 / math.sqrt(F_))
    s = "ar_decoder/mamba"
    d.add(f"{s}/in_proj", (nm, inner + Cd + H, D), "uniform", 1 / math.sqrt(D))
    d.add(f"{s}/conv_w", (nm, Cd, K), "uniform", 1 / math.sqrt(K))
    d.add(f"{s}/conv_b", (nm, Cd), "uniform", 1 / math.sqrt(K))
    d.add(f"{s}/D", (nm, H), "const", 1.0)
    d.add(f"{s}/norm", (nm, inner), "const", 1.0)
    d.add(f"{s}/out_proj", (nm, D, inner), "uniform", 1 / math.sqrt(inner))
    s = "ar_decoder/attn"
    d.add(f"{s}/wq", (na, Hq * hd, D), "uniform", 1 / math.sqrt(D))
    d.add(f"{s}/wk", (na, Hkv * hd, D), "uniform", 1 / math.sqrt(D))
    d.add(f"{s}/wv", (na, Hkv * hd, D), "uniform", 1 / math.sqrt(D))
    d.add(f"{s}/wo", (na, D, Hq * hd), "uniform", 1 / math.sqrt(Hq * hd))
    d.add("ar_decoder/norm", (D,), "const", 1.0)
    d.add("ar_predict_layer/w", (D, A_out), "uniform", math.sqrt(6.0 / (D + A_out)))
    tree = d.build(gen, device, dtype)
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand((2, nm, H), generator=gen, device=device)
    dt = torch.exp(lo + u[0] * (hi - lo)).clamp_min(1e-4)
    m = tree["ar_decoder"]["mamba"]
    m["dt_bias"] = (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    m["A_log"] = torch.log(1.0 + 15.0 * u[1]).to(dtype)
    for name in ("ar_text_embedding", "ar_audio_embedding"):
        tree[name]["weight"][:, 0] = weights["eos_channel"]
    tree["ar_language_embedding"]["weight"][:, 0] = 0
    head = tree["ar_predict_layer"]["w"]
    head[:, vocab["audio"]] = 0
    head[0, vocab["audio"]] = -weights["eos_weight"]
    return tree


def draw_tree(model: Dict, weights: Dict, gen: torch.Generator, device, dtype) -> Dict:
    program_config(model)  # a program without the hybrid AR stops here, before any draw
    nar = {k: v for k, v in model.items() if k != "ar_stack"}
    tree = vallex_tree(nar, {"eos_bias": 0.0, "eos_weight": 0.0}, gen, device, dtype)
    for name in [k for k in tree if k.startswith("ar_")]:
        del tree[name]
    vocab = {"text": model["num_text_tokens"], "languages": model["num_languages"],
             "audio": model["num_audio_tokens"]}
    tree.update(hybrid_ar_tree(model["ar_stack"], weights, gen, device, dtype, vocab))
    return tree


class Reference:
    """reference/granite4h.py's AR and reference/vallex.py's NAR."""

    def __init__(self, tree: Dict, model: Dict):
        self.ar = RG.Model(tree, model["ar_stack"])
        nar = {k: v for k, v in tree.items() if k.startswith("nar_")}
        nar["ar_text_embedding"] = tree["nar_text_embedding"]  # RV.Model reads D there
        self.nar = RV.Model(nar, model["num_heads"])
        self.device, self.eos = self.ar.device, self.ar.eos

    def ar_logits(self, text, lang, prompt_cb0, tokens, prec=FLOAT32):
        return RG.ar_logits(self.ar, text, lang, prompt_cb0, tokens, prec)

    def nar_logits(self, text, lang, codes, Tp, prec=FLOAT32):
        return RV.nar_logits(self.nar, text, lang, codes, Tp, prec)


def reference(tree: Dict, model: Dict) -> Reference:
    return Reference(tree, model)


def ssm_step_bytes(model: Dict) -> int:
    """Bytes one Mamba-2 step update needs for one row and layer: the f32
    state read and written, x, B, C, dt and z read and y written (f32)."""
    h = model["ar_stack"]
    H, P, N = h["mamba_n_heads"], h["mamba_d_head"], h["mamba_d_state"]
    return 4 * (2 * H * P * N + H * P + 2 * N + H + H * P + H * P)


def ssm_step_bound_s(model: Dict, rows: int, steps: int) -> float:
    """Least time of a batch's Mamba-2 step updates: every row the block
    runs, every Mamba layer, every step, at the peak bandwidth."""
    layers = model["ar_stack"]["layer_types"].count("mamba")
    return rows * layers * steps * ssm_step_bytes(model) / PEAKS["hbm_bytes_per_s"]


# The counts that roofline/counts.py gives VALL-E X, for the hybrid AR, by
# the same rules: what a result needs (live decode rows only, valid
# positions and query-key pairs), each weight read once a launch, every
# product 2·K·N operations a row. The Mamba-2 step counts 5·H·P·N a row and
# layer (the state's decay and update, 3, and its read-out, 2) and its
# convolution 2·4 a channel; gating and norms are left out (under 1%).

def _products(h: Dict, A: int) -> List[Tuple[int, int]]:
    """(K, N) of a decode step's products: the Mamba layers' in- and
    out-projections, the attention layers' fused QKV and output, every
    layer's SwiGLU in and out, and the head."""
    D, F_ = h["hidden_size"], h["shared_intermediate_size"]
    types = h["layer_types"]
    H, P, N = h["mamba_n_heads"], h["mamba_d_head"], h["mamba_d_state"]
    inner, hd = H * P, D // h["num_attention_heads"]
    qkv = (h["num_attention_heads"] + 2 * h["num_key_value_heads"]) * hd
    mamba = [(D, inner + inner + 2 * N + H), (inner, D)]
    attn = [(D, qkv), (h["num_attention_heads"] * hd, D)]
    mlp = [(D, 2 * F_), (F_, D)]
    return [s for t in types for s in (mamba if t == "mamba" else attn) + mlp] + [(D, A + 1)]


def _mixer_flops_per_token(h: Dict) -> int:
    """The Mamba layers' step work a token (the state and the convolution)."""
    H, P, N = h["mamba_n_heads"], h["mamba_d_head"], h["mamba_d_state"]
    conv = H * P + 2 * N
    return h["layer_types"].count("mamba") * (5 * H * P * N + 2 * h["mamba_d_conv"] * conv)


def _attention_flops(h: Dict, pairs: int) -> int:
    """Q·Kᵀ and P·V over `pairs` query-key pairs in every attention layer."""
    width = h["num_attention_heads"] * (h["hidden_size"] // h["num_attention_heads"])
    return 4 * width * pairs * h["layer_types"].count("attention")


def ar_prefill_flops(m: Dict, x_len: int, prompt_len: int) -> int:
    """The prefill over a row's own text, BOS and prompt (causal over
    them), and the head at its last position."""
    h, A = m["ar_stack"], m["num_audio_tokens"]
    n = x_len + prompt_len + 1
    per = 2 * sum(k * n_ for k, n_ in _products(h, A)[:-1]) + _mixer_flops_per_token(h)
    return per * n + _attention_flops(h, n * (n + 1) // 2) + 2 * h["hidden_size"] * (A + 1)


def ar_decode_flops(m: Dict, x_len: int, prompt_len: int, gen_len: int) -> int:
    h, A = m["ar_stack"], m["num_audio_tokens"]
    per = 2 * sum(k * n for k, n in _products(h, A)) + _mixer_flops_per_token(h)
    keys = sum(decode_keys(x_len, prompt_len, t) for t in range(gen_len))
    return per * gen_len + _attention_flops(h, keys)


def request_flops(m: Dict, v: Dict, r: Request) -> int:
    """A request's operations: the hybrid AR's prefill and decode, VALL-E
    X's NAR (the sizes at the top level of `m`) and Vocos."""
    x, p, g = r
    return (ar_prefill_flops(m, x, p) + ar_decode_flops(m, x, p, g) + nar_flops(m, x, p, g)
            + vocos_flops(v, g))


def gemm_small_m_bound_s(m: Dict, weight_bytes: float, gen_lens: List[int],
                         steps: int) -> float:
    """Least time of a batch's decode products (gemm_small_m, a launch a
    product a step): the weights once a launch (with an f32 scale a column
    when int8), the live rows' f32 inputs and outputs."""
    shapes = _products(m["ar_stack"], m["num_audio_tokens"])
    total = 0.0
    for rows in live_rows(gen_lens, steps):
        for k, n in shapes:
            nbytes = k * n * weight_bytes + (4 * n if weight_bytes == 1 else 0) \
                + 4 * rows * (k + n)
            total += _bound_s(2 * rows * k * n, nbytes)
    return total


def masked_attention_bound_s(m: Dict, kv_bytes: float, requests: List[Request],
                             steps: int) -> float:
    """Least time of a batch's decode attention (a launch an attention
    layer a step): each live row's valid K and V once for its grouped
    query heads (num_key_value_heads of them), its f32 queries and output."""
    h = m["ar_stack"]
    hd = h["hidden_size"] // h["num_attention_heads"]
    kv_width, q_width = h["num_key_value_heads"] * hd, h["num_attention_heads"] * hd
    na = h["layer_types"].count("attention")
    total = 0.0
    for t in range(steps):
        keys = [decode_keys(x, p, t) for x, p, g in requests if g > t]
        if not keys:
            continue
        nbytes = sum(2 * k * kv_width * kv_bytes + 8 * q_width for k in keys)
        total += na * _bound_s(4 * q_width * sum(keys), nbytes)
    return total
