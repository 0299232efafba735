"""VALL-E X model (port of vallex_tpu/models/vallex.py).

- AR stack: text embedding (2048×D), audio embedding (1026×D incl. EOS=1024
  and BOS=1025), sinusoidal PEs with learnable alpha, pre-norm encoder
  layers + final LayerNorm, untied head Linear(D→1025, no bias).
- NAR stack: text embedding, 8 audio embeddings (cb0 has 1025 rows for EOS),
  AdaLN layers conditioned on one of 7 stage embeddings, 7 predict heads.
- Language embeddings (3×D) added per text position.
- With `ModelConfig.ar_stack` the AR is models/granite_hybrid.py's stack at
  its own width (token tables, decoder and head; no positions), and the NAR
  keeps the widths above.

Parameter names and shapes follow the JAX pytree, so `convert.py` is a
key-for-key copy and `init_vallex` here draws the same tree from a
torch.Generator.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
from torch import nn

from ..config import ModelConfig
from . import granite_hybrid as GH
from . import layers as L

NEG_INF = -1e9  # additive-mask value (f32-safe; softmax in f32)


class Embedding(nn.Module):
    """A lookup table; under tensor parallelism (parallel/mesh.py) it holds
    the rows [vocab_start, vocab_start + rows) of the vocabulary: ids
    outside look up zeros, and `tp.reduce` sums the ranks' rows."""

    tp = None
    vocab_start = 0

    def __init__(self, vocab: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(vocab, dim), requires_grad=False)

    def forward(self, ids: torch.Tensor, dtype=None) -> torch.Tensor:
        # gather, then cast: the values of the JAX package's cast-then-take,
        # and a backward that sums each row's gradient in the table's f32
        # (a bf16 table's scatter-add would round at every position)
        w = self.weight
        if self.tp is None:
            rows = w[ids]
        else:
            local = ids - self.vocab_start
            mine = (local >= 0) & (local < w.shape[0])
            rows = w[local.clamp(0, w.shape[0] - 1)]
            rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
        rows = rows if dtype is None else rows.to(dtype)
        return rows if self.tp is None else self.tp.reduce(rows)


class _Tensor(nn.Module):
    """One parameter under its JAX leaf name (`weight` or `w`)."""

    def __init__(self, name: str, *shape: int):
        super().__init__()
        self.register_parameter(
            name, nn.Parameter(torch.zeros(*shape), requires_grad=False))


class VALLE(nn.Module):
    # tensor parallelism (parallel/mesh.py::shard_params): the tp group, the
    # first NAR codebook this rank holds and the first input row of its NAR
    # head slice; `par` is the rank's groups (dp and tp), None alone
    tp = None
    par = None
    nar_codebook_start = 0
    nar_head_rows = 0

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        D, q, Da = cfg.d_model, cfg.num_quantizers, cfg.ar_width
        self.cfg = cfg
        self.ar_text_embedding = Embedding(cfg.num_text_tokens, Da)
        self.nar_text_embedding = Embedding(cfg.num_text_tokens, D)
        self.ar_audio_embedding = Embedding(cfg.ar_audio_vocab, Da)
        if cfg.ar_stack is None:
            self.ar_text_position = L.SinePositionalEmbedding()
            self.ar_audio_position = L.SinePositionalEmbedding()
        self.nar_text_position = L.SinePositionalEmbedding()
        self.nar_audio_position = L.SinePositionalEmbedding()
        self.ar_decoder = (
            L.EncoderStack(cfg.num_layers, D, cfg.num_heads, cfg.ffn_dim, adaptive=False)
            if cfg.ar_stack is None else GH.HybridStack(cfg.ar_stack))
        self.nar_decoder = L.EncoderStack(
            cfg.num_layers, D, cfg.num_heads, cfg.ffn_dim, adaptive=True)
        self.ar_predict_layer = L.Linear(Da, cfg.num_audio_tokens + 1, bias=False)
        self.nar_audio_embeddings = _Tensor(
            "weight", q, cfg.num_audio_tokens + 1, D)
        self.nar_predict_layers = _Tensor("w", q - 1, D, cfg.num_audio_tokens)
        self.nar_stage_embeddings = Embedding(q - 1, D)
        self.ar_language_embedding = Embedding(cfg.num_languages, Da)
        self.nar_language_embedding = Embedding(cfg.num_languages, D)
        self.register_buffer(
            "pe", L.make_sine_pe(cfg.max_position, D), persistent=False)


# ---------------------------------------------------------------------------
# Random init (torch defaults, drawn from a torch.Generator)
# ---------------------------------------------------------------------------

def _uniform(g, shape, bound):
    return (torch.rand(shape, generator=g) * 2 - 1) * bound


def _xavier(g, shape):
    return _uniform(g, shape, math.sqrt(6.0 / (shape[-2] + shape[-1])))


def _kaiming(g, shape):  # torch nn.Linear default on an [in, out] kernel
    return _uniform(g, shape, 1.0 / math.sqrt(shape[-2]))


def _norm_tree(g, NL: Optional[int], D: int, adaptive: bool) -> Dict:
    """LayerNorm leaves (ones, zeros), with AdaLN's projection when
    `adaptive`; stacked [NL, ...] unless NL is None."""
    lead = () if NL is None else (NL,)
    n = {"scale": torch.ones(*lead, D), "bias": torch.zeros(*lead, D)}
    if adaptive:
        n["w"] = _kaiming(g, (*lead, D, 2 * D))
        n["b"] = _uniform(g, (*lead, 2 * D), 1.0 / math.sqrt(D))
    return n


def _attn_tree(g, NL: int, D: int) -> Dict:
    return {"in_proj_w": _xavier(g, (NL, D, 3 * D)), "in_proj_b": torch.zeros(NL, 3 * D),
            "out_w": _kaiming(g, (NL, D, D)), "out_b": torch.zeros(NL, D)}


def _ffn_tree(g, NL: int, D: int, F: int) -> Dict:
    return {"linear1": {"w": _kaiming(g, (NL, D, F)),
                        "b": _uniform(g, (NL, F), 1.0 / math.sqrt(D))},
            "linear2": {"w": _kaiming(g, (NL, F, D)),
                        "b": _uniform(g, (NL, D), 1.0 / math.sqrt(F))}}


def stack_tree(g, NL: int, D: int, F: int, adaptive: bool, decoder: bool = False) -> Dict:
    """A random encoder stack (`EncoderStack`), or with `decoder` a decoder
    stack (`DecoderStack`: cross_attn, norm0-norm2), torch's default inits."""
    final = _norm_tree(g, None, D, adaptive)
    layers = {"self_attn": _attn_tree(g, NL, D)}
    if decoder:
        layers["cross_attn"] = _attn_tree(g, NL, D)
    layers.update(_ffn_tree(g, NL, D, F))
    for i in ((0, 1, 2) if decoder else (1, 2)):
        layers[f"norm{i}"] = _norm_tree(g, NL, D, adaptive)
    return {"layers": layers, "norm": final}


def nar_tables(g, cfg: ModelConfig):
    """The NAR's 8 audio embeddings and 7 predict heads (heads 0-5 tied to
    embeddings 2-7, the last its own)."""
    D, q, A = cfg.d_model, cfg.num_quantizers, cfg.num_audio_tokens
    nar_audio = torch.zeros(q, A + 1, D)
    nar_audio[0] = torch.randn(A + 1, D, generator=g)
    nar_audio[1:, :A] = torch.randn(q - 1, A, D, generator=g)
    nar_predict = torch.cat(
        [nar_audio[2:, :A].transpose(1, 2), _xavier(g, (1, D, A))], dim=0)
    return nar_audio, nar_predict


def init_vallex(cfg: ModelConfig, generator: torch.Generator) -> Dict:
    """Random parameter tree with the JAX package's names and shapes (with
    `cfg.ar_stack`, `init_hybrid`'s)."""
    if cfg.ar_stack is not None:
        return init_hybrid(cfg, generator)
    g = generator
    D, F, NL, q = cfg.d_model, cfg.ffn_dim, cfg.num_layers, cfg.num_quantizers
    A = cfg.num_audio_tokens

    def stack(adaptive: bool) -> Dict:
        return stack_tree(g, NL, D, F, adaptive)

    nar_audio, nar_predict = nar_tables(g, cfg)
    one = lambda: {"alpha": torch.ones(())}  # noqa: E731
    return {
        "ar_text_embedding": {"weight": torch.randn(cfg.num_text_tokens, D, generator=g)},
        "nar_text_embedding": {"weight": torch.randn(cfg.num_text_tokens, D, generator=g)},
        "ar_audio_embedding": {"weight": torch.randn(cfg.ar_audio_vocab, D, generator=g)},
        "ar_text_position": one(),
        "ar_audio_position": one(),
        "nar_text_position": one(),
        "nar_audio_position": one(),
        "ar_decoder": stack(False),
        "nar_decoder": stack(True),
        "ar_predict_layer": {"w": _xavier(g, (D, A + 1))},
        "nar_audio_embeddings": {"weight": nar_audio},
        "nar_predict_layers": {"w": nar_predict},
        "nar_stage_embeddings": {"weight": torch.randn(q - 1, D, generator=g)},
        "ar_language_embedding": {"weight": torch.randn(cfg.num_languages, D, generator=g)},
        "nar_language_embedding": {"weight": torch.randn(cfg.num_languages, D, generator=g)},
    }


def init_hybrid(cfg: ModelConfig, generator: torch.Generator) -> Dict:
    """`init_vallex`'s tree with the AR replaced by the hybrid stack of
    `cfg.ar_stack` (models/granite_hybrid.py::init_tree) at its width: AR
    token tables N(0, 1), the head Xavier-uniform, no AR positions."""
    g, Da, A = generator, cfg.ar_width, cfg.num_audio_tokens
    tree = init_vallex(dataclasses.replace(cfg, ar_stack=None), g)
    for name in ("ar_text_position", "ar_audio_position"):
        del tree[name]
    tree["ar_text_embedding"] = {"weight": torch.randn(cfg.num_text_tokens, Da, generator=g)}
    tree["ar_audio_embedding"] = {"weight": torch.randn(cfg.ar_audio_vocab, Da, generator=g)}
    tree["ar_language_embedding"] = {"weight": torch.randn(cfg.num_languages, Da, generator=g)}
    tree["ar_decoder"] = GH.init_tree(cfg.ar_stack, g)
    tree["ar_predict_layer"] = {"w": _xavier(g, (Da, A + 1))}
    return tree


# ---------------------------------------------------------------------------
# Input assembly, masks, forward passes
# ---------------------------------------------------------------------------

def text_input(m: VALLE, text_ids, lang_ids, stack: str, dtype,
               add_lang: bool = True) -> torch.Tensor:
    """Token emb + per-position language emb + sinusoidal PE → [B, S, D]."""
    x = getattr(m, f"{stack}_text_embedding")(text_ids, dtype)
    if add_lang:
        x = x + getattr(m, f"{stack}_language_embedding")(lang_ids, dtype)
    return getattr(m, f"{stack}_text_position")(m.pe, x)


def ar_audio_input(m: VALLE, y_ids, offset: int = 0, dtype=None) -> torch.Tensor:
    emb = m.ar_audio_embedding(y_ids, dtype)
    return m.ar_audio_position(m.pe, emb, offset)


def ar_logits(m: VALLE, h: torch.Tensor) -> torch.Tensor:
    """[.., D] → f32 logits [.., 1025] (f32 accumulation)."""
    return h.float() @ m.ar_predict_layer.w.to(h.dtype).float()


def nar_forward_stage(m: VALLE, xy, stage_idx: int, mask=None,
                      attention: Optional[L.AttentionFn] = None, segments=None,
                      remat: bool = False) -> torch.Tensor:
    """One NAR pass conditioned on stage embedding `stage_idx` (0..6);
    `segments` runs attention through the flash kernel (key padding)."""
    stage_emb = m.nar_stage_embeddings.weight[stage_idx].to(xy.dtype)
    return m.nar_decoder(xy, mask, stage_emb, attention, segments, remat)


def nar_logits(m: VALLE, h: torch.Tensor, stage_idx: int) -> torch.Tensor:
    """[.., D] → f32 logits [.., 1024]; a tp rank holding the head's input
    rows [r0, r0 + n) multiplies its slice of h and all-reduces."""
    w = m.nar_predict_layers.w[stage_idx].to(h.dtype)
    if m.tp is not None and w.shape[0] != h.shape[-1]:
        h = m.tp.copy(h)[..., m.nar_head_rows: m.nar_head_rows + w.shape[0]]
        return m.tp.reduce(h.float() @ w.float())
    return h.float() @ w.float()


def nar_codebook_sum(m: VALLE, codes: torch.Tensor, coef, dtype) -> torch.Tensor:
    """Σ_j coef(j) · emb[j][codes[..., j]] over the NAR audio embeddings,
    j in codebook order, summed in the tables' f32 and rounded once to
    `dtype`; coef(j) is None (skip), 1 (as is) or a 0/1 mask to multiply.
    A tp rank holding codebooks [j0, j0 + n) sums its own, then the ranks'
    sums add (parallel/mesh.py)."""
    emb = m.nar_audio_embeddings.weight
    j0 = m.nar_codebook_start
    y = None
    for jl in range(emb.shape[0]):
        j = j0 + jl
        c = coef(j)
        if c is None:
            continue
        e = emb[jl][codes[..., j]]
        if not (isinstance(c, int) and c == 1):
            e = e * c.to(e.dtype)
        y = e if y is None else y + e
    if y is None:
        y = torch.zeros((*codes.shape[:-1], emb.shape[-1]), dtype=emb.dtype,
                        device=codes.device)
    if m.tp is not None and emb.shape[0] != m.cfg.num_quantizers:
        y = m.tp.reduce(y)
    return y.to(dtype)


def ar_forward(m: VALLE, xy, mask, remat: bool = True, segments=None,
               prefix_flash: Optional[int] = None) -> torch.Tensor:
    """Full-sequence AR decoder pass → hidden states [B, S, D]; with
    `segments` and `prefix_flash` = <text length> the attention runs
    through the prefix-causal flash kernel instead of the additive mask."""
    return m.ar_decoder(xy, mask, segments=segments, remat=remat,
                        prefix_flash=prefix_flash)


# ---------------------------------------------------------------------------
# Two-stage training parameter selection (reference: models/vallex.py:266-292)
# ---------------------------------------------------------------------------

def stage_param_labels(m: VALLE, stage: int) -> Dict[str, bool]:
    """{parameter name: trained in `stage`} (1 = ar_*, 2 = nar_*)."""
    if stage not in (1, 2):
        raise ValueError(f"stage must be 1 (AR) or 2 (NAR), got {stage}")
    prefix = "ar_" if stage == 1 else "nar_"
    return {name: name.startswith(prefix) for name, _ in m.named_parameters()}


def stage_parameters(m: VALLE, stage: int):
    """Iterator over the parameters trained in `stage` (1 = AR, 2 = NAR)."""
    labels = stage_param_labels(m, stage)
    for name, p in m.named_parameters():
        if labels[name]:
            yield p
