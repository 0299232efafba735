"""VALL-E X model (port of vallex_tpu/models/vallex.py).

- AR stack: text embedding (2048×D), audio embedding (1026×D incl. EOS=1024
  and BOS=1025), sinusoidal PEs with learnable alpha, pre-norm encoder
  layers + final LayerNorm, untied head Linear(D→1025, no bias).
- NAR stack: text embedding, 8 audio embeddings (cb0 has 1025 rows for EOS),
  AdaLN layers conditioned on one of 7 stage embeddings, 7 predict heads.
- Language embeddings (3×D) added per text position.

Parameter names and shapes follow the JAX pytree, so `convert.py` is a
key-for-key copy and `init_vallex` here draws the same tree from a
torch.Generator.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from ..config import ModelConfig
from . import layers as L

NEG_INF = -1e9  # additive-mask value (f32-safe; softmax in f32)


class Embedding(nn.Module):
    def __init__(self, vocab: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(vocab, dim), requires_grad=False)

    def forward(self, ids: torch.Tensor, dtype=None) -> torch.Tensor:
        w = self.weight if dtype is None else self.weight.to(dtype)
        return w[ids]


class _Tensor(nn.Module):
    """One parameter under its JAX leaf name (`weight` or `w`)."""

    def __init__(self, name: str, *shape: int):
        super().__init__()
        self.register_parameter(
            name, nn.Parameter(torch.zeros(*shape), requires_grad=False))


class VALLE(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        D, q = cfg.d_model, cfg.num_quantizers
        self.cfg = cfg
        self.ar_text_embedding = Embedding(cfg.num_text_tokens, D)
        self.nar_text_embedding = Embedding(cfg.num_text_tokens, D)
        self.ar_audio_embedding = Embedding(cfg.ar_audio_vocab, D)
        self.ar_text_position = L.SinePositionalEmbedding()
        self.ar_audio_position = L.SinePositionalEmbedding()
        self.nar_text_position = L.SinePositionalEmbedding()
        self.nar_audio_position = L.SinePositionalEmbedding()
        self.ar_decoder = L.EncoderStack(
            cfg.num_layers, D, cfg.num_heads, cfg.ffn_dim, adaptive=False)
        self.nar_decoder = L.EncoderStack(
            cfg.num_layers, D, cfg.num_heads, cfg.ffn_dim, adaptive=True)
        self.ar_predict_layer = L.Linear(D, cfg.num_audio_tokens + 1, bias=False)
        self.nar_audio_embeddings = _Tensor(
            "weight", q, cfg.num_audio_tokens + 1, D)
        self.nar_predict_layers = _Tensor("w", q - 1, D, cfg.num_audio_tokens)
        self.nar_stage_embeddings = Embedding(q - 1, D)
        self.ar_language_embedding = Embedding(cfg.num_languages, D)
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


def init_vallex(cfg: ModelConfig, generator: torch.Generator) -> Dict:
    """Random parameter tree with the JAX package's names and shapes."""
    g = generator
    D, F, NL, q = cfg.d_model, cfg.ffn_dim, cfg.num_layers, cfg.num_quantizers
    A = cfg.num_audio_tokens

    def stack(adaptive: bool) -> Dict:
        def norm():
            n = {"scale": torch.ones(NL, D), "bias": torch.zeros(NL, D)}
            if adaptive:
                n["w"] = _kaiming(g, (NL, D, 2 * D))
                n["b"] = _uniform(g, (NL, 2 * D), 1.0 / math.sqrt(D))
            return n

        final = {"scale": torch.ones(D), "bias": torch.zeros(D)}
        if adaptive:
            final["w"] = _kaiming(g, (D, 2 * D))
            final["b"] = _uniform(g, (2 * D,), 1.0 / math.sqrt(D))
        return {
            "layers": {
                "self_attn": {
                    "in_proj_w": _xavier(g, (NL, D, 3 * D)),
                    "in_proj_b": torch.zeros(NL, 3 * D),
                    "out_w": _kaiming(g, (NL, D, D)),
                    "out_b": torch.zeros(NL, D),
                },
                "linear1": {"w": _kaiming(g, (NL, D, F)),
                            "b": _uniform(g, (NL, F), 1.0 / math.sqrt(D))},
                "linear2": {"w": _kaiming(g, (NL, F, D)),
                            "b": _uniform(g, (NL, D), 1.0 / math.sqrt(F))},
                "norm1": norm(),
                "norm2": norm(),
            },
            "norm": final,
        }

    nar_audio = torch.zeros(q, A + 1, D)
    nar_audio[0] = torch.randn(A + 1, D, generator=g)
    nar_audio[1:, :A] = torch.randn(q - 1, A, D, generator=g)
    nar_predict = torch.cat(
        [nar_audio[2:, :A].transpose(1, 2), _xavier(g, (1, D, A))], dim=0)
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
    w = m.nar_predict_layers.w[stage_idx].to(h.dtype)
    return h.float() @ w.float()


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
