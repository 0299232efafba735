"""VALL-F: the decoder-architecture variant of VALL-E (port of
vallex_tpu/models/vallf.py).

Text is cross-attended memory rather than a causal prefix (reference:
models/vallex.py:46-49, models/__init__.py:98-136): an AR decoder stack of
plain-norm decoder layers and a NAR stack of AdaLN decoder layers, each
cross-attending its own text embedding (+ sinusoidal PE). The reference
leaves forward/inference unimplemented; as in the JAX package, this runs
inference: a greedy or sampled AR loop that recomputes the whole fixed
audio buffer each step (a parity variant, not the serving path) and the
7-stage NAR fill. Attention is the plain masked core (the JAX package's
is XLA's, outside any Pallas kernel).

The generate functions run on the model's device; `build` puts a parameter
tree on `cuda` unless told otherwise.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import ModelConfig
from . import layers as L
from .vallex import NEG_INF, Embedding, _Tensor, _xavier, nar_tables, stack_tree


class VALLF(nn.Module):
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
        self.ar_decoder = L.DecoderStack(cfg.num_layers, D, cfg.num_heads, cfg.ffn_dim,
                                         adaptive=False)
        self.nar_decoder = L.DecoderStack(cfg.num_layers, D, cfg.num_heads, cfg.ffn_dim,
                                          adaptive=True)
        self.ar_predict_layer = L.Linear(D, cfg.num_audio_tokens + 1, bias=False)
        self.nar_audio_embeddings = _Tensor("weight", q, cfg.num_audio_tokens + 1, D)
        self.nar_predict_layers = _Tensor("w", q - 1, D, cfg.num_audio_tokens)
        self.nar_stage_embeddings = Embedding(q - 1, D)
        self.register_buffer("pe", L.make_sine_pe(cfg.max_position, D), persistent=False)


def init_vallf(cfg: ModelConfig, generator: torch.Generator) -> Dict:
    """Random parameter tree with the JAX package's names and shapes
    (vallex_tpu/models/vallf.py:27), torch's default inits."""
    g = generator
    D, F, NL, q = cfg.d_model, cfg.ffn_dim, cfg.num_layers, cfg.num_quantizers
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
        "ar_decoder": stack_tree(g, NL, D, F, adaptive=False, decoder=True),
        "nar_decoder": stack_tree(g, NL, D, F, adaptive=True, decoder=True),
        "ar_predict_layer": {"w": _xavier(g, (D, cfg.num_audio_tokens + 1))},
        "nar_audio_embeddings": {"weight": nar_audio},
        "nar_predict_layers": {"w": nar_predict},
        "nar_stage_embeddings": {"weight": torch.randn(q - 1, D, generator=g)},
    }


def build(tree: Dict, cfg: Optional[ModelConfig] = None, *, device=None,
          dtype: torch.dtype = torch.float32) -> VALLF:
    """The VALLF holding `tree` (numpy or torch leaves) in `dtype` on
    `device` (`cuda` unless told otherwise; raises without a GPU)."""
    from ..convert import load_tree
    from ..utils.device import resolve_device

    return load_tree(VALLF(cfg or ModelConfig()), tree, dtype=dtype,
                     device=resolve_device(device))


def _text_memory(m: VALLF, text_ids: torch.Tensor, stack: str, dtype) -> torch.Tensor:
    emb = getattr(m, f"{stack}_text_embedding")(text_ids, dtype)
    return getattr(m, f"{stack}_text_position")(m.pe, emb)


def _key_mask(n: int, valid, device) -> torch.Tensor:
    """[1, 1, 1, n] additive: 0 on the first `valid` keys, NEG_INF after."""
    return torch.where(torch.arange(n, device=device) < valid, 0.0, NEG_INF)[None, None, None, :]


@torch.inference_mode()
def vallf_ar_generate(
    m: VALLF,
    cfg: ModelConfig,
    text_ids,  # [1, S]
    x_len: int,
    prompt_cb0,  # [1, Tp_max]
    prompt_len: int,
    *,
    t_audio: int,
    greedy: bool = True,
    temperature: float = 1.0,
    generator: Optional[torch.Generator] = None,
    dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, int]:
    """Greedy or sampled AR decode with the text as cross-attention memory
    (vallex_tpu/models/vallf.py:91): each step recomputes the decoder over
    the fixed audio buffer [BOS, prompt, generated, EOS padding] under a
    causal mask that also hides positions past the current one, and stops
    at the first EOS or at t_audio - 1. Sampling draws from `generator`
    (on the model's device). → (y [1, t_audio] int64, gen_len); gen_len
    counts the EOS when one was drawn, as in the JAX package."""
    dev = m.pe.device
    text = torch.as_tensor(np.asarray(text_ids), device=dev).long()
    cb0 = torch.as_tensor(np.asarray(prompt_cb0), device=dev).long()
    if 1 + cb0.shape[1] > t_audio:
        raise ValueError(f"prompt buffer of {cb0.shape[1]} frames does not fit t_audio {t_audio}")
    memory = _text_memory(m, text, "ar", dtype)
    cross_mask = _key_mask(text.shape[1], x_len, dev)
    y = torch.full((1, t_audio), cfg.eos_id, dtype=torch.long, device=dev)
    y[:, 0] = cfg.bos_id
    y[:, 1: 1 + cb0.shape[1]] = cb0
    rows = torch.arange(t_audio, device=dev)
    causal = torch.where(rows[None, :] <= rows[:, None], 0.0, NEG_INF)[None, None]
    w = m.ar_predict_layer.w.to(dtype).float()
    pos = int(prompt_len)
    while pos < t_audio - 1:
        y_pos = m.ar_audio_position(m.pe, m.ar_audio_embedding(y, dtype))
        h = m.ar_decoder(y_pos, memory, causal + _key_mask(t_audio, pos + 1, dev), cross_mask)
        logits = h[:, pos].float() @ w  # [1, 1025], f32 accumulation
        if greedy:
            tok = torch.argmax(logits, dim=-1)
        else:
            probs = torch.softmax(logits / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        y[:, pos + 1] = tok
        pos += 1
        if int(tok[0]) == cfg.eos_id:
            break
    return y, pos - int(prompt_len)


@torch.inference_mode()
def vallf_nar_generate(
    m: VALLF,
    cfg: ModelConfig,
    text_ids,  # [1, S]
    x_len: int,
    codes_in,  # [1, t_audio, 8]: prompt rows full, then the AR's codebook 0
    t_len: int,
    prompt_len: int,
    *,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """7 NAR passes of the AdaLN decoder stack with the text as memory
    (vallex_tpu/models/vallf.py:169): stage s argmax-decodes codebook s + 1
    on the generated suffix and adds its embedding. → codes [1, t_audio, 8]
    int64 (prompt rows as given)."""
    dev = m.pe.device
    text = torch.as_tensor(np.asarray(text_ids), device=dev).long()
    codes = torch.as_tensor(np.asarray(codes_in), device=dev).long()
    t_audio = codes.shape[1]
    memory = _text_memory(m, text, "nar", dtype)
    tables = m.nar_audio_embeddings.weight
    rows = torch.arange(t_audio, device=dev)[None, :]
    in_prompt = (rows < prompt_len)[..., None]
    in_suffix = ((rows >= prompt_len) & (rows < t_len))[..., None]
    y_emb = tables[0][codes[..., 0]].to(dtype)
    for j in range(1, cfg.num_quantizers):
        y_emb = y_emb + torch.where(in_prompt, tables[j][codes[..., j]].to(dtype), 0)
    self_mask = _key_mask(t_audio, t_len, dev)
    cross_mask = _key_mask(text.shape[1], x_len, dev)
    stage_codes = []
    for stage in range(cfg.num_quantizers - 1):
        y_pos = m.nar_audio_position(m.pe, y_emb)
        stage_emb = m.nar_stage_embeddings.weight[stage].to(dtype)
        h = m.nar_decoder(y_pos, memory, self_mask, cross_mask, stage_emb)
        logits = h.float() @ m.nar_predict_layers.w[stage].to(dtype).float()
        samples = torch.argmax(logits, dim=-1)
        y_emb = y_emb + torch.where(in_suffix, tables[stage + 1][samples].to(dtype), 0)
        stage_codes.append(samples)
    out = torch.stack([codes[..., 0]] + stage_codes, dim=-1)
    return torch.where(in_prompt, codes, out)
