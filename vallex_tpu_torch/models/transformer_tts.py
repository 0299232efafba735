"""Seq2seq Transformer TTS (text → mel spectrogram) for pipeline debugging
(port of vallex_tpu/models/transformer_tts.py).

The reference's debug model (models/transformer.py:41-394, after "Neural
Speech Synthesis with Transformer Network"): a text encoder, a mel decoder
with cross attention, a mel projection head and a stop-token head.
`forward` is the teacher-forced loss, masked mel MSE plus stop BCE
(models/transformer.py:222-318); `inference` decodes greedily frame by
frame, recomputing the decoder over the fixed frame buffer, until the stop
head fires (models/transformer.py:320-385). Attention is the plain masked
core. The functions run on the model's device; `build` puts a tree on
`cuda` unless told otherwise.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import NUM_MEL_BINS, ModelConfig
from . import layers as L
from .vallex import NEG_INF, Embedding, _kaiming, _uniform, stack_tree


class TransformerTTS(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        D = cfg.d_model
        self.cfg = cfg
        self.text_embedding = Embedding(cfg.num_text_tokens, D)
        self.encoder_position = L.SinePositionalEmbedding()
        self.decoder_position = L.SinePositionalEmbedding()
        self.decoder_prenet = L.Linear(NUM_MEL_BINS, D)
        self.encoder = L.EncoderStack(cfg.num_layers, D, cfg.num_heads, cfg.ffn_dim,
                                      adaptive=False)
        self.decoder = L.DecoderStack(cfg.num_layers, D, cfg.num_heads, cfg.ffn_dim,
                                      adaptive=False)
        self.predict_layer = L.Linear(D, NUM_MEL_BINS)
        self.stop_layer = L.Linear(D, 1)
        self.register_buffer("pe", L.make_sine_pe(cfg.max_position, D), persistent=False)


def _linear_tree(g, d_in: int, d_out: int) -> Dict:
    return {"w": _kaiming(g, (d_in, d_out)), "b": _uniform(g, (d_out,), 1.0 / d_in ** 0.5)}


def init_transformer_tts(cfg: ModelConfig, generator: torch.Generator) -> Dict:
    """Random parameter tree with the JAX package's names and shapes
    (vallex_tpu/models/transformer_tts.py:27), torch's default inits."""
    g = generator
    D, F, NL = cfg.d_model, cfg.ffn_dim, cfg.num_layers
    return {
        "text_embedding": {"weight": torch.randn(cfg.num_text_tokens, D, generator=g)},
        "encoder_position": {"alpha": torch.ones(())},
        "decoder_position": {"alpha": torch.ones(())},
        "decoder_prenet": _linear_tree(g, NUM_MEL_BINS, D),
        "encoder": stack_tree(g, NL, D, F, adaptive=False),
        "decoder": stack_tree(g, NL, D, F, adaptive=False, decoder=True),
        "predict_layer": _linear_tree(g, D, NUM_MEL_BINS),
        "stop_layer": _linear_tree(g, D, 1),
    }


def build(tree: Dict, cfg: Optional[ModelConfig] = None, *, device=None,
          dtype: torch.dtype = torch.float32) -> TransformerTTS:
    """The TransformerTTS holding `tree` in `dtype` on `device` (`cuda`
    unless told otherwise; raises without a GPU)."""
    from ..convert import load_tree
    from ..utils.device import resolve_device

    return load_tree(TransformerTTS(cfg or ModelConfig()), tree, dtype=dtype,
                     device=resolve_device(device))


def _tensor(x, dev, dtype=None) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x, device=dev)
    return t if dtype is None else t.to(dtype)


def _encode(m: TransformerTTS, text_ids: torch.Tensor, x_len, dtype):
    """→ (memory [B, S, D], additive key mask [B or 1, 1, 1, S])."""
    x = m.encoder_position(m.pe, m.text_embedding(text_ids, dtype))
    S, dev = text_ids.shape[1], text_ids.device
    ok = torch.arange(S, device=dev)[None, :] < _tensor(x_len, dev).reshape(-1, 1)
    mask = torch.where(ok, 0.0, NEG_INF)[:, None, None, :]
    return m.encoder(x, mask), mask


def _causal(T: int, dev) -> torch.Tensor:
    rows = torch.arange(T, device=dev)
    return torch.where(rows[None, :] <= rows[:, None], 0.0, NEG_INF)[None, None]


def _decode(m: TransformerTTS, mels: torch.Tensor, memory, self_mask, cross_mask, dtype):
    """Decoder over mel frames shifted right (a zero first frame)."""
    dec_in = torch.cat([torch.zeros_like(mels[:, :1]), mels[:, :-1]], dim=1)
    h = m.decoder_position(m.pe, m.decoder_prenet(dec_in.to(dtype)))
    return m.decoder(h, memory, self_mask, cross_mask)


def forward(
    m: TransformerTTS,
    cfg: ModelConfig,
    text_ids,  # [B, S]
    x_lens,  # [B]
    mels,  # [B, T, 100]
    mel_lens,  # [B]
    dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Teacher-forced training loss: masked mel MSE + stop BCE
    (vallex_tpu/models/transformer_tts.py:59) → (loss, {"mel_mse",
    "stop_bce"})."""
    dev = m.pe.device
    text = _tensor(text_ids, dev).long()
    mels = _tensor(mels, dev, torch.float32)
    mel_lens = _tensor(mel_lens, dev).long()
    T = mels.shape[1]
    memory, cross_mask = _encode(m, text, x_lens, dtype)
    rows = torch.arange(T, device=dev)
    valid = torch.where(rows[None, :] < mel_lens[:, None], 0.0, NEG_INF)[:, None, None, :]
    h = _decode(m, mels, memory, _causal(T, dev) + valid, cross_mask, dtype)
    mel_pred = m.predict_layer(h)
    stop_logits = m.stop_layer(h)[..., 0].float()

    frame_mask = (rows[None, :] < mel_lens[:, None]).float()
    denom = torch.clamp(frame_mask.sum(), min=1.0)
    mse = ((mel_pred - mels.to(dtype)) ** 2).mean(-1).float().mul(frame_mask).sum() / denom
    stop_target = (rows[None, :] == (mel_lens[:, None] - 1)).float()
    bce = ((torch.clamp(stop_logits, min=0) - stop_logits * stop_target
            + torch.log1p(torch.exp(-stop_logits.abs()))) * frame_mask).sum() / denom
    loss = mse + bce
    return loss, {"mel_mse": mse, "stop_bce": bce}


@torch.inference_mode()
def inference(
    m: TransformerTTS,
    cfg: ModelConfig,
    text_ids,  # [1, S]
    x_len: int,
    *,
    max_frames: int = 1000,
    dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, int]:
    """Greedy frame-by-frame decoding until the stop logit is positive or
    max_frames are written (vallex_tpu/models/transformer_tts.py:113; one
    host read of the stop logit a frame) → (mels [1, max_frames, 100] f32,
    frames written)."""
    dev = m.pe.device
    text = _tensor(text_ids, dev).long()
    memory, cross_mask = _encode(m, text, x_len, dtype)
    causal = _causal(max_frames, dev)
    rows = torch.arange(max_frames, device=dev)
    mels = torch.zeros((1, max_frames, NUM_MEL_BINS), dtype=dtype, device=dev)
    pos = 0
    while pos < max_frames:
        valid = torch.where(rows <= pos, 0.0, NEG_INF)[None, None, None, :]
        h = _decode(m, mels, memory, causal + valid, cross_mask, dtype)
        mels[:, pos] = m.predict_layer(h[:, pos])
        stop = m.stop_layer(h[:, pos])[0, 0]
        pos += 1
        if float(stop) > 0:
            break
    return mels.float(), pos
