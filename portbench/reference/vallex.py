"""Plain float32 VALL-E X: the AR and the NAR over one request's whole,
unpadded sequence, teacher-forced on given tokens, with no cache, no
batching and no kernels. It reads the parameter tree the benchmark made
(the layout `vallex_tpu_torch.api.preload_models` takes) and imports
nothing of the program.

The equations are VALL-E X's (Plachtaa/VALL-E-X models/vallex.py; VALL-E,
arXiv:2301.02111 §4) as the program computes them:
- pre-norm encoder layers, fused QKV, softmax(QKᵀ/√hd + mask)V, ReLU FFN,
  LayerNorm eps 1e-5, linear weights stored [in, out];
- inputs: token embedding + language embedding (text) + alpha · sinusoidal
  PE, text and audio each from position 0;
- AR mask: a text row sees every text column and the BOS column (the
  program's prefill mask, which differs from the published inference
  code); an audio row sees all text and the audio up to itself; the head
  is a bias-free Linear(D → 1025) after the final LayerNorm;
- NAR (prefix_mode 1): full attention over the valid text and audio; the
  audio input is codebook 0's embedding everywhere plus codebooks 1..7 on
  the prompt rows and codebooks 1..s on the generated rows at stage s;
  AdaLN conditioned on stage embedding s; head s over the generated rows.

`Precision` (quant.py) lowers the products, the K/V and the stored
activations for the control.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from .quant import FLOAT32, Precision

NEG_INF = -1e9


def sine_pe(n: int, dim: int, device) -> torch.Tensor:
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / dim))
    pe = torch.zeros((n, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def layer_norm(x, scale, bias, eps=1e-5):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def as_f32(tree):
    """The tree with every leaf a float32 tensor (same device)."""
    if isinstance(tree, dict):
        return {k: as_f32(v) for k, v in tree.items()}
    return torch.as_tensor(tree).float()


class Model:
    """A float32 copy of the parameter tree and the model's sizes."""

    def __init__(self, tree: Dict, num_heads: int, eos: int = 1024, bos: int = 1025):
        self.p = as_f32(tree)
        self.H = num_heads
        self.D = self.p["ar_text_embedding"]["weight"].shape[1]
        self.eos, self.bos = eos, bos
        self.device = self.p["ar_text_embedding"]["weight"].device


def _norm(x, n, li, stage_emb):
    """LayerNorm of layer li (or the final one with li None); AdaLN when
    the node has a projection and a stage embedding is given."""
    take = (lambda a: a) if li is None else (lambda a: a[li])
    y = layer_norm(x, take(n["scale"]), take(n["bias"]))
    if "w" not in n:
        return y
    wb = stage_emb @ take(n["w"]) + take(n["b"])
    D = x.shape[-1]
    return wb[:D] * y + wb[D:]


def encoder(m: Model, stack: Dict, x: torch.Tensor, mask: torch.Tensor,
            prec: Precision, stage_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [n, D] through every layer and the final norm; mask [n, n] additive."""
    L = stack["layers"]
    H, D = m.H, x.shape[-1]
    hd = D // H
    x = prec.act(x)
    for li in range(L["self_attn"]["in_proj_w"].shape[0]):
        a = L["self_attn"]
        h = _norm(x, L["norm1"], li, stage_emb)
        qkv = prec.matmul(h, a["in_proj_w"][li]) + a["in_proj_b"][li]
        q, k, v = (t.view(-1, H, hd).transpose(0, 1) for t in qkv.chunk(3, dim=-1))
        q, k, v = prec.act(q), prec.kv(k), prec.kv(v)
        s = (q @ k.transpose(-1, -2)) / math.sqrt(hd) + mask
        o = (torch.softmax(s, dim=-1) @ v).transpose(0, 1).reshape(-1, D)
        x = prec.act(x + prec.matmul(o, a["out_w"][li]) + a["out_b"][li])
        h = _norm(x, L["norm2"], li, stage_emb)
        f = torch.relu(prec.matmul(h, L["linear1"]["w"][li]) + L["linear1"]["b"][li])
        x = prec.act(x + prec.matmul(f, L["linear2"]["w"][li]) + L["linear2"]["b"][li])
    return _norm(x, stack["norm"], None, stage_emb)


def _text(m: Model, which: str, text, lang, pe):
    p = m.p
    x = p[f"{which}_text_embedding"]["weight"][text] + p[f"{which}_language_embedding"][
        "weight"][lang]
    return x + p[f"{which}_text_position"]["alpha"] * pe[: len(text)]


def ar_logits(m: Model, text, lang, prompt_cb0, tokens, prec: Precision = FLOAT32
              ) -> torch.Tensor:
    """Logits [len(tokens) + 1, 1025] predicting tokens[0], ..., tokens[-1]
    and the token after them, for [text | BOS, prompt, tokens]."""
    p, dev = m.p, m.device
    S, Tp = len(text), len(prompt_cb0)
    audio = torch.cat([torch.tensor([m.bos], device=dev), prompt_cb0, tokens]).long()
    T = len(audio)
    pe = sine_pe(max(S, T), m.D, dev)
    x = _text(m, "ar", text, lang, pe)
    y = p["ar_audio_embedding"]["weight"][audio] + p["ar_audio_position"]["alpha"] * pe[:T]
    n = S + T
    rows = torch.arange(n, device=dev)[:, None]
    cols = torch.arange(n, device=dev)[None, :]
    ok = (cols < S) | ((cols - S) <= torch.clamp(rows - S, min=0))
    mask = torch.where(ok, 0.0, NEG_INF)
    h = encoder(m, p["ar_decoder"], torch.cat([x, y]), mask, prec)
    return prec.matmul(h[S + Tp:], p["ar_predict_layer"]["w"])


def nar_logits(m: Model, text, lang, codes, Tp: int, prec: Precision = FLOAT32
               ) -> List[torch.Tensor]:
    """codes [Tp + G, 8]: the prompt's rows, then the generated rows
    (codebook 0 from the AR, 1..7 the codes to judge) → per stage s the
    logits [G, 1024] predicting codebook s + 1 of the generated rows."""
    p, dev = m.p, m.device
    S, T = len(text), len(codes)
    tables = p["nar_audio_embeddings"]["weight"]
    pe = sine_pe(max(S, T), m.D, dev)
    x = _text(m, "nar", text, lang, pe)
    prompt_row = (torch.arange(T, device=dev) < Tp)[:, None]
    y = tables[0][codes[:, 0]]
    for j in range(1, tables.shape[0]):
        y = y + torch.where(prompt_row, tables[j][codes[:, j]], 0.0)
    mask = torch.zeros((S + T, S + T), device=dev)
    out = []
    for s in range(tables.shape[0] - 1):
        if s:
            y = y + torch.where(prompt_row, 0.0, tables[s][codes[:, s]])
        xy = torch.cat([x, y + p["nar_audio_position"]["alpha"] * pe[:T]])
        h = encoder(m, p["nar_decoder"], xy, mask, prec,
                    stage_emb=p["nar_stage_embeddings"]["weight"][s])
        out.append(prec.matmul(h[S + Tp:], p["nar_predict_layers"]["w"][s]))
    return out
