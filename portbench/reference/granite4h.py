"""Plain float32 hybrid AR: Granite-4.0-H (Hugging Face `granitemoehybrid`,
https://huggingface.co/ibm-granite/granite-4.0-h-micro) as VALL-E X's AR,
over one request's whole, unpadded sequence, teacher-forced on given tokens,
with no cache, no batching, no chunks and no kernels. It reads the
parameter tree the benchmark made (portbench/archs/granite4h.py: matrices
[out, in]) and imports nothing of the program; TF32 is off for its
products (`strict_float32`, entered by each call).

Per layer, as published: h += m_r · Mixer(RMSNorm(h)), then h += m_r ·
W_out(silu(a) ⊙ b) with a, b = split(W_in RMSNorm(h)); RMSNorm eps 1e-5,
no biases but the convolution's. Mamba-2 (one group): z, xBC, dt =
split(W_proj u); xBC = silu(causal depthwise conv of width 4 + bias); x, B,
C = split(xBC); Δ = softplus(dt + dt_bias), A = −exp(A_log); y_t = Σ_{s≤t}
exp(Σ_{s<r≤t} Δ_r A) (C_t · B_s) Δ_s x_s + D x_t, the quadratic (masked)
form over the whole sequence (`ssd_quadratic`; exact, and independent of
any chunking or recurrence); out = W_o(g ⊙ RMSNorm(y ⊙ silu(z))).
Attention: 32 query heads over 8 K/V heads (query head i reads K/V head
⌊i / 4⌋), softmax(attention_multiplier · q·kᵀ) v.

Departures from the published model, each VALL-E X's:
- the token tables and head: text (2048) + language (3) and audio (1026:
  1024 codes, EOS, BOS) embeddings, h = m_e · (E_text + E_lang) over the
  text and m_e · E_audio over BOS, prompt and tokens, and a 1025-way
  codebook-0 head (VALL-E X's `ar_predict_layer`, [D, 1025]) instead of
  the 100352-row tied table; logits = head(RMSNorm(h)) / logits_scaling;
- causal text: every position, text included, sees itself and what comes
  before (VALL-E X's AR lets text rows see all text);
- no positions (as published: `position_embedding_type` nope; VALL-E X
  adds sinusoidal ones).

`Precision` (quant.py) rounds the products' weights and inputs, the K/V
and the residual stream for the control; with any rounding set, the Mamba
layers run the recurrence (`ssd_recurrent`) with their f32 state rounded
to bfloat16 after every position, the precision next below the state's.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch
import torch.nn.functional as F

from .quant import FLOAT32, Precision
from .vallex import as_f32

NEG_INF = -1e9


@contextlib.contextmanager
def strict_float32():
    """TF32 off for the products inside."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def rms_norm(x, g, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * g


def segsum(a: torch.Tensor) -> torch.Tensor:
    """a [.., L] → [.., L, L]: Σ_{s<r≤t} a_r at (t, s) for s ≤ t, −inf above
    the diagonal (a masked cumulative sum: no difference of large sums)."""
    L = a.shape[-1]
    x = a[..., None, :].expand(*a.shape, L).transpose(-1, -2)  # [.., r, s] = a_r
    below = torch.ones((L, L), dtype=torch.bool, device=a.device).tril(-1)
    x = x.masked_fill(~below, 0.0).cumsum(dim=-2)
    return x.masked_fill(~torch.ones_like(below).tril(), float("-inf"))


def ssd_quadratic(x, dt, A, B, C):
    """x [L, H, P], Δ [L, H], A [H], B, C [L, N] → y [L, H, P] (no D term)."""
    M = torch.exp(segsum((dt * A).T)) * (C @ B.T)[None]  # [H, L, L]
    return (M @ (x * dt[..., None]).transpose(0, 1)).transpose(0, 1)


def ssd_recurrent(x, dt, A, B, C, state_dtype=None):
    """The same, one position at a time; with `state_dtype` the state is
    rounded to it after every position."""
    L, H, P = x.shape
    S = x.new_zeros((H, P, B.shape[-1]))
    ys = []
    for t in range(L):
        S = S * torch.exp(dt[t] * A)[:, None, None] + (dt[t, :, None] * x[t])[..., None] * B[t]
        if state_dtype is not None:
            S = S.to(state_dtype).float()
        ys.append(S @ C[t])
    return torch.stack(ys)


class Model:
    """A float32 copy of the AR's tables, stack and head, and its sizes
    (`hybrid`: the configuration's `granitemoehybrid` keys)."""

    def __init__(self, tree: Dict, hybrid: Dict, eos: int = 1024, bos: int = 1025):
        self.p = as_f32({k: v for k, v in tree.items() if k.startswith("ar_")})
        self.h = hybrid
        self.eos, self.bos = eos, bos
        self.device = self.p["ar_text_embedding"]["weight"].device


def _mamba(m: Model, i: int, u, prec: Precision):
    h, mp = m.h, m.p["ar_decoder"]["mamba"]
    H, P, N = h["mamba_n_heads"], h["mamba_d_head"], h["mamba_d_state"]
    inner = H * P
    Cd = inner + 2 * N
    zd = prec.matmul(u, mp["in_proj"][i].T)
    z, xbc, dt = zd.split([inner, Cd, H], dim=-1)
    K = h["mamba_d_conv"]
    w = mp["conv_w"][i]  # [Cd, K]
    past = torch.cat([xbc.new_zeros((K - 1, Cd)), xbc])
    conv = mp["conv_b"][i] + sum(w[:, j] * past[j: j + len(xbc)] for j in range(K))
    xs, B, C = F.silu(conv).split([inner, N, N], dim=-1)
    xs = xs.reshape(-1, H, P)
    delta = F.softplus(dt + mp["dt_bias"][i])
    A = -torch.exp(mp["A_log"][i])
    if prec == FLOAT32:
        y = ssd_quadratic(xs, delta, A, B, C)
    else:
        y = ssd_recurrent(xs, delta, A, B, C, state_dtype=torch.bfloat16)
    y = (y + mp["D"][i][:, None] * xs).reshape(-1, inner) * F.silu(z)
    return prec.matmul(rms_norm(y, mp["norm"][i], h["rms_norm_eps"]), mp["out_proj"][i].T)


def _attention(m: Model, i: int, u, prec: Precision):
    h, ap = m.h, m.p["ar_decoder"]["attn"]
    Hq, Hkv = h["num_attention_heads"], h["num_key_value_heads"]
    hd = h["hidden_size"] // Hq
    n = len(u)
    q = prec.act(prec.matmul(u, ap["wq"][i].T).view(n, Hq, hd).transpose(0, 1))
    k, v = (prec.kv(prec.matmul(u, ap[w][i].T).view(n, Hkv, hd).transpose(0, 1))
            for w in ("wk", "wv"))
    k, v = (t.repeat_interleave(Hq // Hkv, dim=0) for t in (k, v))
    causal = torch.ones((n, n), dtype=torch.bool, device=u.device).tril()
    s = (q @ k.transpose(-1, -2)) * h["attention_multiplier"]
    s = s.masked_fill(~causal, NEG_INF)
    o = (torch.softmax(s, dim=-1) @ v).transpose(0, 1).reshape(n, Hq * hd)
    return prec.matmul(o, ap["wo"][i].T)


def ar_logits(m: Model, text, lang, prompt_cb0, tokens, prec: Precision = FLOAT32
              ) -> torch.Tensor:
    """Logits [len(tokens) + 1, 1025] predicting tokens[0], ..., tokens[-1]
    and the token after them, for [text | BOS, prompt, tokens]."""
    with strict_float32():
        p, h = m.p, m.h
        S, Tp = len(text), len(prompt_cb0)
        audio = torch.cat([torch.tensor([m.bos], device=m.device), prompt_cb0, tokens]).long()
        x = torch.cat([p["ar_text_embedding"]["weight"][text]
                       + p["ar_language_embedding"]["weight"][lang],
                       p["ar_audio_embedding"]["weight"][audio]]) * h["embedding_multiplier"]
        x = prec.act(x)
        st, eps, res = p["ar_decoder"], h["rms_norm_eps"], h["residual_multiplier"]
        seen = {"mamba": 0, "attention": 0}
        for li, kind in enumerate(h["layer_types"]):
            i = seen[kind]
            seen[kind] += 1
            u = rms_norm(x, st["layers"]["norm1"][li], eps)
            mix = _mamba(m, i, u, prec) if kind == "mamba" else _attention(m, i, u, prec)
            x = prec.act(x + res * mix)
            u = rms_norm(x, st["layers"]["norm2"][li], eps)
            a, b = prec.matmul(u, st["layers"]["mlp_in"][li].T).chunk(2, dim=-1)
            x = prec.act(x + res * prec.matmul(F.silu(a) * b, st["layers"]["mlp_out"][li].T))
        xn = rms_norm(x[S + Tp:], st["norm"], eps)
        return prec.matmul(xn, p["ar_predict_layer"]["w"]) / h["logits_scaling"]
