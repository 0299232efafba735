"""The hybrid AR stack: Granite-4.0-H (Hugging Face `granitemoehybrid`,
ibm-granite/granite-4.0-h-micro) as VALL-E X's AR decoder, behind VALL-E
X's token tables and codebook-0 head (models/vallex.py builds it when
`ModelConfig.ar_stack` names it).

    h = m_e · (E_text[t] + E_lang[l])  or  m_e · E_audio[a]        (no positions)
    each layer:  h += m_r · Mixer(RMSNorm(h; g1))
                 h += m_r · W_out(silu(a) ⊙ b),  a, b = split(W_in RMSNorm(h; g2))
    logits = W_head RMSNorm(h; g_f) / logits_scaling
    Attention: grouped-query (query head i reads K/V head ⌊i / (Hq / Hkv)⌋),
        softmax(attention_multiplier · q·kᵀ) v over the causal valid keys.
    Mamba-2 (one group): z, xBC, dt = split(W_proj u); xBC = silu(causal
        depthwise conv, width 4, with bias); x, B, C = split(xBC);
        Δ = softplus(dt + dt_bias), A = −exp(A_log), per head
        S ← exp(Δ A) S + Δ x ⊗ B, y = S C + D x;
        out = W_o(g ⊙ RMSNorm(y ⊙ silu(z))).

The whole sequence is causal (text too), unlike VALL-E X's AR, whose text
rows see all text: a recurrent layer reads its tokens in order.

Tree (`init_tree`; matrices in torch's [out, in] layout, so the decode
products stream the module's own tensors): `layers` {norm1, norm2 [NL, D],
mlp_in [NL, 2F, D], mlp_out [NL, D, F]}, `mamba` {in_proj, conv_w [., C,
4], conv_b, dt_bias, A_log, D, norm [., inner], out_proj} stacked over the
Mamba layers, `attn` {wq, wk, wv, wo} over the attention layers, `norm` [D].

Prefill (`prefill`) runs R requests of different text and prompt lengths
in one call on a compacted layout: row r's valid tokens (its text, BOS and
prompt) at positions [0, n_r), padding after, so each row's convolution
and state cover exactly its own tokens. The Mamba layers' scan is the
chunked (SSD) form in plain torch ops (`ssd_chunked`; `ssd_sequential` is
the recurrence it equals); Δ = 0 at the padding carries each row's state
through it unchanged. The attention layers' K/V go to the batched cache
layout of engine/ar.py (text rows, then BOS + prompt at s_text, generated
frames at s_text + p_audio), which the decode block (ops/decode_hybrid.py)
extends; the states it continues are `prefill`'s (`HybridState`).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from ..config import HybridARConfig, ModelConfig
from ..kernels.ssm_step import rms_norm_rows_plain as rms_norm
from ..utils.profiling import DeviceSpan
from .layers import attention_core

NEG_INF = -1e9  # additive-mask value (models/vallex.py's)


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape), requires_grad=False)


class Block(nn.Module):
    """One layer's norms and its SwiGLU MLP (the mixer lives in `mamba` or
    `attn`)."""

    def __init__(self, h: HybridARConfig):
        super().__init__()
        D, F_ = h.hidden_size, h.intermediate_size
        self.norm1, self.norm2 = _param(D), _param(D)
        self.mlp_in, self.mlp_out = _param(2 * F_, D), _param(D, F_)


class Mamba(nn.Module):
    def __init__(self, h: HybridARConfig):
        super().__init__()
        H, D, C = h.mamba_n_heads, h.hidden_size, h.conv_dim
        self.in_proj = _param(h.in_proj_dim, D)
        self.conv_w, self.conv_b = _param(C, h.mamba_d_conv), _param(C)
        self.dt_bias, self.A_log, self.D = _param(H), _param(H), _param(H)
        self.norm = _param(h.mamba_inner)
        self.out_proj = _param(D, h.mamba_inner)


class Attention(nn.Module):
    def __init__(self, h: HybridARConfig):
        super().__init__()
        D, hd = h.hidden_size, h.head_dim
        self.wq = _param(h.num_attention_heads * hd, D)
        self.wk = _param(h.num_key_value_heads * hd, D)
        self.wv = _param(h.num_key_value_heads * hd, D)
        self.wo = _param(D, h.num_attention_heads * hd)


class HybridStack(nn.Module):
    def __init__(self, h: HybridARConfig):
        super().__init__()
        self.h = h
        self.layers = nn.ModuleList([Block(h) for _ in range(h.num_layers)])
        self.mamba = nn.ModuleList([Mamba(h) for _ in h.mamba_layers])
        self.attn = nn.ModuleList([Attention(h) for _ in h.attention_layers])
        self.norm = _param(h.hidden_size)


# ---------------------------------------------------------------------------
# Random init (torch's defaults, and mamba_ssm's for Δ, A and D)
# ---------------------------------------------------------------------------

def dt_bias_from(dt: torch.Tensor) -> torch.Tensor:
    """softplus⁻¹(dt): the bias that makes Δ = dt at a zero input."""
    return dt + torch.log(-torch.expm1(-dt))


def init_tree(h: HybridARConfig, g: torch.Generator) -> dict:
    """A random stack: Linear weights U(±1/√in), the convolution U(±1/√4)
    with its bias, RMSNorm gains one; dt = exp(U(log 0.001, log 0.1)) (at
    least 1e-4) through `dt_bias_from`, A ~ U[1, 16] as A_log, D one."""
    D, F_, NL = h.hidden_size, h.intermediate_size, h.num_layers
    nm, na, H = len(h.mamba_layers), len(h.attention_layers), h.mamba_n_heads
    hd, Hq, Hkv = h.head_dim, h.num_attention_heads, h.num_key_value_heads

    def lin(n, out, inp):
        return (torch.rand((n, out, inp), generator=g) * 2 - 1) / math.sqrt(inp)

    conv_bound = 1.0 / math.sqrt(h.mamba_d_conv)
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(lo + torch.rand((nm, H), generator=g) * (hi - lo)).clamp_min(1e-4)
    A = 1.0 + 15.0 * torch.rand((nm, H), generator=g)
    return {
        "layers": {"norm1": torch.ones(NL, D), "norm2": torch.ones(NL, D),
                   "mlp_in": lin(NL, 2 * F_, D), "mlp_out": lin(NL, D, F_)},
        "mamba": {"in_proj": lin(nm, h.in_proj_dim, D),
                  "conv_w": (torch.rand((nm, h.conv_dim, h.mamba_d_conv), generator=g) * 2 - 1)
                  * conv_bound,
                  "conv_b": (torch.rand((nm, h.conv_dim), generator=g) * 2 - 1) * conv_bound,
                  "dt_bias": dt_bias_from(dt), "A_log": torch.log(A), "D": torch.ones(nm, H),
                  "norm": torch.ones(nm, h.mamba_inner),
                  "out_proj": lin(nm, D, h.mamba_inner)},
        "attn": {"wq": lin(na, Hq * hd, D), "wk": lin(na, Hkv * hd, D),
                 "wv": lin(na, Hkv * hd, D), "wo": lin(na, D, Hq * hd)},
        "norm": torch.ones(D),
    }


# ---------------------------------------------------------------------------
# Pieces of the forward (f32 arithmetic; products in the weights' type)
# ---------------------------------------------------------------------------

def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [.., in] f32 · w [out, in]ᵀ in w's type → f32."""
    return F.linear(x.to(w.dtype), w).float()


def ssd_sequential(x, dt, A, B, C, S0=None):
    """The Mamba-2 recurrence, one position at a time: x [R, L, H, P], dt
    [R, L, H] (Δ), A [H], B, C [R, L, N] → (y [R, L, H, P] without the D
    term, the final state [R, H, P, N])."""
    R, L, H, P = x.shape
    S = x.new_zeros((R, H, P, B.shape[-1])) if S0 is None else S0.clone()
    ys = []
    for t in range(L):
        dA = torch.exp(dt[:, t] * A)  # [R, H]
        S = S * dA[:, :, None, None] + (dt[:, t, :, None] * x[:, t])[..., None] \
            * B[:, t, None, None, :]
        ys.append(S @ C[:, t, None, :, None])
    return torch.stack(ys, 1)[..., 0], S


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """`ssd_sequential` by chunks of `chunk` positions (the SSD form): within
    a chunk the quadratic form under the decay matrix exp(Σ_{s<r≤t} Δ_r A),
    across chunks the carried state. L need not be a multiple of `chunk`."""
    R, L, H, P = x.shape
    S = x.new_zeros((R, H, P, B.shape[-1]))
    ys = []
    for c0 in range(0, L, chunk):
        T = min(chunk, L - c0)
        dtc = dt[:, c0: c0 + T]  # [R, T, H]
        Bc, Cc = B[:, c0: c0 + T], C[:, c0: c0 + T]  # [R, T, N]
        acs = torch.cumsum((dtc * A).transpose(1, 2), dim=-1)  # [R, H, T]
        causal = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
        seg = (acs[..., :, None] - acs[..., None, :]).masked_fill(~causal, float("-inf"))
        xd = (x[:, c0: c0 + T] * dtc[..., None]).transpose(1, 2)  # [R, H, T, P]
        y = (torch.exp(seg) * (Cc @ Bc.transpose(1, 2))[:, None]) @ xd
        y = y + (Cc[:, None] @ S.transpose(-1, -2)) * torch.exp(acs)[..., None]
        ys.append(y.transpose(1, 2))
        to_end = torch.exp(acs[..., -1:] - acs)  # [R, H, T]
        S = S * torch.exp(acs[..., -1])[..., None, None] \
            + (xd * to_end[..., None]).transpose(-1, -2) @ Bc[:, None]
    return torch.cat(ys, 1), S


class HybridState(NamedTuple):
    """The Mamba layers' recurrent state, updated in place by the decode:
    conv [NM, R, 3, conv_dim] (each channel's last three inputs, oldest
    first) and ssm [NM, R, H, P, N], both f32."""
    conv: torch.Tensor
    ssm: torch.Tensor


def embed(model, h: HybridARConfig, text, lang, y_init, dtype) -> torch.Tensor:
    """[R, s_text + p_audio, D] f32: m_e · (E_text + E_lang) over the text
    slots, m_e · E_audio over BOS + prompt."""
    t = model.ar_text_embedding(text.long(), dtype).float() \
        + model.ar_language_embedding(lang.long(), dtype).float()
    a = model.ar_audio_embedding(y_init.long(), dtype).float()
    return h.embedding_multiplier * torch.cat([t, a], dim=1)


def compact_index(x_len, prompt_len, s_text: int, L: int):
    """Each row's valid tokens first: position i < n_r = x_len + 1 +
    prompt_len reads slot i (text) or s_text + i − x_len (BOS + prompt) of
    the batched layout → (slots [R, L] int64, n [R] int64). Padding reads
    slot 0; every later use masks it."""
    i = torch.arange(L, device=x_len.device)[None]
    xl, n = x_len.long()[:, None], (x_len.long() + 1 + prompt_len.long())[:, None]
    slots = torch.where(i < xl, i, torch.where(i < n, s_text + i - xl, 0))
    return slots, n[:, 0]


def layout_index(x_len, prompt_len, s_text: int, P: int):
    """The inverse of `compact_index` over the batched layout's first P
    slots → [R, P] int64: slot c's position in the compacted row (slots
    that hold no token read position 0)."""
    c = torch.arange(P, device=x_len.device)[None]
    xl, pl = x_len.long()[:, None], prompt_len.long()[:, None]
    return torch.where(c < xl, c, torch.where((c >= s_text) & (c - s_text <= pl),
                                              xl + c - s_text, 0))


def mamba_prefill(mx: Mamba, h: HybridARConfig, u: torch.Tensor, n: torch.Tensor,
                  spans: Optional[List[DeviceSpan]] = None):
    """One Mamba-2 mixer over the compacted rows u [R, L, D] (row r valid on
    [0, n_r)) → (out [R, L, D], conv state [R, 3, C], ssm state [R, H, P, N])."""
    R, L, _ = u.shape
    H, P, N, inner, C = (h.mamba_n_heads, h.mamba_d_head, h.mamba_d_state, h.mamba_inner,
                         h.conv_dim)
    zd = linear(u, mx.in_proj)
    z, xbc, dt = zd.split([inner, C, H], dim=-1)
    K = h.mamba_d_conv
    padded = F.pad(xbc.transpose(1, 2), (K - 1, 0))  # [R, C, L + 3]
    conv = F.silu(F.conv1d(padded, mx.conv_w.float()[:, None], mx.conv_b.float(), groups=C))
    # the last three inputs before n_r: padded positions n_r .. n_r + 2
    at = (n[:, None] + torch.arange(K - 1, device=u.device))[:, None].expand(R, C, K - 1)
    conv_state = padded.gather(2, at).transpose(1, 2).contiguous()
    x, B, Cm = conv.transpose(1, 2).split([inner, N, N], dim=-1)
    valid = torch.arange(L, device=u.device)[None] < n[:, None]
    delta = F.softplus(dt + mx.dt_bias.float()) * valid[..., None]
    A = -torch.exp(mx.A_log.float())
    stream = torch.cuda.current_stream(u.device) if u.device.type == "cuda" else None
    with record_function("vallex.ar.scan"):
        span = DeviceSpan("ar_scan", stream=stream)
        y, S = ssd_chunked(x.reshape(R, L, H, P), delta, A, B, Cm, h.mamba_chunk_size)
        span.close(stream)
    if spans is not None:
        spans.append(span)
    y = y + mx.D.float()[:, None] * x.reshape(R, L, H, P)
    y = y.reshape(R, L, inner) * F.silu(z)
    return linear(rms_norm(y, mx.norm, h.rms_norm_eps), mx.out_proj), conv_state, S


def prefill(model, cfg: ModelConfig, text, lang, x_len, y_init, prompt_len, *, s_text: int,
            p_audio: int, C: int, dtype, L: Optional[int] = None,
            scan_spans: Optional[List[DeviceSpan]] = None):
    """R requests (text/lang [R, s_text], y_init [R, p_audio] BOS + EOS-padded
    prompt, x_len / prompt_len [R] tensors) → (cache_k, cache_v [NA, R, Hkv,
    C, hd] in `dtype` with the prefix rows filled, HybridState, logits0
    [R, 1025] f32 at each row's last prompt position). L: the compacted
    rows' length, at least the longest row's tokens (default s_text +
    p_audio). Each Mamba layer's scan is a `vallex.ar.scan` span; with
    `scan_spans` its DeviceSpan is appended there."""
    h = cfg.ar_stack
    stack: HybridStack = model.ar_decoder
    R, dev = text.shape[0], text.device
    P = s_text + p_audio
    L = P if L is None else L
    slots, n = compact_index(x_len, prompt_len, s_text, L)
    inv = layout_index(x_len, prompt_len, s_text, P)
    emb = embed(model, h, text, lang, y_init, dtype)
    x = emb.gather(1, slots[..., None].expand(-1, -1, emb.shape[-1]))
    i = torch.arange(L, device=dev)
    ok = (i[None, :, None] >= i[None, None, :]) & (i[None, None, :] < n[:, None, None])
    mask = torch.where(ok, 0.0, NEG_INF)[:, None]  # [R, 1, L, L]
    Hq, Hkv, hd = h.num_attention_heads, h.num_key_value_heads, h.head_dim
    G = Hq // Hkv
    cache_k = torch.zeros((len(stack.attn), R, Hkv, C, hd), dtype=dtype, device=dev)
    cache_v = torch.zeros_like(cache_k)
    conv = torch.zeros((len(stack.mamba), R, h.mamba_d_conv - 1, h.conv_dim), device=dev)
    ssm = torch.zeros((len(stack.mamba), R, h.mamba_n_heads, h.mamba_d_head, h.mamba_d_state),
                      device=dev)
    res, eps = h.residual_multiplier, h.rms_norm_eps
    q_scale = h.attention_multiplier * math.sqrt(hd)  # attention_core divides by √hd
    to_layout = inv[:, None, :, None].expand(R, Hkv, P, hd)
    for li, (kind, j) in enumerate(h.mixer_slots):
        blk = stack.layers[li]
        u = rms_norm(x, blk.norm1, eps)
        if kind == "mamba":
            out, conv[j], ssm[j] = mamba_prefill(stack.mamba[j], h, u, n, scan_spans)
        else:
            mx = stack.attn[j]
            q = linear(u, mx.wq).view(R, L, Hq, hd).transpose(1, 2) * q_scale
            k, v = (linear(u, w).view(R, L, Hkv, hd).transpose(1, 2).to(dtype)
                    for w in (mx.wk, mx.wv))
            cache_k[j, :, :, :P] = k.gather(2, to_layout)
            cache_v[j, :, :, :P] = v.gather(2, to_layout)
            # each K/V head's G query heads at once (k, v broadcast over them)
            heads = [attention_core(q[:, g * G:(g + 1) * G], k[:, g: g + 1], v[:, g: g + 1], mask)
                     for g in range(Hkv)]
            out = linear(torch.cat(heads, 1).transpose(1, 2).reshape(R, L, Hq * hd), mx.wo)
        x = x + res * out
        u = rms_norm(x, blk.norm2, eps)
        a, b = linear(u, blk.mlp_in).chunk(2, dim=-1)
        x = x + res * linear(F.silu(a) * b, blk.mlp_out)
    last = x[torch.arange(R, device=dev), n - 1]
    return cache_k, cache_v, HybridState(conv, ssm), logits(model, h, last)


def logits(model, h: HybridARConfig, x: torch.Tensor) -> torch.Tensor:
    """[.., D] → f32 logits [.., 1025]: the final RMSNorm, VALL-E X's head,
    / logits_scaling."""
    xn = rms_norm(x, model.ar_decoder.norm, h.rms_norm_eps)
    return linear(xn, model.ar_predict_layer.w.t()) / h.logits_scaling


def state_bytes(cfg: ModelConfig, rows: int) -> int:
    """Bytes of the Mamba layers' recurrent state for `rows` rows (f32)."""
    h = cfg.ar_stack
    per = (h.mamba_d_conv - 1) * h.conv_dim + h.mamba_n_heads * h.mamba_d_head * h.mamba_d_state
    return 4 * per * rows * len(h.mamba_layers)
