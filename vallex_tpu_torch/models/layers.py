"""Core building blocks as `nn.Module`s (port of vallex_tpu/models/layers.py).

Numerical conventions follow the JAX package so the two agree in fp32:
- linear kernels are stored [in, out] (`x @ w + b`), in the compute dtype;
- LayerNorm statistics are f32 whatever the compute dtype (eps 1e-5);
- attention is pre-norm, fused-QKV, softmax(QKᵀ/√hd + mask)V with f32
  scores and softmax, probabilities cast to V's dtype before the product;
- AdaptiveLayerNorm: (W·e) ⊙ LN(x) + (b·e) for a stage embedding e;
- FFN is Linear → ReLU → Linear.
Attention inputs and outputs keep the [B, H, T, hd] layout of the JAX code.
`DecoderLayer` / `DecoderStack` (self-attention, cross-attention to a text
memory, FFN) serve VALL-F and the debug Transformer TTS.

Training (the JAX package's `segments` / `prefix_flash` / `remat`
arguments): `segments` = (q_seg, kv_seg) [B, T] int32 routes self-attention
through the flash kernel with segment ids (`attention_core_flash`), and
`prefix_flash` = <text length> through its prefix-causal form
(`attention_core_flash_prefix`); `remat` re-runs each layer's forward in
the backward pass (torch.utils.checkpoint, non-reentrant) instead of saving
its intermediates. Parameters are built frozen (requires_grad=False); a
trainer unfreezes them.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels.flash_attention import flash_attention

# attention_fn(q, k, v) -> [B, H, Tq, hd]; replaces the masked core (the
# NAR's kernel route) when given
AttentionFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape), requires_grad=False)


def layer_norm(x: torch.Tensor, scale, bias, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.scale = _param(dim)
        self.bias = _param(dim)

    def forward(self, x: torch.Tensor, stage_emb=None) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias)


class Linear(nn.Module):
    """y = x·w + b with w stored [in, out] (the JAX layout). Under tensor
    parallelism (parallel/mesh.py::shard_params) `tp_mode` "col" holds a
    column slice (and its bias slice), "row" a row slice whose products
    the ranks sum before the replicated bias (parallel/collectives.py)."""

    tp = None
    tp_mode = None

    def __init__(self, d_in: int, d_out: int, bias: bool = True):
        super().__init__()
        self.w = _param(d_in, d_out)
        self.b = _param(d_out) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.w.to(x.dtype)
        if self.tp_mode == "col":
            y = self.tp.col_product(x, w)
        elif self.tp_mode == "row":
            y = self.tp.row_product(x, w)
        else:
            y = x @ w
        if self.b is not None:
            y = y + self.b.to(x.dtype)
        return y


class AdaptiveLayerNorm(nn.Module):
    """(W·e) ⊙ LN(x) + (b·e) (reference: modules/transformer.py:94-107)."""

    def __init__(self, dim: int):
        super().__init__()
        self.w = _param(dim, 2 * dim)
        self.b = _param(2 * dim)
        self.scale = _param(dim)
        self.bias = _param(dim)

    def forward(self, x: torch.Tensor, stage_emb: torch.Tensor) -> torch.Tensor:
        # the projection in the wider of the two types, as JAX promotes
        # (bf16 stage embedding, f32 training parameters)
        dt = torch.promote_types(stage_emb.dtype, self.w.dtype)
        wb = stage_emb.to(dt) @ self.w.to(dt) + self.b.to(dt)
        dim = x.shape[-1]
        weight, bias = wb[..., :dim], wb[..., dim:]
        normed = layer_norm(x, self.scale, self.bias)
        return (weight.to(x.dtype) * normed + bias.to(x.dtype)).to(x.dtype)


def make_sine_pe(max_len: int, dim: int, device=None) -> torch.Tensor:
    position = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    div_term = torch.exp(
        torch.arange(0, dim, 2, dtype=torch.float32, device=device)
        * -(math.log(10000.0) / dim)
    )
    pe = torch.zeros((max_len, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(position * div_term)
    pe[:, 1::2] = torch.cos(position * div_term)
    return pe


class SinePositionalEmbedding(nn.Module):
    """x + alpha · PE[offset : offset + T] with a learnable alpha
    (reference: modules/embedding.py:50-97). The table is f32."""

    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(()), requires_grad=False)

    def forward(self, pe_table: torch.Tensor, x: torch.Tensor, offset: int = 0):
        T = x.shape[-2]
        pe = pe_table[offset: offset + T]
        return x + (self.alpha * pe).to(x.dtype)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, T, D] → [B, H, T, hd] (a view)."""
    B, T, D = x.shape
    return x.view(B, T, num_heads, D // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, hd] → [B, T, D]"""
    B, H, T, hd = x.shape
    return x.transpose(1, 2).reshape(B, T, H * hd)


def attention_core(q, k, v, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """softmax(qkᵀ/√hd + mask)·v with f32 scores; mask additive f32,
    broadcastable to [B, H, Tq, Tk]."""
    hd = q.shape[-1]
    scores = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1)
    out = probs.to(v.dtype).float() @ v.float()
    return out.to(q.dtype)


def attention_core_flash(q, k, v, q_seg, kv_seg, causal: bool = False) -> torch.Tensor:
    """Flash attention with segment ids (vallex_tpu/models/layers.py:205):
    query i attends key j iff q_seg[:, i] == kv_seg[:, j] (and j <= i when
    causal). q, k, v [B, H, T, hd]; q_seg, kv_seg [B, T] int32."""
    prefix = 0 if causal else q.shape[-2]
    return flash_attention(q, k, v, q_seg, kv_seg, prefix, site="flash_attention_train")


def attention_core_flash_prefix(q, k, v, q_seg, kv_seg, text_len: int) -> torch.Tensor:
    """Prefix-causal flash attention (vallex_tpu/models/layers.py:259): a
    bidirectional text block of `text_len` rows, then a causal audio block
    that also sees the whole text; within matching segments. One launch of
    the kernel with prefix = text_len (kernels/flash_attention.py)."""
    return flash_attention(q, k, v, q_seg, kv_seg, text_len, site="flash_attention_prefix")


class MultiheadAttention(nn.Module):
    """Fused-QKV self-attention (reference: modules/activation.py:142-167).
    Under tensor parallelism the layer holds its rank's heads (Q, K and V
    columns of `num_heads` heads, the matching rows of out_w): a
    column-parallel in-projection, a row-parallel out-projection summed
    over the ranks before the replicated bias."""

    tp = None

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_w = _param(dim, 3 * dim)
        self.in_proj_b = _param(3 * dim)
        self.out_w = _param(dim, dim)
        self.out_b = _param(dim)

    def qkv(self, x: torch.Tensor):
        w = self.in_proj_w.to(x.dtype)
        qkv = (x @ w if self.tp is None else self.tp.col_product(x, w)) + self.in_proj_b.to(
            x.dtype)
        q, k, v = qkv.chunk(3, dim=-1)
        H = self.num_heads
        return split_heads(q, H), split_heads(k, H), split_heads(v, H)

    def out(self, attn: torch.Tensor) -> torch.Tensor:
        y = merge_heads(attn)
        w = self.out_w.to(y.dtype)
        y = y @ w if self.tp is None else self.tp.row_product(y, w)
        return y + self.out_b.to(y.dtype)

    def cross(self, q_in, kv_in, mask=None) -> torch.Tensor:
        """cross_mha_apply: q from the first D columns of the packed
        in-projection, k and v from the rest (torch's _in_projection_packed;
        reference: modules/activation.py:12-65)."""
        D = q_in.shape[-1]
        w, b = self.in_proj_w.to(q_in.dtype), self.in_proj_b.to(q_in.dtype)
        q = q_in @ w[:, :D] + b[:D]
        k, v = (kv_in @ w[:, D:] + b[D:]).chunk(2, dim=-1)
        H = self.num_heads
        return self.out(attention_core(split_heads(q, H), split_heads(k, H),
                                       split_heads(v, H), mask))

    def forward(self, x, mask=None, attention: Optional[AttentionFn] = None,
                segments=None, prefix_flash: Optional[int] = None):
        """mha_apply."""
        q, k, v = self.qkv(x)
        if segments is not None:
            if prefix_flash is not None:
                a = attention_core_flash_prefix(q, k, v, *segments, prefix_flash)
            else:
                a = attention_core_flash(q, k, v, *segments)
        elif attention is not None:
            a = attention(q, k, v)
        else:
            a = attention_core(q, k, v, mask)
        return self.out(a)


class EncoderLayer(nn.Module):
    """Pre-norm transformer encoder layer (reference:
    modules/transformer.py:295-302); AdaLN norms when `adaptive`."""

    def __init__(self, dim: int, num_heads: int, ffn_dim: int, adaptive: bool):
        super().__init__()
        norm = AdaptiveLayerNorm if adaptive else LayerNorm
        self.self_attn = MultiheadAttention(dim, num_heads)
        self.linear1 = Linear(dim, ffn_dim)
        self.linear2 = Linear(ffn_dim, dim)
        self.norm1 = norm(dim)
        self.norm2 = norm(dim)

    def ffn(self, x: torch.Tensor, stage_emb=None) -> torch.Tensor:
        h = self.norm2(x, stage_emb)
        return x + self.linear2(torch.relu(self.linear1(h)))

    def forward(self, x, mask=None, stage_emb=None,
                attention: Optional[AttentionFn] = None, segments=None,
                prefix_flash: Optional[int] = None) -> torch.Tensor:
        """encoder_layer_apply."""
        h = self.norm1(x, stage_emb)
        x = x + self.self_attn(h, mask, attention, segments, prefix_flash)
        return self.ffn(x, stage_emb)

    def prefill(self, x, mask) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """encoder_layer_prefill: also returns this layer's K, V [B, H, T, hd]."""
        h = self.norm1(x)
        q, k, v = self.self_attn.qkv(h)
        x = x + self.self_attn.out(attention_core(q, k, v, mask))
        return self.ffn(x), k, v

    def decode_step(self, x, cache_k, cache_v, slot: int, kv_mask):
        """encoder_layer_decode_step: x [B, 1, D]; writes this step's K, V
        into cache_k/v [B, H, C, hd] at `slot` (in place) and attends the
        cache under the additive kv_mask."""
        h = self.norm1(x)
        q, k, v = self.self_attn.qkv(h)
        cache_k[:, :, slot: slot + 1] = k.to(cache_k.dtype)
        cache_v[:, :, slot: slot + 1] = v.to(cache_v.dtype)
        a = attention_core(q, cache_k.to(q.dtype), cache_v.to(q.dtype), kv_mask)
        x = x + self.self_attn.out(a)
        return self.ffn(x)


class EncoderStack(nn.Module):
    def __init__(self, num_layers: int, dim: int, num_heads: int, ffn_dim: int,
                 adaptive: bool):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(dim, num_heads, ffn_dim, adaptive)
            for _ in range(num_layers)
        )
        self.norm = AdaptiveLayerNorm(dim) if adaptive else LayerNorm(dim)

    def forward(self, x, mask=None, stage_emb=None,
                attention: Optional[AttentionFn] = None, segments=None,
                remat: bool = False, prefix_flash: Optional[int] = None) -> torch.Tensor:
        """encoder_stack_apply; with `remat` under autograd each layer's
        forward runs again in the backward pass."""
        remat = remat and torch.is_grad_enabled()
        for layer in self.layers:
            args = (x, mask, stage_emb, attention, segments, prefix_flash)
            x = checkpoint(layer, *args, use_reentrant=False) if remat else layer(*args)
        return self.norm(x, stage_emb)


class DecoderLayer(nn.Module):
    """Pre-norm transformer decoder layer: self-attention, cross-attention
    to a memory, FFN (reference: modules/transformer.py:476-668; VALL-F and
    the debug Transformer TTS); AdaLN norms `norm0`-`norm2` when
    `adaptive`. Masks are additive f32; attention is the plain core."""

    def __init__(self, dim: int, num_heads: int, ffn_dim: int, adaptive: bool):
        super().__init__()
        norm = AdaptiveLayerNorm if adaptive else LayerNorm
        self.self_attn = MultiheadAttention(dim, num_heads)
        self.cross_attn = MultiheadAttention(dim, num_heads)
        self.linear1 = Linear(dim, ffn_dim)
        self.linear2 = Linear(ffn_dim, dim)
        self.norm0 = norm(dim)
        self.norm1 = norm(dim)
        self.norm2 = norm(dim)

    def forward(self, x, memory, self_mask=None, cross_mask=None,
                stage_emb=None) -> torch.Tensor:
        """decoder_layer_apply: x [B, T, D], memory [B, S, D]."""
        x = x + self.self_attn(self.norm0(x, stage_emb), self_mask)
        x = x + self.cross_attn.cross(self.norm1(x, stage_emb), memory, cross_mask)
        h = self.norm2(x, stage_emb)
        return x + self.linear2(torch.relu(self.linear1(h)))


class DecoderStack(nn.Module):
    def __init__(self, num_layers: int, dim: int, num_heads: int, ffn_dim: int,
                 adaptive: bool):
        super().__init__()
        self.layers = nn.ModuleList(
            DecoderLayer(dim, num_heads, ffn_dim, adaptive) for _ in range(num_layers))
        self.norm = AdaptiveLayerNorm(dim) if adaptive else LayerNorm(dim)

    def forward(self, x, memory, self_mask=None, cross_mask=None,
                stage_emb=None) -> torch.Tensor:
        """decoder_stack_apply."""
        for layer in self.layers:
            x = layer(x, memory, self_mask, cross_mask, stage_emb)
        return self.norm(x, stage_emb)
