"""K decode steps of the hybrid AR (models/granite_hybrid.py) for B batched
requests, under decode_block_fused's batched contract (ops/decode_block.py):
(tokens, logprobs, done, sum_logprobs) in, a BlockResult out, the same
bookkeeping and sampling a step (its `run_block`), positions from
`audio_pos` (a host int or a 0-d int32 device tensor, so that
engine/ar.py::DeviceBlocks captures the block once and replays it at every
position).

A step, for every row:
  h = m_e · E_audio[fed]
  a Mamba layer: u = rms_norm_rows(h); zd = gemm_small_m(u, W_proj);
      xbc = conv_step(zd) (the convolution's state shifts in place);
      y = ssm_step(xbc, zd) (the f32 state S updates in place, y gated by
      silu(z)); h = gemm_small_m(rms_norm_rows(y), W_o, scale m_r, residual h)
  an attention layer: qkv = gemm_small_m(rms_norm_rows(h), W_qkv) (the query
      rows pre-scaled so that the kernel's 1/√hd gives attention_multiplier);
      the K/V column at row s_text + p_audio + t of the batched layout;
      masked_attention with each K/V head's G query heads as its G queries
      (q_off 0: they see the same keys), so each K/V head is read once for
      its G query heads; h = gemm_small_m(attn, W_o, scale m_r, residual h)
  the MLP: h = gemm_small_m(swiglu_rows(gemm_small_m(rms_norm_rows(h),
      W_in)), W_out, scale m_r, residual h)
  logits = gemm_small_m(rms_norm_rows(h), W_head, scale 1 / logits_scaling)
  then sample_epilogue.
Every tensor a step writes is allocated by the launches of that step or is
one of the states, allocated before the block, so a captured block replays.
"""

from __future__ import annotations

import math
from typing import Dict, Union

import torch

from ..config import ModelConfig
from ..kernels import gemm_small_m, masked_attention
from ..kernels.masked_attention import attention_bounds, step_bounds
from ..kernels.ssm_step import conv_step, rms_norm_rows, ssm_step, swiglu_rows
from ..models.granite_hybrid import HybridState
from .decode_block import BlockResult, run_block
from .decode_step import _pad_vocab

SITE = "decode_block_hybrid"


def pack_hybrid_weights(model, cfg: ModelConfig, dtype: torch.dtype) -> Dict:
    """The decode weights of the hybrid AR: the module's own matrices
    ([out, in], in `dtype`; no copy when they are already), f32 vectors,
    each attention layer's Q, K, V rows fused into one [(Hq + 2 Hkv) hd, D]
    matrix with the query rows scaled by attention_multiplier · √hd, the
    head padded to 1152 rows, and the scales m_r and 1 / logits_scaling as
    per-column f32 vectors."""
    h, stack = cfg.ar_stack, model.ar_decoder

    def mat(w):
        return w.to(dtype).contiguous()

    def vec(t):
        return t.float().contiguous()

    q_scale = h.attention_multiplier * math.sqrt(h.head_dim)
    head = _pad_vocab(model.ar_predict_layer.w.t())
    dev = head.device
    return {
        "emb": model.ar_audio_embedding.weight,
        "norm1": [vec(b.norm1) for b in stack.layers],
        "norm2": [vec(b.norm2) for b in stack.layers],
        "mlp_in": [mat(b.mlp_in) for b in stack.layers],
        "mlp_out": [mat(b.mlp_out) for b in stack.layers],
        "in_proj": [mat(m.in_proj) for m in stack.mamba],
        "conv_w": [vec(m.conv_w) for m in stack.mamba],
        "conv_b": [vec(m.conv_b) for m in stack.mamba],
        "dt_bias": [vec(m.dt_bias) for m in stack.mamba],
        "A_log": [vec(m.A_log) for m in stack.mamba],
        "D": [vec(m.D) for m in stack.mamba],
        "gnorm": [vec(m.norm) for m in stack.mamba],
        "out_proj": [mat(m.out_proj) for m in stack.mamba],
        "wqkv": [mat(torch.cat([a.wq.float() * q_scale, a.wk.float(), a.wv.float()]))
                 for a in stack.attn],
        "wo": [mat(a.wo) for a in stack.attn],
        "norm": vec(stack.norm),
        "wpred": mat(head),
        "res": torch.full((h.hidden_size,), h.residual_multiplier, device=dev),
        "logit_scale": torch.full((head.shape[0],), 1.0 / h.logits_scaling, device=dev),
    }


def hybrid_forward(fed: torch.Tensor, lw: Dict, cfg: ModelConfig, cache_k: torch.Tensor,
                   cache_v: torch.Tensor, state: HybridState, *, slot, bounds,
                   site: str = SITE) -> torch.Tensor:
    """One step of `fed` [B] → logits [B, VP] f32; the K/V columns go to
    cache row `slot` (an int, or a one-element int64 device tensor), the
    states update in place."""
    h = cfg.ar_stack
    B = fed.shape[0]
    eps, inner = h.rms_norm_eps, h.mamba_inner
    Hq, Hkv, hd = h.num_attention_heads, h.num_key_value_heads, h.head_dim
    G = Hq // Hkv
    x = h.embedding_multiplier * lw["emb"][fed.long()].float()
    res = lw["res"]
    for li, (kind, j) in enumerate(h.mixer_slots):
        u = rms_norm_rows(x, lw["norm1"][li], eps, site=site)
        if kind == "mamba":
            zd = gemm_small_m(u, lw["in_proj"][j], site=site)
            xbc = conv_step(zd, state.conv[j], lw["conv_w"][j], lw["conv_b"][j], x_off=inner,
                            site=site)
            y = ssm_step(xbc, zd, state.ssm[j], lw["dt_bias"][j], lw["A_log"][j], lw["D"][j],
                         z_off=0, dt_off=inner + h.conv_dim, site=site)
            x = gemm_small_m(rms_norm_rows(y, lw["gnorm"][j], eps, site=site),
                             lw["out_proj"][j], scale=res, residual=x, site=site)
        else:
            qkv = gemm_small_m(u, lw["wqkv"][j], site=site)
            kv = qkv[:, Hq * hd:].view(B, 2, Hkv, 1, hd).to(cache_k.dtype)
            if isinstance(slot, torch.Tensor):
                cache_k[j].index_copy_(2, slot.reshape(1), kv[:, 0])
                cache_v[j].index_copy_(2, slot.reshape(1), kv[:, 1])
            else:
                cache_k[j, :, :, slot: slot + 1] = kv[:, 0]
                cache_v[j, :, :, slot: slot + 1] = kv[:, 1]
            attn = torch.empty((B, Hq * hd), dtype=torch.float32, device=x.device)
            masked_attention(qkv[:, : Hq * hd].view(B, Hkv, G, hd), cache_k[j], cache_v[j],
                             bounds, out=attn.view(B, Hkv, G, hd), site=site)
            x = gemm_small_m(attn, lw["wo"][j], scale=res, residual=x, site=site)
        u = rms_norm_rows(x, lw["norm2"][li], eps, site=site)
        a = swiglu_rows(gemm_small_m(u, lw["mlp_in"][li], site=site), site=site)
        x = gemm_small_m(a, lw["mlp_out"][li], scale=res, residual=x, site=site)
    return gemm_small_m(rms_norm_rows(x, lw["norm"], eps, site=site), lw["wpred"],
                        scale=lw["logit_scale"], site=site)


def decode_block_hybrid(
    tokens: torch.Tensor,  # [B] int token to feed at step 0
    logprobs: torch.Tensor,  # [B] f32 its logprob
    done: torch.Tensor,  # [B] bool
    sum_logprobs: torch.Tensor,  # [B] f32
    lw: Dict,  # pack_hybrid_weights
    cfg: ModelConfig,
    cache_k: torch.Tensor,  # [NA, B, Hkv, C, hd], updated in place
    cache_v: torch.Tensor,
    state: HybridState,  # updated in place
    *,
    x_len: torch.Tensor,  # [B]
    prompt_len: torch.Tensor,  # [B]
    audio_pos: Union[int, torch.Tensor],  # generated frames before the block
    remaining: torch.Tensor,  # [B] steps left before each row's cap
    temperature: float,
    steps: int,
    s_text: int,
    p_audio: int,
    vocab: int,
    eos: int,
    stochastic: bool,
    generator=None,
) -> BlockResult:
    """K steps of `hybrid_forward` through ops/decode_block.py::run_block;
    generated frame t of every row at cache row s_text + p_audio + t, the
    attention seeing the row's text, BOS + prompt and generated rows up to
    its own."""
    dev = tokens.device
    s_gen = s_text + p_audio
    bounds = step_bounds(attention_bounds(
        tokens.shape[0], x_len=x_len, s_text=s_text, audio_len=prompt_len + 1, q_off=0,
        gen_lo=s_gen, gen_len=audio_pos + 1, device=dev), steps)
    if isinstance(audio_pos, torch.Tensor):
        slots = audio_pos + torch.arange(s_gen, s_gen + steps, device=dev, dtype=torch.long)
    else:
        slots = range(s_gen + audio_pos, s_gen + audio_pos + steps)

    def forward(fed, k):
        return hybrid_forward(fed, lw, cfg, cache_k, cache_v, state, slot=slots[k],
                              bounds=bounds[k])
    return run_block(forward, tokens, logprobs, done, sum_logprobs, remaining=remaining,
                     steps=steps, eos=eos, stochastic=stochastic, generator=generator,
                     vocab=vocab, temperature=temperature, site=SITE)
