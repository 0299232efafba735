"""Sampling outside the kernels (port of vallex_tpu/ops/sampling.py): the
plain categorical draw, top-k / top-p filtering (sort-based filters, and
the sort-free keep masks whose arithmetic the filtered sample_epilogue
kernel runs), topk_sampling and speculative_accept.

Reference semantics (models/vallex.py:791-853): temperature scaling, top-k
(disabled when top_k <= 0; ties at the k-th value all kept), then the
nucleus measured on the top-k-filtered distribution (disabled when top_p
>= 1; shift-right: the token whose cumulative mass crosses top_p is kept),
then a draw with its logprob from the filtered distribution.

Random draws come from an explicit torch.Generator. The match with the JAX
package is distributional: jax.random and torch give different numbers.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

NEG_INF = -1e9  # filtered-out logits (the JAX package's value)


def gumbel(u: torch.Tensor) -> torch.Tensor:
    """Gumbel noise from uniforms in [0, 1) (the TPU kernels' formula)."""
    return -torch.log(-torch.log(u + 1e-10) + 1e-10)


def categorical(logits: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """One draw per row of softmax(logits) (Gumbel-argmax) → int64."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    return torch.argmax(logits.float() + gumbel(u), dim=-1)


def top_k_filter(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Keep the top_k highest logits per row (logits below the k-th value
    → NEG_INF); top_k <= 0 disables."""
    if top_k <= 0:
        return logits
    k = min(max(int(top_k), 1), logits.shape[-1])
    thresh = torch.sort(logits, dim=-1, descending=True).values[..., k - 1: k]
    return torch.where(logits < thresh, NEG_INF, logits)


def top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filtering with the reference's shift-right semantics (the
    first token whose cumulative probability crosses top_p is kept);
    top_p >= 1 disables."""
    if top_p >= 1.0:
        return logits
    sort_idx = torch.argsort(-logits, dim=-1, stable=True)
    probs = torch.softmax(torch.gather(logits, -1, sort_idx), dim=-1)
    remove = torch.cumsum(probs, dim=-1) > top_p
    remove = torch.cat([torch.zeros_like(remove[..., :1]), remove[..., :-1]], dim=-1)
    remove_vocab = torch.zeros_like(remove).scatter(-1, sort_idx, remove)
    return torch.where(remove_vocab, NEG_INF, logits)


def _sortable_key(logits: torch.Tensor) -> torch.Tensor:
    """f32 → signed int32 keys with the same total order (non-negative
    floats keep their bits; negative ones flip their magnitude bits)."""
    b = logits.float().contiguous().view(torch.int32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def _bisect_min_key(count_gt: Callable[[torch.Tensor], torch.Tensor], B: int,
                    pred_limit, device=None) -> torch.Tensor:
    """Per row, the minimum int32 key v with count_gt(v) <= pred_limit, by
    32-step integer bisection (count_gt: [B, 1] keys → [B, 1] counts,
    monotone decreasing). The floor midpoint (lo>>1)+(hi>>1)+(lo&hi&1)
    cannot overflow."""
    lo = torch.full((B, 1), -(2 ** 31), dtype=torch.int32, device=device)
    hi = torch.full((B, 1), 2 ** 31 - 1, dtype=torch.int32, device=device)
    for _ in range(32):
        mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1)
        too_many = count_gt(mid) > pred_limit
        lo = torch.where(too_many, mid + 1, lo)
        hi = torch.where(too_many, hi, mid)
    return hi


def topk_keep_mask(logits: torch.Tensor, top_k) -> torch.Tensor:
    """[B, V] bool: logit >= its row's k-th largest value — top_k_filter's
    kept set (ties at the threshold all kept), sort-free. top_k <= 0
    keeps all. top_k: an int or a [B, 1] tensor."""
    B, V = logits.shape
    keys = _sortable_key(logits)
    top_k = torch.as_tensor(top_k, dtype=torch.int32, device=logits.device)
    k = top_k.clamp(1, V)
    tau = _bisect_min_key(lambda v: (keys > v).sum(1, keepdim=True, dtype=torch.int32),
                          B, k - 1, logits.device)
    return (keys >= tau) | (top_k <= 0)


def topp_keep_mask(logits: torch.Tensor, top_p) -> torch.Tensor:
    """[B, V] bool: keep token i iff the probability mass of the tokens
    strictly above it is <= top_p (the crossing token is kept) — top_p_filter's
    kept set for tie-free logits. top_p >= 1 keeps all."""
    B, V = logits.shape
    keys = _sortable_key(logits)
    probs = torch.softmax(logits.float(), dim=1)
    top_p = torch.as_tensor(top_p, dtype=torch.float32, device=logits.device)
    tau = _bisect_min_key(lambda v: torch.where(keys > v, probs, 0.0).sum(1, keepdim=True),
                          B, top_p, logits.device)
    return (keys >= tau) | (top_p >= 1.0)


def filtered_keep_mask(logits: torch.Tensor, top_k, top_p) -> torch.Tensor:
    """Combined top-k → top-p kept set: the nucleus mass is measured on the
    top-k-filtered distribution (the reference's filter order)."""
    keep_k = topk_keep_mask(logits, top_k)
    keep_p = topp_keep_mask(torch.where(keep_k, logits, NEG_INF), top_p)
    return keep_k & keep_p


def topk_sampling(
    generator: Optional[torch.Generator],
    logits: torch.Tensor,  # [B, V] f32
    top_k: int,
    top_p: float,
    temperature: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (tokens [B] int64, logprobs [B] f32): temperature, top-k, top-p,
    then a Gumbel-argmax draw (u [B, V] from the generator) or, at
    top_k == 1, the argmax; the logprob comes from the filtered
    distribution."""
    logits = logits.float() / max(float(temperature), 1e-6)
    logits = top_p_filter(top_k_filter(logits, top_k), top_p)
    if top_k == 1:
        tokens = torch.argmax(logits, dim=-1)
    else:
        tokens = categorical(logits, generator)
    logprobs = torch.log_softmax(logits, dim=-1).gather(-1, tokens[:, None])[:, 0]
    return tokens, logprobs


def speculative_accept(
    draft_tokens: torch.Tensor,  # [K-1] tokens the draft sampled
    q_logits: torch.Tensor,  # [K-1, V] draft logits at those positions
    p_logits: torch.Tensor,  # [K, V] target logits at positions 0..K-1
    temperature: float,
    generator: Optional[torch.Generator],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Distribution-exact speculative sampling (Leviathan et al. 2023):
    accept draft j with probability min(1, p_j(x)/q_j(x)); at the first
    rejection emit a sample of normalize(max(p_j - q_j, 0)); after K-1
    acceptances emit a bonus sample of p_{K-1}.

    → (emit [K], logp [K], m): emit[j] is the token emitted at position j
    if positions < j were accepted; logp[j] = log p_j(emit[j]); m = number
    of accepted drafts (0-dim tensor)."""
    Km1 = q_logits.shape[0]
    t = max(float(temperature), 1e-6)
    logp_p = torch.log_softmax(p_logits.float() / t, dim=-1)
    logp_q = torch.log_softmax(q_logits.float() / t, dim=-1)
    d = draft_tokens.long()[:, None]
    lp_px = logp_p[:Km1].gather(-1, d)[:, 0]
    lp_qx = logp_q.gather(-1, d)[:, 0]
    u = torch.rand((Km1,), generator=generator, device=p_logits.device)
    accept = torch.log(u.clamp(min=1e-9)) < (lp_px - lp_qx)
    m = torch.cumprod(accept.to(torch.int32), dim=0).sum()
    resid = torch.clamp(logp_p[:Km1].exp() - logp_q.exp(), min=0.0)
    degenerate = resid.sum(-1, keepdim=True) <= 0.0
    resid = torch.where(degenerate, logp_p[:Km1].exp(), resid)
    r_tok = categorical(torch.log(resid.clamp(min=1e-30)), generator)
    bonus = categorical(p_logits[-1:].float() / t, generator)
    emit = torch.cat([torch.where(accept, draft_tokens.long(), r_tok), bonus])
    logp = logp_p.gather(-1, emit[:, None])[:, 0]
    return emit, logp, m
