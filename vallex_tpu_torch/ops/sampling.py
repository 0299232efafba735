"""Sampling outside the kernels (port of vallex_tpu/ops/sampling.py: the
plain categorical draw and speculative_accept).

Random draws come from an explicit torch.Generator. The match with the JAX
package is distributional: jax.random and torch give different numbers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def gumbel(u: torch.Tensor) -> torch.Tensor:
    """Gumbel noise from uniforms in [0, 1) (the TPU kernels' formula)."""
    return -torch.log(-torch.log(u + 1e-10) + 1e-10)


def categorical(logits: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """One draw per row of softmax(logits) (Gumbel-argmax) → int64."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    return torch.argmax(logits.float() + gumbel(u), dim=-1)


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
