"""`sample_epilogue`: logits → (token, logprob) per row (kernel:
sample_epilogue.cu).

Lanes >= vocab are masked, the logits are divided by the temperature and,
in filtered mode (`top_k` / `top_p` given), restricted to the top-k then
top-p kept set of ops/sampling.py::filtered_keep_mask; the token is the
Gumbel-argmax of the kept scaled logits + g(u) (u uniform in [0, 1), drawn
by the caller's torch.Generator) or the argmax of the masked logits when
greedy, clipped to vocab - 1, and its logprob is the log-softmax of the
kept scaled logits — the epilogue of the TPU decode_block_fused kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.sampling import filtered_keep_mask
from .loader import check, launch_counts, library, stream_ptr

NEG_BIG = -1e30


def sample_epilogue_plain(
    logits: torch.Tensor, u: Optional[torch.Tensor], *,
    vocab: int, temperature: float, greedy: bool,
    top_k: Optional[int] = None, top_p: Optional[float] = None,
    return_keep: bool = False,
):
    """[R, VP] f32 logits (+ [R, VP] uniforms) → (tok [R] int32, logp [R]
    f32), and the kept set [R, VP] bool with return_keep."""
    VP = logits.shape[-1]
    lanes = torch.arange(VP, device=logits.device)
    masked = torch.where(lanes < vocab, logits.float(), NEG_BIG)
    scaled = masked / max(float(temperature), 1e-6)
    keep = torch.ones_like(scaled, dtype=torch.bool)
    if top_k is not None or top_p is not None:
        keep = filtered_keep_mask(scaled, -1 if top_k is None else top_k,
                                  1.0 if top_p is None else top_p)
        scaled = torch.where(keep, scaled, NEG_BIG)
    if greedy:
        score = masked
    else:
        score = scaled - torch.log(-torch.log(u.float() + 1e-10) + 1e-10)
    best = score.max(dim=-1, keepdim=True).values
    tok = torch.where(score == best, lanes, VP).min(dim=-1).values
    tok = tok.clamp(max=vocab - 1)
    logp = torch.log_softmax(scaled, dim=-1).gather(-1, tok[:, None])[:, 0]
    out = (tok.to(torch.int32), logp)
    return out + (keep,) if return_keep else out


def sample_epilogue(
    logits: torch.Tensor, u: Optional[torch.Tensor], *,
    vocab: int, temperature: float, greedy: bool,
    top_k: Optional[int] = None, top_p: Optional[float] = None,
    return_keep: bool = False, site: str = "",
):
    """CPU tensors take the plain version; CUDA tensors launch or raise.
    Filtered mode when top_k or top_p is given (top_k <= 0 and top_p >= 1
    each disable their filter)."""
    if logits.device.type == "cpu":
        return sample_epilogue_plain(
            logits, u, vocab=vocab, temperature=temperature, greedy=greedy,
            top_k=top_k, top_p=top_p, return_keep=return_keep,
        )
    R, VP = logits.shape
    if logits.dtype != torch.float32 or logits.stride(-1) != 1:
        raise TypeError("sample_epilogue: logits must be f32 with a unit last stride")
    if not greedy:
        if u is None or u.shape != logits.shape or u.dtype != torch.float32 \
                or u.stride(-1) != 1 or u.device != logits.device:
            raise ValueError("sample_epilogue: sampling needs f32 uniforms shaped like the logits")
    if not 1 <= vocab <= VP:
        raise ValueError(f"sample_epilogue: vocab {vocab} outside 1..{VP}")
    filtered = top_k is not None or top_p is not None
    tok = torch.empty((R,), dtype=torch.int32, device=logits.device)
    logp = torch.empty((R,), dtype=torch.float32, device=logits.device)
    keep = (torch.empty((R, VP), dtype=torch.uint8, device=logits.device)
            if return_keep else None)
    rc = library().vx_sample_epilogue(
        logits.data_ptr(), logits.stride(0),
        None if greedy else u.data_ptr(), 0 if greedy else u.stride(0),
        R, VP, vocab, float(temperature), int(greedy), int(filtered),
        -1 if top_k is None else int(top_k), 1.0 if top_p is None else float(top_p),
        tok.data_ptr(), logp.data_ptr(),
        None if keep is None else keep.data_ptr(), VP, stream_ptr(logits),
    )
    check(rc, "sample_epilogue")
    launch_counts[("sample_epilogue", site)] += 1
    return (tok, logp) if keep is None else (tok, logp, keep.bool())
