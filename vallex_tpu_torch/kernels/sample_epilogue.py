"""`sample_epilogue`: logits → (token, logprob) per row (kernel:
sample_epilogue.cu).

Lanes >= vocab are masked, the logits are divided by the temperature and,
in filtered mode (`top_k` / `top_p` given), restricted to the top-k then
top-p kept set of ops/sampling.py::filtered_keep_mask; the token is the
Gumbel-argmax of the kept scaled logits + g(u) (u uniform in [0, 1), drawn
by the caller's torch.Generator) or the argmax of the masked logits when
greedy, clipped to vocab - 1, and its logprob is the log-softmax of the
kept scaled logits — the epilogue of the TPU decode_block_fused kernel.

The kernel runs a row per warp with the row in registers. Its top-k
threshold is a radix select (`radix_topk_key_plain` is its plain version)
and, when top_k > 0 leaves at most CAND_CAP candidates, its top-p threshold
comes from the candidates sorted by key (`topp_kept_sorted_plain`); both
give the kept set of ops/sampling.py's bisections. Only the tests use these
two plain versions.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from ..ops.sampling import filtered_keep_mask
from .loader import check, count_launch, library, stream_ptr

NEG_BIG = -1e30
VP_MAX = 2048  # the kernel's ceiling on the row width (16 float4 a lane)
CAND_CAP = 64  # top-p candidates the kernel sorts in a warp
RADIX_BITS = 8  # the radix select's digit: 32 / 8 = 4 passes
_INT_MIN, _INT_MAX = -(2 ** 31), 2 ** 31 - 1


def radix_topk_key_plain(keys: torch.Tensor, k) -> torch.Tensor:
    """[R, V] int32 sortable keys, k (an int or [R]; clipped to 1..V) →
    tau [R] int32: the k-th largest key counted with multiplicity, which is
    the bisection's least v with #(keys > v) <= k - 1. Found as the kernel
    finds it: 4 passes of 8 bits, from the top digit, each a 256-bin count
    histogram of the keys that match the digits chosen so far; the chosen
    digit's bin is where the count from the top bin crosses what is left
    of k."""
    R, V = keys.shape
    uk = keys.to(torch.int64) - _INT_MIN  # the unsigned order, in int64
    krem = torch.as_tensor(k, dtype=torch.int64).expand(R).clamp(1, V).clone()
    prefix = torch.zeros(R, dtype=torch.int64)
    match = torch.ones((R, V), dtype=torch.bool)
    nbins = 1 << RADIX_BITS
    for shift in range(32 - RADIX_BITS, -1, -RADIX_BITS):
        digit = (uk >> shift) & (nbins - 1)
        hist = torch.zeros((R, nbins), dtype=torch.int64).scatter_add_(1, digit, match.long())
        upto = hist.flip(1).cumsum(1).flip(1)  # keys in this bin or a higher one
        above = upto - hist
        d = ((above < krem[:, None]) & (krem[:, None] <= upto)).long().argmax(1)
        krem -= above.gather(1, d[:, None])[:, 0]
        prefix |= d << shift
        match &= digit == d[:, None]
    return (prefix + _INT_MIN).to(torch.int32)


def topp_kept_sorted_plain(keys: torch.Tensor, probs: torch.Tensor, cand: torch.Tensor,
                           top_p: float) -> torch.Tensor:
    """[R, V] keys, probabilities and candidate mask → [R, V] kept mask: the
    candidates sorted by key (descending), the exclusive prefix sums of their
    probabilities, and tau = the least key whose prefix is <= top_p. The
    prefix at the first of a group of equal keys is the mass strictly above
    the group, so a candidate is kept iff the mass above it is <= top_p —
    the bisection's nucleus over the candidates (the others must carry no
    mass)."""
    k64 = torch.where(cand, keys.to(torch.int64), _INT_MIN - 1)
    order = torch.argsort(k64, dim=1, descending=True, stable=True)
    ks = k64.gather(1, order)
    ps = torch.where(cand, probs.float(), 0.0).gather(1, order)
    excl = torch.cat([torch.zeros_like(ps[:, :1]), ps.cumsum(1)[:, :-1]], dim=1)
    ok = cand.gather(1, order) & (excl <= top_p)
    tau = torch.where(ok, ks, _INT_MAX).min(1).values
    return cand & (keys.to(torch.int64) >= tau[:, None])


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
    t0 = time.perf_counter()
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
    if VP > VP_MAX or VP % 4:
        raise ValueError(f"sample_epilogue: the kernel takes rows of a multiple of 4 up to"
                         f" VP_MAX = {VP_MAX} logits, not {VP}")
    for name, t in (("logits", logits),) + (() if greedy else (("uniforms", u),)):
        if t.data_ptr() % 16 or t.stride(0) % 4:
            raise ValueError(f"sample_epilogue: {name} must start on 16 bytes and have a row"
                             f" stride of a multiple of 4 floats")
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
    count_launch("sample_epilogue", site, t0)
    return (tok, logp) if keep is None else (tok, logp, keep.bool())
