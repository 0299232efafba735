"""K AR decode steps with sampling and bookkeeping (port of
vallex_tpu/ops/decode_block.py::decode_block_fused at B = 1).

Each step k, as in the TPU kernel's header and its `_attention` prologue:
  capped = k >= remaining; d0 = done | capped
  fed = EOS if d0 else cur_tok; sum_logprobs += cur_logp unless d0
  done = d0 | (fed == EOS); fed tokens are returned per step
  one decoder forward of `fed` at position audio_pos + k (KV column written
      at s_text + audio_pos + k) → logits [VP] (kept: the draft's q)
  (cur_tok, cur_logp) = sample(logits): Gumbel-argmax of logits/T + g(u)
      with u from the caller's torch.Generator, or argmax when greedy;
      logprob from the temperature-scaled log-softmax.
The weights are the bf16 or int8 (W8A16) dict of ops/decode_step.py. The
steps run as launches of the hand-written kernels (products, attention,
sampling); the bookkeeping is a few tensor ops per step that stay on the
device, so the host never waits inside a block.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from ..kernels import sample_epilogue
from .decode_verify import forward_positions

SITE = "decode_block_fused"


class BlockResult(NamedTuple):
    fed: torch.Tensor  # [K] token fed at each step
    next_tok: torch.Tensor  # [1] token to feed after the block
    next_logp: torch.Tensor  # [1] f32 its logprob
    done: torch.Tensor  # [1] bool
    sum_logprobs: torch.Tensor  # [1] f32
    step_logits: torch.Tensor  # [K, VP] f32 pre-sampling logits per step


def decode_block_fused(
    tokens: torch.Tensor,  # [1] int token to feed at step 0
    logprobs: torch.Tensor,  # [1] f32 its logprob
    done: torch.Tensor,  # [1] bool
    sum_logprobs: torch.Tensor,  # [1] f32
    lw: Dict,
    cache_k: torch.Tensor,  # [NL, H, C, hd] with >= K slack rows; in place
    cache_v: torch.Tensor,
    pe_table: torch.Tensor,
    *,
    x_len: int,
    audio_pos: int,
    remaining: int,  # steps left before the length cap
    temperature: float,
    steps: int,
    s_text: int,
    vocab: int,
    eos: int,
    stochastic: bool,
    generator: Optional[torch.Generator] = None,
) -> BlockResult:
    dev = tokens.device
    cur_tok = tokens.to(torch.int32)
    cur_lp = logprobs.float()
    done = done.clone()
    sum_lp = sum_logprobs.float().clone()
    fed_all, logits_all = [], []
    for k in range(steps):
        d0 = done | (k >= remaining)
        fed = torch.where(d0, eos, cur_tok)
        sum_lp = sum_lp + torch.where(d0, 0.0, cur_lp)
        done = d0 | (fed == eos)
        fed_all.append(fed)
        logits = forward_positions(
            fed, lw, cache_k, cache_v, pe_table, x_len=x_len,
            audio_pos=audio_pos + k, s_text=s_text, site=SITE,
        )
        logits_all.append(logits)
        u = None
        if stochastic:
            u = torch.rand(logits.shape, generator=generator, device=dev)
        cur_tok, cur_lp = sample_epilogue(
            logits, u, vocab=vocab, temperature=temperature,
            greedy=not stochastic, site=SITE,
        )
    return BlockResult(
        torch.cat(fed_all), cur_tok, cur_lp, done, sum_lp,
        torch.cat(logits_all),
    )
