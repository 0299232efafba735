"""K AR decode steps with sampling and bookkeeping (port of
vallex_tpu/ops/decode_block.py::decode_block_fused: one request,
`batched=True` for B requests, grouped best_of samples, and the filtered
epilogue).

Each step k, as in the TPU kernel's header and its `_attention` prologue,
for every row:
  capped = k >= remaining; d0 = done | capped
  fed = EOS if d0 else cur_tok; sum_logprobs += cur_logp unless d0
  done = d0 | (fed == EOS); fed tokens are returned per step
  one decoder forward of `fed` (ops/decode_verify.py::decoder_forward)
      → logits [VP] (kept: the draft's q)
  (cur_tok, cur_logp) = sample(logits): Gumbel-argmax of logits/T + g(u)
      with u [B, VP] from the caller's torch.Generator, or argmax when
      greedy; logprob from the temperature-scaled log-softmax. With top_k /
      top_p (the TPU kernel's `filtered=True`), both the draw and the
      logprob come from the top-k → top-p kept set.
One request: position audio_pos + k, KV column at s_text + audio_pos + k,
cache [NL, H, C, hd]. Batched (the TPU kernel's `_hbm_fold_batched`
contract): `audio_pos` is the count of generated frames before the block
(pos0), generated frame t of every row lives at cache row s_text + p_audio
+ t, row r's audio position is prompt_len[r] + 1 + t, and x_len, prompt_len
and remaining are [B] vectors; the cache is [NL, B, H, C, hd]. Grouped
(`prefix` given, the TPU kernel's `_hbm_fold_beams` for one request and
`_hbm_fold_batched_grouped` for R): B = R·beams request-major rows, the
prefix [NL, R, H, s_text + p_audio, hd] holds each request's text + BOS +
prompt K/V once, and the cache holds only generated rows (frame t at row
t).
The weights are the bf16, f32 or int8 (W8A16) dict of ops/decode_step.py;
`act_quant` runs the int8 products as W8A8 (the TPU kernel's `qmat`, head
W8A16), and `kv_scales` ([NL, H] f32 each for K and V) marks int8 caches
(and prefix): the k-scale folds into q, the v-scale into the attention
output, each step's own column is folded in unrounded in cache units and
quantized into the cache by the attention kernel (the TPU kernel's
`kv_quant`, vallex_tpu/ops/decode_block.py:249-266, :528-544). The
steps run as launches of the hand-written kernels (products, attention,
sampling); the bookkeeping is a few tensor ops per step that stay on the
device, so the host never waits inside a block.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

from ..kernels import sample_epilogue
from ..kernels.masked_attention import attention_bounds, step_bounds
from .decode_verify import decoder_forward

SITE = "decode_block_fused"
SITE_BATCHED = "decode_block_fused_batched"
# the attention launches of grouped blocks: one request's samples, R requests'
SITE_BEAMS = "decode_block_fused_beams"
SITE_GROUPED = "decode_block_fused_grouped"
SITE_FILTERED = "decode_block_fused_filtered"  # the epilogue in filtered mode
SITE_W8A8 = "decode_block_fused_w8a8"  # the products of act_quant blocks
SITE_INT8KV = "decode_block_fused_int8kv"  # the attention over int8 caches


class BlockResult(NamedTuple):
    fed: torch.Tensor  # [K] (batched: [K, B]) token fed at each step
    next_tok: torch.Tensor  # [B] token to feed after the block
    next_logp: torch.Tensor  # [B] f32 its logprob
    done: torch.Tensor  # [B] bool
    sum_logprobs: torch.Tensor  # [B] f32
    step_logits: torch.Tensor  # [K, VP] (batched: [K, B, VP]) f32 logits per step


def decode_block_fused(
    tokens: torch.Tensor,  # [B] int token to feed at step 0
    logprobs: torch.Tensor,  # [B] f32 its logprob
    done: torch.Tensor,  # [B] bool
    sum_logprobs: torch.Tensor,  # [B] f32
    lw: Dict,
    cache_k: torch.Tensor,  # [NL, H, C, hd] (batched: [NL, B, H, C, hd]); in place
    cache_v: torch.Tensor,
    pe_table: torch.Tensor,
    *,
    x_len: Union[int, torch.Tensor],  # batched: [B]
    audio_pos: int,  # position of step 0 (batched: generated frames before the block)
    remaining: Union[int, torch.Tensor],  # steps left before the length cap (batched: [B])
    temperature: float,
    steps: int,
    s_text: int,
    vocab: int,
    eos: int,
    stochastic: bool,
    generator: Optional[torch.Generator] = None,
    prompt_len: Optional[torch.Tensor] = None,  # batched: [B] valid prompt frames
    batched: bool = False,
    p_audio: int = 0,  # batched: BOS + prompt bucket rows
    prefix: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # grouped
    beams: int = 1,
    top_k: Optional[int] = None,  # filtered epilogue (<= 0: off)
    top_p: Optional[float] = None,  # filtered epilogue (>= 1: off)
    act_quant: bool = False,  # W8A8 products (int8 weights)
    kv_scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # int8 caches
) -> BlockResult:
    dev = tokens.device
    B = tokens.shape[0]
    cur_tok = tokens.to(torch.int32)
    cur_lp = logprobs.float()
    done = done.clone()
    sum_lp = sum_logprobs.float().clone()
    att_site = None
    filtered = top_k is not None or top_p is not None
    if batched:
        site, cache5 = SITE_BATCHED, (cache_k, cache_v)
        s_gen = s_text + p_audio
        if prefix is not None:  # generated rows only in the caches
            s_gen = 0
            att_site = SITE_BEAMS if B == beams else SITE_GROUPED
        # [K, B] audio position of each row at each step
        pos = (prompt_len.long() + 1 + audio_pos)[None] + torch.arange(steps, device=dev)[:, None]
        bounds = attention_bounds(B, x_len=x_len, s_text=s_text, audio_len=prompt_len + 1,
                                  q_off=1, gen_lo=s_gen, gen_len=audio_pos + 1, device=dev)
    else:
        site, cache5 = SITE, (cache_k[:, None], cache_v[:, None])
        s_gen = s_text
        bounds = attention_bounds(1, x_len=x_len, s_text=s_text, audio_len=audio_pos + 1,
                                  q_off=1, device=dev)
    bounds = step_bounds(bounds, steps)
    # launches count per site: the products of W8A8 blocks and the
    # attention over int8 caches under their own
    att_site = SITE_INT8KV if kv_scales is not None else att_site or site
    prod_site = SITE_W8A8 if act_quant else site
    fed_all, logits_all = [], []
    for k in range(steps):
        d0 = done | (k >= remaining)
        fed = torch.where(d0, eos, cur_tok)
        sum_lp = sum_lp + torch.where(d0, 0.0, cur_lp)
        done = d0 | (fed == eos)
        fed_all.append(fed)
        pe_rows = (pe_table.index_select(0, pos[k]) if batched
                   else pe_table[audio_pos + k: audio_pos + k + 1])
        logits = decoder_forward(
            fed, lw, *cache5, pe_rows, slot=s_gen + audio_pos + k,
            bounds=bounds[k], site=prod_site, prefix=prefix, beams=beams,
            attention_site=att_site, act_quant=act_quant, kv_scales=kv_scales,
        )
        logits_all.append(logits)
        u = None
        if stochastic:
            u = torch.rand(logits.shape, generator=generator, device=dev)
        cur_tok, cur_lp = sample_epilogue(
            logits, u, vocab=vocab, temperature=temperature,
            greedy=not stochastic, top_k=top_k, top_p=top_p,
            site=SITE_FILTERED if filtered else site,
        )
    join = torch.stack if batched else torch.cat
    return BlockResult(join(fed_all), cur_tok, cur_lp, done, sum_lp, join(logits_all))
