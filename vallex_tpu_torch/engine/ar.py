"""AR decode engine (port of vallex_tpu/engine/ar.py::ar_generate at B = 1).

Buffer layout ("slot" = index into the cache of length C = s_text + t_audio
plus K slack rows):
  slots [0, s_text)            text (valid prefix x_len, padding masked)
  slots [s_text, s_text + T)   audio; slot s_text + j holds audio position j
                               (0 = BOS, 1..prompt_len the prompt, then the
                               generated frames).

Decode modes:
  "megakernel" — the TPU megakernel path: speculative decoding (int8 draft of
      K-1 frames through ops/decode_block.py, one bf16 verify pass through
      ops/decode_verify.py, then greedy prefix matching or
      ops/sampling.py::speculative_accept), or K-step blocks when
      speculation is off. Runs on the hand-written kernels on the card.
  "xla" — the per-token loop (`body`) in plain PyTorch: the CPU path and
      the oracle for the kernel path.
  "auto" — "megakernel" on CUDA, "xla" on the CPU (the JAX package's rule).

Semantics kept from the reference: EOS forcing (a done sequence keeps
emitting EOS), logprob accumulation only while alive, stop at EOS or at
max_gen = min(16·x_len, t_audio - prompt_len - 2, gen_limit).
"""

from __future__ import annotations

import logging
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..kernels import sample_epilogue, sample_epilogue_plain
from ..models import vallex as V
from ..ops.decode_block import decode_block_fused
from ..ops.decode_verify import decode_verify
from ..ops.sampling import speculative_accept

logger = logging.getLogger(__name__)


class ARResult(NamedTuple):
    tokens: np.ndarray  # [t_audio + slack] audio buffer: BOS + prompt + generated
    gen_len: int  # frames generated (excluding EOS)
    iterations: int  # decode-loop iterations (speculative: verify passes)
    accepted_drafts: int  # draft tokens the verify passes accepted


def bucket(n: int, buckets, granularity: int = 128) -> int:
    """Smallest configured bucket ≥ n; past the largest, the next multiple
    of `granularity`."""
    for b in buckets:
        if n <= b:
            return b
    ext = ((n + granularity - 1) // granularity) * granularity
    logger.warning("length %d exceeds largest bucket %d; extending to %d",
                   n, buckets[-1], ext)
    return ext


def validate_prompt_len(Tp: int, audio_buckets) -> None:
    """A voice prompt must leave room to generate inside the largest audio
    bucket (BOS + prompt + ≥ 1 frame + EOS slot)."""
    limit = audio_buckets[-1] - 2
    if Tp > limit:
        raise ValueError(
            f"voice prompt is {Tp} frames (~{Tp / 75.0:.1f} s); the largest"
            f" configured audio bucket ({audio_buckets[-1]}) supports prompts"
            f" up to {limit} frames")


def prefill_mask(s_text: int, p_audio: int, x_len: int, prompt_len: int,
                 device=None) -> torch.Tensor:
    """Additive [1, 1, P, P] mask over [text | BOS + prompt], P = s_text +
    p_audio: text columns < x_len visible to all rows, audio columns causal,
    padded columns masked for every row."""
    P = s_text + p_audio
    rows = torch.arange(P, device=device)[:, None]
    cols = torch.arange(P, device=device)[None, :]
    col_is_text = cols < s_text
    col_valid = torch.where(col_is_text, cols < x_len, (cols - s_text) <= prompt_len)
    causal_ok = col_is_text | ((cols - s_text) <= torch.clamp(rows - s_text, min=0))
    ok = col_valid & causal_ok
    return torch.where(ok, 0.0, V.NEG_INF)[None, None]


def audio_kv_mask(total: int, s_text: int, x_len: int, audio_pos: int,
                  device=None) -> torch.Tensor:
    """Additive [1, 1, 1, C] mask for a decode step at audio_pos."""
    cols = torch.arange(total, device=device)
    ok = (cols < x_len) | ((cols >= s_text) & (cols - s_text <= audio_pos))
    return torch.where(ok, 0.0, V.NEG_INF)[None, None, None, :]


def ar_generate(
    model: V.VALLE,
    cfg: ModelConfig,
    text_ids: np.ndarray,  # [s_text] padded
    lang_ids: np.ndarray,  # [s_text]
    x_len: int,
    prompt_audio: np.ndarray,  # [p_audio - 1] codebook-0 prompt, EOS-padded
    prompt_len: int,
    *,
    generator: torch.Generator,
    top_k: int,
    temperature: float,
    gen_limit: Optional[int],
    s_text: int,
    p_audio: int,
    t_audio: int,
    dtype: torch.dtype,
    decode_mode: str,
    decode_steps: int,
    speculative: bool,
    packed: Optional[Dict] = None,
    packed_draft: Optional[Dict] = None,
) -> ARResult:
    dev = model.pe.device
    greedy = top_k == 1
    NL, H, hd = cfg.num_layers, cfg.num_heads, cfg.head_dim
    eos = cfg.eos_id
    kernels = decode_mode == "megakernel"
    K = decode_steps if kernels else 0
    C = s_text + t_audio

    # ---- prefill over [text | BOS + prompt] ------------------------------
    text = torch.as_tensor(text_ids, device=dev).long()[None]
    lang = torch.as_tensor(lang_ids, device=dev).long()[None]
    y_init = torch.cat([
        torch.tensor([cfg.bos_id], device=dev),
        torch.as_tensor(prompt_audio, device=dev).long(),
    ])
    x = V.text_input(model, text, lang, "ar", dtype)
    y_emb = V.ar_audio_input(model, y_init[None], 0, dtype)
    h = torch.cat([x, y_emb], dim=1)
    mask = prefill_mask(s_text, p_audio, x_len, prompt_len, dev)
    P = s_text + p_audio
    cache_k = torch.zeros((NL, H, C + K, hd), dtype=dtype, device=dev)
    cache_v = torch.zeros_like(cache_k)
    for li, layer in enumerate(model.ar_decoder.layers):
        h, k, v = layer.prefill(h, mask)
        cache_k[li, :, :P] = k[0]
        cache_v[li, :, :P] = v[0]
    h = model.ar_decoder.norm(h)
    logits0 = V.ar_logits(model, h[0, s_text + prompt_len])[None]  # [1, 1025]

    y_buf = torch.full((t_audio + K,), eos, dtype=torch.int64, device=dev)
    y_buf[:p_audio] = y_init
    max_gen = min(16 * x_len, t_audio - 1 - prompt_len - 1)
    if gen_limit is not None:
        max_gen = min(max_gen, int(gen_limit))

    if not kernels:
        step = _per_token_loop(model, cfg, logits0, cache_k, cache_v, y_buf,
                               generator=generator, greedy=greedy,
                               temperature=temperature, x_len=x_len,
                               prompt_len=prompt_len, s_text=s_text,
                               max_gen=max_gen, dtype=dtype)
        iterations, accepted = step, 0
    else:
        iterations, accepted = _kernel_loop(
            cfg, logits0, packed, packed_draft, cache_k, cache_v, y_buf,
            model.pe, generator=generator, greedy=greedy,
            temperature=temperature, x_len=x_len, prompt_len=prompt_len,
            s_text=s_text, max_gen=max_gen, K=K, speculative=speculative,
        )
    y = y_buf.cpu().numpy()
    gen_len = int((y != eos).sum()) - (1 + prompt_len)
    return ARResult(y, gen_len, iterations, accepted)


def _per_token_loop(model, cfg, logits, cache_k, cache_v, y_buf, *,
                    generator, greedy, temperature, x_len, prompt_len,
                    s_text, max_gen, dtype) -> int:
    """The JAX package's `body`: sample, bookkeeping, one decoder step per
    token in plain PyTorch. Returns the number of steps run."""
    eos = cfg.eos_id
    dev = y_buf.device
    C = cache_k.shape[2]
    done, step = False, 0
    while not done and step < max_gen:
        u = None if greedy else torch.rand(logits.shape, generator=generator, device=dev)
        tok, _ = sample_epilogue_plain(
            logits, u, vocab=logits.shape[-1], temperature=temperature,
            greedy=greedy)
        token = int(tok[0])
        done = token == eos
        audio_pos = prompt_len + 1 + step
        y_buf[audio_pos] = token
        hh = V.ar_audio_input(
            model, torch.tensor([[token]], device=dev), audio_pos, dtype)
        kv_mask = audio_kv_mask(C, s_text, x_len, audio_pos, dev)
        for li, layer in enumerate(model.ar_decoder.layers):
            hh = layer.decode_step(hh, cache_k[li][None], cache_v[li][None],
                                   s_text + audio_pos, kv_mask)
        hh = model.ar_decoder.norm(hh)
        logits = V.ar_logits(model, hh[:, 0])
        step += 1
    return step


def _kernel_loop(cfg, logits0, packed, draft, cache_k, cache_v, y_buf, pe, *,
                 generator, greedy, temperature, x_len, prompt_len, s_text,
                 max_gen, K, speculative):
    """The megakernel path: speculative iterations (draft K-1 + verify K)
    or, with speculation off, K-step blocks. → (iterations, accepted
    drafts). Two host reads per iteration: the accepted count (it sets the
    commit) and the done flag."""
    eos, vocab = cfg.eos_id, cfg.num_audio_tokens + 1
    dev = y_buf.device
    VP = packed["wpred"].shape[0]
    logits0 = torch.cat(
        [logits0, torch.full((1, VP - logits0.shape[-1]), V.NEG_INF, device=dev)], dim=-1)
    u0 = None if greedy else torch.rand(logits0.shape, generator=generator, device=dev)
    cur_tok, cur_lp = sample_epilogue(logits0, u0, vocab=vocab,
                                      temperature=temperature, greedy=greedy,
                                      site="ar_prefill")
    done = torch.zeros((1,), dtype=torch.bool, device=dev)
    sum_lp = torch.zeros((1,), dtype=torch.float32, device=dev)
    zeros_lp = torch.zeros((1,), dtype=torch.float32, device=dev)
    step, iterations, accepted = 0, 0, 0
    lanes = torch.arange(VP, device=dev)
    j = torch.arange(K, device=dev)
    while step < max_gen:
        iterations += 1
        audio_pos = prompt_len + 1 + step
        if not speculative:
            r = decode_block_fused(
                cur_tok, cur_lp, done, sum_lp, packed, cache_k, cache_v, pe,
                x_len=x_len, audio_pos=audio_pos, remaining=max_gen - step,
                temperature=temperature, steps=K, s_text=s_text, vocab=vocab,
                eos=eos, stochastic=not greedy, generator=generator)
            y_buf[audio_pos: audio_pos + K] = r.fed.long()
            cur_tok, cur_lp, done, sum_lp = r.next_tok, r.next_logp, r.done, r.sum_logprobs
            step += K
            if bool(done):
                break
            continue
        # --- draft: K-1 int8 steps (bookkeeping-neutral) -----------------
        r = decode_block_fused(
            cur_tok, zeros_lp, torch.zeros_like(done), zeros_lp, draft,
            cache_k, cache_v, pe, x_len=x_len, audio_pos=audio_pos,
            remaining=2 ** 30, temperature=temperature, steps=K - 1,
            s_text=s_text, vocab=vocab, eos=eos, stochastic=not greedy,
            generator=generator)
        fed = torch.cat([r.fed, r.next_tok])  # [K]
        # --- verify: one bf16 pass over the K positions -------------------
        logits_k = decode_verify(fed, packed, cache_k, cache_v, pe, x_len=x_len,
                                 audio_pos=audio_pos, s_text=s_text)
        if greedy:
            # argmax of the masked verify logits and its scaled logprob
            emit, lp = sample_epilogue(logits_k, None, vocab=vocab,
                                       temperature=temperature, greedy=True,
                                       site="decode_verify")
            m = torch.cumprod((fed[1:] == emit[:-1]).to(torch.int32), 0).sum()
        else:
            masked_p = torch.where(lanes < vocab, logits_k, V.NEG_INF)
            masked_q = torch.where(lanes < vocab, r.step_logits, V.NEG_INF)
            emit, lp, m = speculative_accept(fed[1:], masked_q, masked_p,
                                             temperature, generator)
        m = int(m)
        commit = min(m + 1, max(max_gen - step, 1))
        accepted += m
        # --- commit: the per-token bookkeeping over the executed window ---
        t = torch.cat([cur_tok.long(), emit[:-1].long()])  # fed token, step j
        lp_t = torch.cat([cur_lp, lp[:-1]])
        executed = j < commit
        is_eos = (t == eos).to(torch.int32)
        done_j = done | ((torch.cumsum(is_eos, 0) - is_eos) > 0)
        fed_j = torch.where(done_j, eos, t)
        alive = ~done_j & executed
        sum_lp = sum_lp + (lp_t * alive).sum()
        done = done | ((fed_j == eos) & executed).any()
        y_buf[audio_pos: audio_pos + K] = torch.where(executed, fed_j, eos)
        cur_tok = emit[commit - 1: commit].to(torch.int32)
        cur_lp = lp[commit - 1: commit]
        step += commit
        if bool(done):
            break
    return iterations, accepted
