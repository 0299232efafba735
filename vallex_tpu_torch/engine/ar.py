"""AR decode engine (port of vallex_tpu/engine/ar.py: ar_generate at B = 1,
ar_generate_batch for batched requests, and their host-side helpers).

Single-request buffer layout ("slot" = index into the cache of length
C = s_text + t_audio plus K slack rows):
  slots [0, s_text)            text (valid prefix x_len, padding masked)
  slots [s_text, s_text + T)   audio; slot s_text + j holds audio position j
                               (0 = BOS, 1..prompt_len the prompt, then the
                               generated frames).

Decode modes:
  "megakernel" — the TPU megakernel path: speculative decoding (int8 draft of
      K-1 frames through ops/decode_block.py, one bf16 verify pass through
      ops/decode_verify.py, then greedy prefix matching or
      ops/sampling.py::speculative_accept), or K-step blocks when
      speculation is off (and with int8 serving weights, the JAX package's
      `body_block`). Runs on the hand-written kernels on the card.
  "xla" — the per-token loop (`body`) in plain PyTorch: the CPU path and
      the oracle for the kernel path.
  "auto" — "megakernel" on CUDA, "xla" on the CPU (the JAX package's rule).

Semantics kept from the reference: EOS forcing (a done sequence keeps
emitting EOS), logprob accumulation only while alive, stop at EOS or at
max_gen = min(16·x_len, t_audio - prompt_len - 2, gen_limit).

Batched layout (ar_generate_batch, as in the JAX package): text [0, s_text)
| BOS + prompt bucket [s_text, s_text + p_audio) | generated frame t at
the fixed row s_text + p_audio + t for every request; request r's frame t
has audio position prompt_len[r] + 1 + t. The batched decode always runs
ops/decode_block.py (kernels on CUDA, their plain versions on the CPU).
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

ABLK = 512  # the batched prompt bucket is a multiple of this many rows


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


def single_request_gen_caps(prompt_lens, x_lens, audio_buckets) -> np.ndarray:
    """Per-request generation caps replicating the single-request bucket
    math (max_gen = min(16·x_len, t_audio - prompt_len - 2) with t_audio
    from `bucket`): a batched request stops at exactly the length cap it
    would hit alone."""
    return np.asarray([
        max(0, bucket(
            min(int(pl_) + 1 + 16 * int(xl) + 1, audio_buckets[-1]),
            audio_buckets, granularity=512,
        ) - int(pl_) - 2)
        for pl_, xl in zip(prompt_lens, x_lens)
    ], np.int32)


def pad_batched_requests(requests, eos_id, num_quantizers,
                         text_buckets, audio_buckets) -> Dict:
    """Host-side padding and bucketing for the batched engine.

    requests: list of (text_ids [S], lang_ids [S], prompt) with prompt
    None, a [Tp] codebook-0 array, or a [Tp, 8] full-code array.
    → dict with the bucket dims (s_text, p_audio % ABLK == 0, t_gen), the
    padded arrays (text, lang, x_lens, prompt_pad [R, p_audio-1] EOS-padded
    cb0, prompts as [Tp, 8] arrays, prompt_lens) and the per-request
    generation caps (single_request_gen_caps)."""
    R = len(requests)
    if R == 0:
        raise ValueError("batched synthesis needs at least one request")
    S_max = max(len(t) for t, _, _ in requests)
    s_text = bucket(S_max, text_buckets)
    prompts = []
    for _, _, pr in requests:
        if pr is None:
            prompts.append(np.zeros((0, num_quantizers), np.int32))
        else:
            pr = np.asarray(pr, np.int32)
            prompts.append(pr[:, None].repeat(num_quantizers, 1)
                           if pr.ndim == 1 else pr)
    Tp_max = max(len(p) for p in prompts)
    validate_prompt_len(Tp_max, audio_buckets)
    p_audio = -(-(Tp_max + 1) // ABLK) * ABLK
    t_gen = bucket(min(16 * S_max + 1, audio_buckets[-1]), audio_buckets,
                   granularity=512)
    text = np.zeros((R, s_text), np.int32)
    lang = np.zeros((R, s_text), np.int32)
    x_lens = np.zeros((R,), np.int32)
    # EOS-pad the cb0 prompt slots: unwritten pad slots must not count as
    # generated frames
    prompt_pad = np.full((R, p_audio - 1), eos_id, np.int32)
    prompt_lens = np.zeros((R,), np.int32)
    for r, (t, lg, _) in enumerate(requests):
        text[r, : len(t)] = t
        lang[r, : len(lg)] = lg
        x_lens[r] = len(t)
        pr = prompts[r]
        if len(pr):
            prompt_pad[r, : len(pr)] = pr[:, 0]
            prompt_lens[r] = len(pr)
    caps = single_request_gen_caps(prompt_lens, x_lens, audio_buckets)
    return dict(
        s_text=s_text, p_audio=p_audio, t_gen=t_gen,
        text=text, lang=lang, x_lens=x_lens,
        prompt_pad=prompt_pad, prompt_lens=prompt_lens,
        prompts=prompts, caps=caps,
    )


def prefill_mask(s_text: int, p_audio: int, x_len, prompt_len,
                 device=None) -> torch.Tensor:
    """Additive [R, 1, P, P] mask over [text | BOS + prompt], P = s_text +
    p_audio: text columns < x_len visible to all rows, audio columns causal,
    padded columns masked for every row. x_len / prompt_len are ints (R = 1)
    or [R] tensors (one mask per request)."""
    P = s_text + p_audio
    rows = torch.arange(P, device=device)[:, None]
    cols = torch.arange(P, device=device)[None, :]
    if isinstance(x_len, torch.Tensor):
        x_len, prompt_len = x_len[:, None, None], prompt_len[:, None, None]
    col_is_text = cols < s_text
    col_valid = torch.where(col_is_text, cols < x_len, (cols - s_text) <= prompt_len)
    causal_ok = col_is_text | ((cols - s_text) <= torch.clamp(rows - s_text, min=0))
    ok = col_valid & causal_ok
    return torch.where(ok, 0.0, V.NEG_INF).reshape(-1, 1, P, P)


def audio_kv_mask(total: int, s_text: int, x_len: int, audio_pos: int,
                  device=None) -> torch.Tensor:
    """Additive [1, 1, 1, C] mask for a decode step at audio_pos."""
    cols = torch.arange(total, device=device)
    ok = (cols < x_len) | ((cols >= s_text) & (cols - s_text <= audio_pos))
    return torch.where(ok, 0.0, V.NEG_INF)[None, None, None, :]


def prefill(model: V.VALLE, cfg: ModelConfig, text: torch.Tensor, lang: torch.Tensor,
            x_len, y_init: torch.Tensor, prompt_len, *, s_text: int, p_audio: int,
            C: int, dtype: torch.dtype):
    """One forward over [text | BOS + prompt] for R requests (text/lang
    [R, s_text], y_init [R, p_audio] BOS + EOS-padded cb0 prompt; x_len /
    prompt_len ints for R = 1 or [R] tensors) → (cache_k, cache_v
    [NL, R, H, C, hd] with the prefix rows filled, logits0 [R, 1025] f32 at
    each request's last prompt position)."""
    R, dev = text.shape[0], text.device
    NL, H, hd = cfg.num_layers, cfg.num_heads, cfg.head_dim
    x = V.text_input(model, text.long(), lang.long(), "ar", dtype)
    h = torch.cat([x, V.ar_audio_input(model, y_init.long(), 0, dtype)], dim=1)
    mask = prefill_mask(s_text, p_audio, x_len, prompt_len, dev)
    P = s_text + p_audio
    cache_k = torch.zeros((NL, R, H, C, hd), dtype=dtype, device=dev)
    cache_v = torch.zeros_like(cache_k)
    for li, layer in enumerate(model.ar_decoder.layers):
        h, k, v = layer.prefill(h, mask)
        cache_k[li, :, :, :P] = k
        cache_v[li, :, :, :P] = v
    h = model.ar_decoder.norm(h)
    if isinstance(prompt_len, int):
        return cache_k, cache_v, V.ar_logits(model, h[0, s_text + prompt_len])[None]
    last = h[torch.arange(R, device=dev), s_text + prompt_len.long()]
    return cache_k, cache_v, V.ar_logits(model, last)


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
    eos = cfg.eos_id
    kernels = decode_mode == "megakernel"
    K = decode_steps if kernels else 0
    C = s_text + t_audio

    # ---- prefill over [text | BOS + prompt] ------------------------------
    y_init = torch.cat([
        torch.tensor([cfg.bos_id], device=dev),
        torch.as_tensor(prompt_audio, device=dev).long(),
    ])
    cache_k, cache_v, logits0 = prefill(
        model, cfg, torch.as_tensor(text_ids, device=dev)[None],
        torch.as_tensor(lang_ids, device=dev)[None], x_len, y_init[None], prompt_len,
        s_text=s_text, p_audio=p_audio, C=C + K, dtype=dtype)
    cache_k, cache_v = cache_k[:, 0], cache_v[:, 0]  # [NL, H, C + K, hd]

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


class BatchARResult(NamedTuple):
    y_gen: np.ndarray  # [R, t_gen + K] generated tokens, aligned at column 0
    gen_len: np.ndarray  # [R] frames before each request's first EOS, capped
    iterations: int  # K-step blocks run


def ar_generate_batch(
    model: V.VALLE,
    cfg: ModelConfig,
    text_ids: np.ndarray,  # [R, s_text] padded
    lang_ids: np.ndarray,  # [R, s_text]
    x_lens: np.ndarray,  # [R] valid text lengths
    prompt_audio: np.ndarray,  # [R, p_audio - 1] cb0 prompts, EOS-padded
    prompt_lens: np.ndarray,  # [R] valid prompt frames
    gen_caps: np.ndarray,  # [R] per-request cap (single_request_gen_caps)
    *,
    generator: torch.Generator,
    top_k: int,
    temperature: float,
    s_text: int,
    p_audio: int,  # BOS + prompt bucket, % ABLK == 0
    t_gen: int,  # generated-frames capacity
    dtype: torch.dtype,
    decode_steps: int,
    packed: Dict,  # bf16 or int8 (W8A16) decode weights
    beams: int = 1,
) -> BatchARResult:
    """R independent requests decoded together: every K-step block runs the
    batched decode_block_fused, so each step streams the weights once for
    all R rows. Prefill runs once with per-request masks; each request's
    first token comes from its own prefill logits; each row keeps its own
    EOS forcing, length cap max_gen = min(16·x_len, gen_cap, t_gen - 1) and
    logprob sum. One host read per block (all rows done?)."""
    if beams != 1:
        raise NotImplementedError(
            "best_of > 1 on the batched path (beams, the grouped shared-prefix"
            " layout) is not ported yet: ROADMAP.md §2 item 1 (slices 3-4)")
    dev = model.pe.device
    R = text_ids.shape[0]
    K = decode_steps
    if K < 2:
        raise ValueError("the batched decode runs K-step blocks (decode_steps >= 2)")
    eos, vocab = cfg.eos_id, cfg.num_audio_tokens + 1
    greedy = top_k == 1
    s_gen = s_text + p_audio
    C = s_gen + t_gen + K
    x_lens_d = torch.as_tensor(np.asarray(x_lens, np.int32), device=dev)
    plens_d = torch.as_tensor(np.asarray(prompt_lens, np.int32), device=dev)
    y_init = torch.cat([
        torch.full((R, 1), cfg.bos_id, dtype=torch.int64, device=dev),
        torch.as_tensor(np.asarray(prompt_audio), device=dev).long(),
    ], dim=1)
    cache_k, cache_v, logits0 = prefill(
        model, cfg, torch.as_tensor(np.asarray(text_ids), device=dev),
        torch.as_tensor(np.asarray(lang_ids), device=dev), x_lens_d, y_init, plens_d,
        s_text=s_text, p_audio=p_audio, C=C, dtype=dtype)

    max_gen_np = np.minimum(np.minimum(16 * np.asarray(x_lens, np.int64),
                                       np.asarray(gen_caps, np.int64)), t_gen - 1)
    max_gen = torch.as_tensor(max_gen_np, device=dev)
    VP = packed["wpred"].shape[0]
    logits0 = torch.cat(
        [logits0, torch.full((R, VP - logits0.shape[-1]), V.NEG_INF, device=dev)], dim=-1)
    u0 = None if greedy else torch.rand(logits0.shape, generator=generator, device=dev)
    cur_tok, cur_lp = sample_epilogue(logits0, u0, vocab=vocab, temperature=temperature,
                                      greedy=greedy, site="ar_prefill")
    done = torch.zeros((R,), dtype=torch.bool, device=dev)
    sum_lp = torch.zeros((R,), dtype=torch.float32, device=dev)
    y_gen = torch.full((R, t_gen + K), eos, dtype=torch.int64, device=dev)
    step, iterations, last = 0, 0, int(max_gen_np.max())
    while step < last:
        iterations += 1
        r = decode_block_fused(
            cur_tok, cur_lp, done, sum_lp, packed, cache_k, cache_v, model.pe,
            x_len=x_lens_d, audio_pos=step, remaining=max_gen - step,
            temperature=temperature, steps=K, s_text=s_text, vocab=vocab, eos=eos,
            stochastic=not greedy, generator=generator, prompt_len=plens_d,
            batched=True, p_audio=p_audio)
        y_gen[:, step: step + K] = r.fed.T.long()
        cur_tok, cur_lp, done, sum_lp = r.next_tok, r.next_logp, r.done, r.sum_logprobs
        step += K
        if bool(done.all()):
            break
    # frames before each row's first EOS, clipped to its length cap
    alive = torch.cumprod((y_gen[:, :t_gen] != eos).to(torch.int32), dim=1)
    gen_len = torch.minimum(alive.sum(dim=1), max_gen)
    return BatchARResult(y_gen.cpu().numpy(), gen_len.cpu().numpy(), iterations)
