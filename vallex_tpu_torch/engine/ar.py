"""AR decode engine (port of vallex_tpu/engine/ar.py: ar_generate for one
request and its best_of samples, ar_generate_batch for batched requests and
theirs, and their host-side helpers).

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
max_gen = min(16·x_len, t_audio - prompt_len - 2, gen_limit). Sampling is
plain (top_k <= 0 or 1, top_p >= 1) or filtered (top-k then top-p,
ops/sampling.py): filtered draws take the first token from topk_sampling and
the later ones from the filtered epilogue, and speculate only when greedy
(the filters keep the argmax).

best_of = beams > 1 (reference models/vallex.py:525-527): the prefill runs
once and is shared by the samples; each sample decodes on its own, and the
pick is the best length-normalized logprob (`select_best`). On the kernel
path the samples run as the grouped rows of the batched decode: the prefix
K/V [NL, R, H, s_text + p_audio, hd] held once per request, the caches
holding only each sample's generated rows.

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
from ..ops.sampling import speculative_accept, topk_sampling

logger = logging.getLogger(__name__)

ABLK = 512  # the batched prompt bucket is a multiple of this many rows


class ARResult(NamedTuple):
    tokens: np.ndarray  # [t_audio + slack] best sample's buffer: BOS + prompt + generated
    gen_len: int  # frames generated (excluding EOS) by the best sample
    iterations: int  # decode-loop iterations (speculative: verify passes)
    accepted_drafts: int  # draft tokens the verify passes accepted
    best_beam: int = 0
    beam_tokens: Optional[np.ndarray] = None  # [beams, t_audio + slack] every sample
    scores: Optional[np.ndarray] = None  # [beams] length-normalized logprobs


def is_plain(top_k: int, top_p: float) -> bool:
    """No top-k / top-p filter: greedy (top_k == 1) or full categorical."""
    return (top_k <= 0 or top_k == 1) and top_p >= 1.0


def select_best(sum_logprobs: torch.Tensor, lengths: torch.Tensor,
                length_penalty: float):
    """The reference's pick among samples (vallex_tpu/engine/ar.py:824-832):
    score = sum_logprobs / lengths**length_penalty over the last dim, best =
    the first argmax. → (best, scores)."""
    scores = sum_logprobs / torch.pow(lengths.float(), length_penalty)
    return torch.argmax(scores, dim=-1), scores


def first_token(logits0: torch.Tensor, generator, *, vocab: int, top_k: int,
                top_p: float, temperature: float):
    """The token after the prompt and its logprob, from the prefill logits
    [B, VP] (lanes >= vocab at NEG_INF): the plain epilogue's pick, or
    topk_sampling for filtered sampling (the JAX package draws it in XLA,
    outside any kernel)."""
    greedy = top_k == 1
    if is_plain(top_k, top_p):
        u0 = None if greedy else torch.rand(logits0.shape, generator=generator,
                                            device=logits0.device)
        return sample_epilogue(logits0, u0, vocab=vocab, temperature=temperature,
                               greedy=greedy, site="ar_prefill")
    tok, lp = topk_sampling(generator, logits0, top_k, top_p, temperature)
    return tok.to(torch.int32), lp


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
    top_p: float = 1.0,
    beams: int = 1,
    length_penalty: float = 1.0,
) -> ARResult:
    """One request, `beams` samples of it. Kernel-path routing as in the
    JAX package (vallex_tpu/engine/ar.py:373-392): speculation (the
    caller's `speculative`) only for one sample of greedy or plain
    sampled decoding; otherwise K-step blocks on `packed` — one request's
    layout for one sample, the grouped rows for several."""
    dev = model.pe.device
    greedy = top_k == 1
    eos, vocab = cfg.eos_id, cfg.num_audio_tokens + 1
    kernels = decode_mode == "megakernel"
    K = decode_steps if kernels else 0
    C = s_text + t_audio
    grouped = kernels and beams > 1
    P = s_text + p_audio

    # ---- prefill over [text | BOS + prompt], once for all samples ---------
    y_init = torch.cat([
        torch.tensor([cfg.bos_id], device=dev),
        torch.as_tensor(prompt_audio, device=dev).long(),
    ])
    cache_k, cache_v, logits0 = prefill(
        model, cfg, torch.as_tensor(text_ids, device=dev)[None],
        torch.as_tensor(lang_ids, device=dev)[None], x_len, y_init[None], prompt_len,
        s_text=s_text, p_audio=p_audio, C=P if grouped else C + K, dtype=dtype)

    y_buf = torch.full((beams, t_audio + K), eos, dtype=torch.int64, device=dev)
    y_buf[:, :p_audio] = y_init
    max_gen = min(16 * x_len, t_audio - 1 - prompt_len - 1)
    if gen_limit is not None:
        max_gen = min(max_gen, int(gen_limit))

    if not kernels:
        cache_k, cache_v = (c.expand(-1, beams, -1, -1, -1).clone() for c in (cache_k, cache_v))
        sum_lp, step = _per_token_loop(
            model, cfg, logits0.expand(beams, -1), cache_k, cache_v, y_buf,
            generator=generator, top_k=top_k, top_p=top_p, temperature=temperature,
            x_len=x_len, prompt_len=prompt_len, s_text=s_text, max_gen=max_gen, dtype=dtype)
        iterations, accepted = step, 0
    else:
        VP = packed["wpred"].shape[0]
        logits0 = torch.cat(
            [logits0, torch.full((1, VP - logits0.shape[-1]), V.NEG_INF, device=dev)], dim=-1)
        cur_tok, cur_lp = first_token(logits0.repeat(beams, 1), generator, vocab=vocab,
                                      top_k=top_k, top_p=top_p, temperature=temperature)
        filt = {} if is_plain(top_k, top_p) else dict(top_k=top_k, top_p=top_p)
        if grouped:
            rows = lambda v: torch.full((beams,), v, dtype=torch.int32, device=dev)  # noqa: E731
            NL, _, H, _, hd = cache_k.shape
            gen = torch.zeros((NL, beams, H, t_audio + K, hd), dtype=dtype, device=dev)
            y_gen, sum_lp, iterations = _block_loop(
                cur_tok, cur_lp, packed, gen, gen.clone(), model.pe, (cache_k, cache_v),
                x_lens=rows(x_len), plens=rows(prompt_len), max_gen=rows(max_gen),
                beams=beams, s_text=s_text, p_audio=p_audio, t_gen=t_audio, K=K,
                temperature=temperature, vocab=vocab, eos=eos, greedy=greedy,
                generator=generator, filt=filt)
            n = t_audio + K - (prompt_len + 1)
            y_buf[:, prompt_len + 1:] = y_gen[:, :n]
            accepted = 0
        else:
            sum_lp, iterations, accepted = _kernel_loop(
                cfg, cur_tok, cur_lp, packed, packed_draft, cache_k[:, 0], cache_v[:, 0],
                y_buf[0], model.pe, generator=generator, greedy=greedy,
                temperature=temperature, x_len=x_len, prompt_len=prompt_len,
                s_text=s_text, max_gen=max_gen, K=K,
                speculative=speculative and (greedy or not filt), filt=filt)

    # ---- best sample (vallex_tpu/engine/ar.py:824-832) --------------------
    lengths = (y_buf != eos).sum(dim=1)
    best, scores = select_best(sum_lp, lengths, length_penalty)
    best = int(best)
    y = y_buf.cpu().numpy()
    gen_len = int((y[best] != eos).sum()) - (1 + prompt_len)
    return ARResult(y[best], gen_len, iterations, accepted, best, y,
                    scores.cpu().numpy())


def _per_token_loop(model, cfg, logits, cache_k, cache_v, y_buf, *,
                    generator, top_k, top_p, temperature, x_len, prompt_len,
                    s_text, max_gen, dtype):
    """The JAX package's `body` for B samples: sample (plain, or
    topk_sampling when filtered), bookkeeping, one decoder step per token
    in plain PyTorch. → (sum_logprobs [B], steps run)."""
    eos = cfg.eos_id
    dev = y_buf.device
    B, C = y_buf.shape[0], cache_k.shape[3]
    greedy, plain = top_k == 1, is_plain(top_k, top_p)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    sum_lp = torch.zeros((B,), dtype=torch.float32, device=dev)
    step = 0
    while step < max_gen and not bool(done.all()):
        if plain:
            u = None if greedy else torch.rand(logits.shape, generator=generator, device=dev)
            tok, lp = sample_epilogue_plain(
                logits, u, vocab=logits.shape[-1], temperature=temperature,
                greedy=greedy)
        else:
            tok, lp = topk_sampling(generator, logits, top_k, top_p, temperature)
        # samples already done keep emitting EOS; logprob only while alive
        tok = torch.where(done, eos, tok.long())
        sum_lp = sum_lp + torch.where(done, 0.0, lp)
        done = done | (tok == eos)
        audio_pos = prompt_len + 1 + step
        y_buf[:, audio_pos] = tok
        hh = V.ar_audio_input(model, tok[:, None], audio_pos, dtype)
        kv_mask = audio_kv_mask(C, s_text, x_len, audio_pos, dev)
        for li, layer in enumerate(model.ar_decoder.layers):
            hh = layer.decode_step(hh, cache_k[li], cache_v[li], s_text + audio_pos, kv_mask)
        hh = model.ar_decoder.norm(hh)
        logits = V.ar_logits(model, hh[:, 0])
        step += 1
    return sum_lp, step


def _kernel_loop(cfg, cur_tok, cur_lp, packed, draft, cache_k, cache_v, y_buf, pe, *,
                 generator, greedy, temperature, x_len, prompt_len, s_text,
                 max_gen, K, speculative, filt):
    """The megakernel path for one sample: speculative iterations (draft
    K-1 + verify K) or, with speculation off, K-step blocks (filtered
    epilogue when `filt` holds top_k / top_p). → (sum_logprobs [1],
    iterations, accepted drafts). Two host reads per iteration: the
    accepted count (it sets the commit) and the done flag."""
    eos, vocab = cfg.eos_id, cfg.num_audio_tokens + 1
    dev = y_buf.device
    VP = packed["wpred"].shape[0]
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
                eos=eos, stochastic=not greedy, generator=generator, **filt)
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
    return sum_lp, iterations, accepted


class BatchARResult(NamedTuple):
    y_gen: np.ndarray  # [R, t_gen + K] generated tokens (best sample), aligned at column 0
    gen_len: np.ndarray  # [R] frames before each request's first EOS, capped
    iterations: int  # K-step blocks run
    scores: Optional[np.ndarray] = None  # [R, beams] length-normalized logprobs


def _block_loop(cur_tok, cur_lp, packed, cache_k, cache_v, pe, prefix, *, x_lens, plens,
                max_gen, beams, s_text, p_audio, t_gen, K, temperature, vocab, eos,
                greedy, generator, filt):
    """K-step batched blocks over RB rows (R requests × beams samples,
    request-major) until every row is done or the longest cap is reached;
    one host read per block. `prefix` None: the batched layout; else the
    grouped one (caches hold generated rows only). → (y_gen [RB, t_gen + K],
    sum_logprobs [RB], blocks run)."""
    RB, dev = cur_tok.shape[0], cur_tok.device
    done = torch.zeros((RB,), dtype=torch.bool, device=dev)
    sum_lp = torch.zeros((RB,), dtype=torch.float32, device=dev)
    y_gen = torch.full((RB, t_gen + K), eos, dtype=torch.int64, device=dev)
    step, iterations, last = 0, 0, int(max_gen.max())
    while step < last:
        iterations += 1
        r = decode_block_fused(
            cur_tok, cur_lp, done, sum_lp, packed, cache_k, cache_v, pe,
            x_len=x_lens, audio_pos=step, remaining=max_gen - step,
            temperature=temperature, steps=K, s_text=s_text, vocab=vocab, eos=eos,
            stochastic=not greedy, generator=generator, prompt_len=plens,
            batched=True, p_audio=p_audio, prefix=prefix, beams=beams, **filt)
        y_gen[:, step: step + K] = r.fed.T.long()
        cur_tok, cur_lp, done, sum_lp = r.next_tok, r.next_logp, r.done, r.sum_logprobs
        step += K
        if bool(done.all()):
            break
    return y_gen, sum_lp, iterations


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
    packed: Dict,  # bf16, int8 (W8A16) or f32 decode weights
    beams: int = 1,
    top_p: float = 1.0,
    length_penalty: float = 1.0,
) -> BatchARResult:
    """R independent requests decoded together: every K-step block runs the
    batched decode_block_fused, so each step streams the weights once for
    all rows. Prefill runs once per request with per-request masks; each
    row's first token comes from its request's prefill logits; each row
    keeps its own EOS forcing, length cap max_gen = min(16·x_len, gen_cap,
    t_gen - 1) and logprob sum. beams > 1: R × beams request-major rows
    (row r·beams + b is request r's sample b) in the grouped layout, and
    each request keeps its best sample (`select_best`, lengths counting
    BOS + prompt + generated frames). One host read per block."""
    dev = model.pe.device
    R = text_ids.shape[0]
    RB = R * beams
    K = decode_steps
    if K < 2:
        raise ValueError("the batched decode runs K-step blocks (decode_steps >= 2)")
    eos, vocab = cfg.eos_id, cfg.num_audio_tokens + 1
    grouped = beams > 1
    P = s_text + p_audio
    x_lens_d = torch.as_tensor(np.asarray(x_lens, np.int32), device=dev)
    plens_d = torch.as_tensor(np.asarray(prompt_lens, np.int32), device=dev)
    y_init = torch.cat([
        torch.full((R, 1), cfg.bos_id, dtype=torch.int64, device=dev),
        torch.as_tensor(np.asarray(prompt_audio), device=dev).long(),
    ], dim=1)
    cache_k, cache_v, logits0 = prefill(
        model, cfg, torch.as_tensor(np.asarray(text_ids), device=dev),
        torch.as_tensor(np.asarray(lang_ids), device=dev), x_lens_d, y_init, plens_d,
        s_text=s_text, p_audio=p_audio, C=P if grouped else P + t_gen + K, dtype=dtype)
    prefix = None
    if grouped:
        prefix = (cache_k, cache_v)
        NL, _, H, _, hd = cache_k.shape
        cache_k = torch.zeros((NL, RB, H, t_gen + K, hd), dtype=dtype, device=dev)
        cache_v = torch.zeros_like(cache_k)
    rep = (lambda t: t.repeat_interleave(beams, dim=0)) if grouped else (lambda t: t)

    max_gen_np = np.minimum(np.minimum(16 * np.asarray(x_lens, np.int64),
                                       np.asarray(gen_caps, np.int64)), t_gen - 1)
    max_gen = rep(torch.as_tensor(max_gen_np, device=dev))
    VP = packed["wpred"].shape[0]
    logits0 = torch.cat(
        [logits0, torch.full((R, VP - logits0.shape[-1]), V.NEG_INF, device=dev)], dim=-1)
    cur_tok, cur_lp = first_token(rep(logits0), generator, vocab=vocab, top_k=top_k,
                                  top_p=top_p, temperature=temperature)
    filt = {} if is_plain(top_k, top_p) else dict(top_k=top_k, top_p=top_p)
    y_gen, sum_lp, iterations = _block_loop(
        cur_tok, cur_lp, packed, cache_k, cache_v, model.pe, prefix,
        x_lens=rep(x_lens_d), plens=rep(plens_d), max_gen=max_gen, beams=beams,
        s_text=s_text, p_audio=p_audio, t_gen=t_gen, K=K, temperature=temperature,
        vocab=vocab, eos=eos, greedy=top_k == 1, generator=generator, filt=filt)
    # frames before each row's first EOS, clipped to its length cap
    alive = torch.cumprod((y_gen[:, :t_gen] != eos).to(torch.int32), dim=1)
    gen_len = torch.minimum(alive.sum(dim=1), max_gen)
    # each request's best sample (lengths: BOS + prompt + generated frames)
    best, scores = select_best(sum_lp.view(R, beams),
                               (1 + rep(plens_d) + gen_len).view(R, beams), length_penalty)
    rows = torch.arange(R, device=dev) * beams + best
    return BatchARResult(y_gen[rows].cpu().numpy(), gen_len[rows].cpu().numpy(),
                         iterations, scores.cpu().numpy())
