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
      speculation is off (and with quantized serving weights, the JAX
      package's `body_block`). With decode_steps=1 the single-step ops of
      ops/decode_step.py: decode_step_fused (token in, token out) for plain
      sampling (`body_fused`), decode_step + topk_sampling for filtered
      sampling (`body`). Runs on the hand-written kernels on the card.
  "pallas" — the per-token loop with the model's own products and
      ops/decode_attention.py per layer (the JAX package's `body` with
      decode_mode="pallas"; `quantize` has no effect, as there).
  "xla" — the per-token loop (`body`) in plain PyTorch: the CPU path and
      the oracle for the kernel path.
  "auto" — "megakernel" on CUDA, "xla" on the CPU (the JAX package's rule).

Quantized serving (`quantize`, the weights come quantized in `packed`):
"int8" W8A16 products; "w8a8" W8A8 products (head W8A16) in every kernel
route; "int8kv" int8 weights plus an int8 KV cache with static
per-(layer, head) scales (`kv_int8_scales`) on the K-step block routes:
one request's blocks (single sample or grouped samples) and every batched
decode; with decode_steps=1 it runs as "int8" (vallex_tpu/engine/ar.py:
437-445, :985-1012).

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
has audio position prompt_len[r] + 1 + t. The batched decode runs its AR
architecture's block (`ar_arch`: ops/decode_block.py for VALL-E X,
ops/decode_hybrid.py for the hybrid AR; kernels on CUDA, their plain
versions on the CPU).
"""

from __future__ import annotations

import collections
import logging
import time
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..config import EngineConfig, ModelConfig
from ..kernels import loader, sample_epilogue, sample_epilogue_plain
from ..models import granite_hybrid as GH
from ..models import vallex as V
from ..ops.decode_attention import decode_attention
from ..ops.decode_block import decode_block_fused
from ..ops.decode_hybrid import decode_block_hybrid, pack_hybrid_weights
from ..ops.decode_step import decode_step, decode_step_fused, pack_layer_weights, quantize_weights
from ..ops.decode_verify import decode_verify, embed
from ..ops.sampling import speculative_accept, topk_sampling
from ..utils.profiling import DeviceSpan

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


def sampler(generator, *, vocab: int, top_k: int, top_p: float, temperature: float,
            epilogue=sample_epilogue_plain):
    """logits [B, V] (lanes >= vocab at NEG_INF) → (tokens [B] int32,
    logprobs [B]): the plain epilogue (argmax when greedy, else
    Gumbel-argmax with uniforms from `generator`), or topk_sampling for
    filtered sampling (the JAX package's `sample`)."""
    greedy = top_k == 1

    def sample(logits):
        if is_plain(top_k, top_p):
            u = None if greedy else torch.rand(logits.shape, generator=generator,
                                               device=logits.device)
            return epilogue(logits, u, vocab=vocab, temperature=temperature, greedy=greedy)
        tok, lp = topk_sampling(generator, logits, top_k, top_p, temperature)
        return tok.to(torch.int32), lp
    return sample


def first_token(logits0: torch.Tensor, generator, *, vocab: int, top_k: int,
                top_p: float, temperature: float):
    """The token after the prompt and its logprob, from the prefill logits
    [B, VP] (lanes >= vocab at NEG_INF): the plain epilogue's kernel, or
    topk_sampling for filtered sampling (the JAX package draws it in XLA,
    outside any kernel)."""
    def epilogue(*a, **kw):
        return sample_epilogue(*a, site="ar_prefill", **kw)
    return sampler(generator, vocab=vocab, top_k=top_k, top_p=top_p,
                   temperature=temperature, epilogue=epilogue)(logits0)


def kv_int8_scales(cache: torch.Tensor, margin: float = 1.2) -> torch.Tensor:
    """Static per-(layer, head) int8 scales of a KV cache [NL, B, H, C, hd]
    → [NL, H] f32: max(max |x|, 1e-6) · margin / 127, the maximum taken
    over every row, every lane and every one of the B rows of the batch
    (vallex_tpu/engine/ar.py::_kv_int8_scales). So the scales are
    batch-wide: a batch of requests (or the grouped prefix of all of them)
    shares one scale per (layer, head), as in the JAX package; a
    per-request maximum would give other codes. Taken from the prefilled
    rows (padding rows included, as there); the margin leaves headroom
    for generated rows, which the kernel clips to ±127."""
    m = cache.abs().amax(dim=(1, 3, 4)).float()
    return m.clamp_min(1e-6) * (margin / 127.0)


def kv_int8_quantize(cache: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """clip(round_half_even(cache / scale), ±127) as int8, per (layer,
    head) scale [NL, H] (vallex_tpu/engine/ar.py::_kv_int8_quantize); one
    layer at a time, so the f32 temporary stays one layer's size."""
    out = torch.empty(cache.shape, dtype=torch.int8, device=cache.device)
    for li in range(cache.shape[0]):
        q = torch.round(cache[li].float() / scales[li][None, :, None, None])
        out[li] = torch.clamp(q, -127.0, 127.0)
    return out


def int8_caches(cache_k: torch.Tensor, cache_v: torch.Tensor):
    """Quantize prefilled K/V caches → (cache_k, cache_v int8, (ks, vs)
    [NL, H] f32 each)."""
    ks, vs = kv_int8_scales(cache_k), kv_int8_scales(cache_v)
    return kv_int8_quantize(cache_k, ks), kv_int8_quantize(cache_v, vs), (ks, vs)


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
    quantize: str = "none",
) -> ARResult:
    """One request, `beams` samples of it. Kernel-path routing as in the
    JAX package (vallex_tpu/engine/ar.py:373-392, :431-445, :808-822):
    with decode_steps > 1, speculation (the caller's `speculative`) only
    for one sample of greedy or plain sampled decoding, otherwise K-step
    blocks on `packed` — one request's layout for one sample, the grouped
    rows for several; with decode_steps = 1 the single-step ops, every
    sample a row of its own cache. `quantize` names how `packed` was
    prepared: "w8a8" runs its products as W8A8, "int8kv" adds the int8
    KV cache to the K-step blocks."""
    dev = model.pe.device
    greedy = top_k == 1
    eos, vocab = cfg.eos_id, cfg.num_audio_tokens + 1
    kernels = decode_mode == "megakernel"
    K = decode_steps if kernels and decode_steps > 1 else 0  # K-step blocks
    act_quant = kernels and quantize == "w8a8"
    kv_int8 = K > 1 and quantize == "int8kv"
    C = s_text + t_audio
    grouped = K > 1 and beams > 1
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
    kv_scales = None
    if kv_int8:  # the grouped prefix, or the single request's cache
        cache_k, cache_v, kv_scales = int8_caches(cache_k, cache_v)

    y_buf = torch.full((beams, t_audio + K), eos, dtype=torch.int64, device=dev)
    y_buf[:, :p_audio] = y_init
    max_gen = min(16 * x_len, t_audio - 1 - prompt_len - 1)
    if gen_limit is not None:
        max_gen = min(max_gen, int(gen_limit))
    filt = {} if is_plain(top_k, top_p) else dict(top_k=top_k, top_p=top_p)
    samp = dict(vocab=vocab, top_k=top_k, top_p=top_p, temperature=temperature)

    if K == 0:
        # ---- per-token routes: every sample a row of its own cache ---------
        cache_k, cache_v = (c.expand(-1, beams, -1, -1, -1).clone() for c in (cache_k, cache_v))
        step_kw = dict(x_len=x_len, s_text=s_text)
        if not kernels:
            sample = sampler(generator, **samp)
            forward = _pallas_forward if decode_mode == "pallas" else _xla_forward

            def advance(tok, audio_pos):
                return sample(forward(model, tok, audio_pos, cache_k, cache_v,
                                      dtype=dtype, **step_kw))
        elif not filt:
            # plain sampling: decode_step_fused (`body_fused`)
            def advance(tok, audio_pos):
                return decode_step_fused(
                    tok, packed, cache_k, cache_v, model.pe, audio_pos=audio_pos,
                    vocab=vocab, temperature=temperature, greedy=greedy,
                    generator=generator, act_quant=act_quant, **step_kw)
        else:
            # filtered sampling: decode_step's logits, then topk_sampling
            sample = sampler(generator, **samp)
            lanes = torch.arange(packed["wpred"].shape[0], device=dev)

            def advance(tok, audio_pos):
                logits = decode_step(embed(tok, packed, model.pe[audio_pos]), packed, cache_k,
                                     cache_v, audio_pos=audio_pos, act_quant=act_quant,
                                     **step_kw)
                return sample(torch.where(lanes < vocab, logits, V.NEG_INF))
        if kernels:
            logits0 = _pad_logits(logits0, packed["wpred"].shape[0])
            cur_tok, cur_lp = first_token(logits0.repeat(beams, 1), generator, **samp)
        else:
            cur_tok, cur_lp = sampler(generator, **samp)(logits0.expand(beams, -1))
        sum_lp, iterations = _token_loop(cur_tok, cur_lp, advance, y_buf, eos=eos,
                                         prompt_len=prompt_len, max_gen=max_gen)
        accepted = 0
    else:
        logits0 = _pad_logits(logits0, packed["wpred"].shape[0])
        cur_tok, cur_lp = first_token(logits0.repeat(beams, 1), generator, **samp)
        quant = dict(act_quant=act_quant, kv_scales=kv_scales)
        if grouped:
            rows = lambda v: torch.full((beams,), v, dtype=torch.int32, device=dev)  # noqa: E731
            NL, _, H, _, hd = cache_k.shape
            gen = torch.zeros((NL, beams, H, t_audio + K, hd), dtype=cache_k.dtype, device=dev)
            block = _vallex_block(
                packed, gen, gen.clone(), model.pe, (cache_k, cache_v), x_lens=rows(x_len),
                plens=rows(prompt_len), max_gen=rows(max_gen), beams=beams, s_text=s_text,
                p_audio=p_audio, K=K, temperature=temperature, vocab=vocab, eos=eos,
                greedy=greedy, generator=generator, filt=filt, quant=quant)
            y_gen, sum_lp, iterations, _ = _block_loop(
                cur_tok, cur_lp, block, last=max_gen, t_gen=t_audio, K=K, eos=eos,
                generator=generator)
            n = t_audio + K - (prompt_len + 1)
            y_buf[:, prompt_len + 1:] = y_gen[:, :n]
            accepted = 0
        else:
            sum_lp, iterations, accepted = _kernel_loop(
                cfg, cur_tok, cur_lp, packed, packed_draft, cache_k[:, 0], cache_v[:, 0],
                y_buf[0], model.pe, generator=generator, greedy=greedy,
                temperature=temperature, x_len=x_len, prompt_len=prompt_len,
                s_text=s_text, max_gen=max_gen, K=K,
                speculative=speculative and (greedy or not filt), filt=filt, quant=quant)

    # ---- best sample (vallex_tpu/engine/ar.py:824-832) --------------------
    lengths = (y_buf != eos).sum(dim=1)
    best, scores = select_best(sum_lp, lengths, length_penalty)
    best = int(best)
    y = y_buf.cpu().numpy()
    gen_len = int((y[best] != eos).sum()) - (1 + prompt_len)
    return ARResult(y[best], gen_len, iterations, accepted, best, y,
                    scores.cpu().numpy())


def _pad_logits(logits: torch.Tensor, VP: int) -> torch.Tensor:
    """[B, V] prefill logits → [B, VP], the head's padded lanes at NEG_INF."""
    pad = torch.full((logits.shape[0], VP - logits.shape[-1]), V.NEG_INF, device=logits.device)
    return torch.cat([logits, pad], dim=-1)


def _token_loop(cur_tok, cur_lp, advance, y_buf, *, eos, prompt_len, max_gen):
    """The JAX package's per-token loops (`body`, `body_fused`) for B
    samples: bookkeeping (samples already done keep emitting EOS; logprob
    only while alive), then `advance(fed [B], audio_pos)` → the next
    (tokens, logprobs), until every sample is done or max_gen steps ran.
    One host read per step. → (sum_logprobs [B], steps run)."""
    B, dev = y_buf.shape[0], y_buf.device
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    sum_lp = torch.zeros((B,), dtype=torch.float32, device=dev)
    step = 0
    while step < max_gen and not bool(done.all()):
        tok = torch.where(done, eos, cur_tok.long())
        sum_lp = sum_lp + torch.where(done, 0.0, cur_lp)
        done = done | (tok == eos)
        audio_pos = prompt_len + 1 + step
        y_buf[:, audio_pos] = tok
        cur_tok, cur_lp = advance(tok, audio_pos)
        step += 1
    return sum_lp, step


def _xla_forward(model, tok, audio_pos, cache_k, cache_v, *, x_len, s_text, dtype):
    """One decoder step of `tok` [B] in plain PyTorch (the JAX package's
    XLA `body`): the column written into the caches [NL, B, H, C, hd] at
    s_text + audio_pos, attention over the masked cache → logits [B, 1025]."""
    hh = V.ar_audio_input(model, tok[:, None], audio_pos, dtype)
    kv_mask = audio_kv_mask(cache_k.shape[3], s_text, x_len, audio_pos, tok.device)
    for li, layer in enumerate(model.ar_decoder.layers):
        hh = layer.decode_step(hh, cache_k[li], cache_v[li], s_text + audio_pos, kv_mask)
    return V.ar_logits(model, model.ar_decoder.norm(hh)[:, 0])


def _pallas_forward(model, tok, audio_pos, cache_k, cache_v, *, x_len, s_text, dtype):
    """One decoder step with decode_attention per layer (the JAX package's
    `body` with decode_mode="pallas", vallex_tpu/engine/ar.py:765-785): the
    products in PyTorch, the attention and the column write in the kernel
    → logits [B, 1025]."""
    h = V.ar_audio_input(model, tok[:, None], audio_pos, dtype)
    for li, layer in enumerate(model.ar_decoder.layers):
        q, k, v = layer.self_attn.qkv(layer.norm1(h))  # [B, H, 1, hd]
        a = decode_attention(q[:, :, 0], k[:, :, 0], v[:, :, 0], cache_k[li], cache_v[li],
                             x_len, audio_pos, s_text=s_text)
        h = layer.ffn(h + layer.self_attn.out(a[:, :, None]))
    return V.ar_logits(model, model.ar_decoder.norm(h)[:, 0])


def _kernel_loop(cfg, cur_tok, cur_lp, packed, draft, cache_k, cache_v, y_buf, pe, *,
                 generator, greedy, temperature, x_len, prompt_len, s_text,
                 max_gen, K, speculative, filt, quant):
    """The megakernel path for one sample: speculative iterations (draft
    K-1 + verify K) or, with speculation off, K-step blocks (filtered
    epilogue when `filt` holds top_k / top_p; `quant` the blocks'
    act_quant / kv_scales). → (sum_logprobs [1], iterations, accepted
    drafts). Two host reads per iteration: the accepted count (it sets the
    commit) and the done flag."""
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
                eos=eos, stochastic=not greedy, generator=generator, **filt, **quant)
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
    seconds: Optional[Dict[str, float]] = None  # ar_generate_batch's SECONDS


# ar_generate_batch's `seconds`, each taken without a synchronize of its own
SECONDS = (
    "ar_prefill",  # the prefill span: CUDA events on the current stream (CPU: host clock)
    "ar_decode",  # host clock from the first block's enqueue to the last block's read
    "ar_wait",  # host clock inside the blocks' reads: the host waiting for the device
    "ar_wrappers",  # host seconds in the kernels' wrappers during the blocks (launch_seconds)
    "ar_graph_blocks",  # blocks run as replays of a CUDA graph (a count; 0 on the CPU)
    "ar_graph_capture",  # host seconds capturing and instantiating the block's graph
)
# HybridAR's prefill adds
HYBRID_SECONDS = SECONDS + (
    "ar_scan",  # the Mamba layers' chunked scans in the prefill: CUDA events (CPU: host clock)
    "ar_state_bytes",  # bytes of the recurrent state the decode reads and writes (a count)
)


class DeviceBlocks:
    """The batched loop's state in device memory, so that one enqueued
    block serves every block: the tokens and logprobs to feed, the done
    flags, the logprob sums and the step counter (0-d int32), each read and
    updated in place by `run`. `block(tok, lp, done, sum_lp, step)` is the
    loop's decode_block_fused call at the device step; `run` enqueues it,
    writes its fed tokens into y_gen's columns [step, step + K) and advances
    the counter by K, all on the device."""

    def __init__(self, block, cur_tok, cur_lp, y_gen, K):
        RB, dev = cur_tok.shape[0], cur_tok.device
        self.block, self.y_gen, self.K = block, y_gen, K
        self.tok = cur_tok.to(torch.int32).clone()
        self.lp = cur_lp.float().clone()
        self.done = torch.zeros((RB,), dtype=torch.bool, device=dev)
        self.sum_lp = torch.zeros((RB,), dtype=torch.float32, device=dev)
        self.step = torch.zeros((), dtype=torch.int32, device=dev)
        self.cols = torch.arange(K, device=dev)

    def run(self) -> None:
        r = self.block(self.tok, self.lp, self.done, self.sum_lp, self.step)
        self.y_gen.index_copy_(1, self.step + self.cols, r.fed.T.long())
        for buf, new in ((self.tok, r.next_tok), (self.lp, r.next_logp), (self.done, r.done),
                         (self.sum_lp, r.sum_logprobs)):
            buf.copy_(new)
        self.step.add_(self.K)

    def capture(self, generator):
        """`run` captured as a CUDA graph on a side stream, in a private
        memory pool, with `generator` registered so that each replay draws
        new uniforms → (graph, launches): the kernel launches the capture
        counted, taken back out of `loader.launch_counts` since the capture
        ran nothing; the caller adds them at each replay."""
        dev = self.tok.device
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        before = collections.Counter(loader.launch_counts)
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.run()
            finally:
                graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        launches = loader.launch_counts - before
        loader.launch_counts.subtract(launches)
        return graph, launches


def _graphed(t: torch.Tensor) -> bool:
    """The batched loop replays a captured block on CUDA tensors and runs
    each block eagerly on CPU tensors."""
    return t.device.type == "cuda"


def _vallex_block(packed, cache_k, cache_v, pe, prefix, *, x_lens, plens, max_gen, beams,
                  s_text, p_audio, K, temperature, vocab, eos, greedy, generator, filt, quant):
    """The batched loop's `block(tok, lp, done, sum_lp, step)` for VALL-E
    X's AR: K steps of decode_block_fused(batched=True) over R requests ×
    beams samples (request-major). `prefix` None: the batched layout; else
    the grouped one (caches hold generated rows only). `quant`: the
    blocks' act_quant / kv_scales."""
    def block(tok, lp, done, sum_lp, step):
        return decode_block_fused(
            tok, lp, done, sum_lp, packed, cache_k, cache_v, pe,
            x_len=x_lens, audio_pos=step, remaining=max_gen - step,
            temperature=temperature, steps=K, s_text=s_text, vocab=vocab, eos=eos,
            stochastic=not greedy, generator=generator, prompt_len=plens,
            batched=True, p_audio=p_audio, prefix=prefix, beams=beams, **filt, **quant)
    return block


def _block_loop(cur_tok, cur_lp, block, *, last, t_gen, K, eos, generator):
    """K-step batched blocks `block(tok, lp, done, sum_lp, step)` over RB
    rows (an architecture's `prefill` makes it) until every row is done or
    `last` (the longest cap) steps have run; one host read per block. On
    CUDA one block is captured as a CUDA graph (`DeviceBlocks`, a
    `vallex.ar.capture` span) and replayed for every block, its positions
    read from a device step counter; CPU tensors run each block eagerly at
    host positions. Each block is a `vallex.ar.block` span (its launches or
    its replay) and a `vallex.ar.read` span (its host read); the graph and
    its memory pool are released before the return. → (y_gen [RB, t_gen + K],
    sum_logprobs [RB], blocks run, {"ar_decode", "ar_wait", "ar_wrappers",
    "ar_graph_blocks", "ar_graph_capture": seconds, or the count})."""
    RB, dev = cur_tok.shape[0], cur_tok.device
    y_gen = torch.full((RB, t_gen + K), eos, dtype=torch.int64, device=dev)

    graph = None
    step, iterations, wait, capture = 0, 0, 0.0, 0.0
    wrappers = sum(loader.launch_seconds.values())
    t0 = time.perf_counter()
    if _graphed(cur_tok):
        state = DeviceBlocks(block, cur_tok, cur_lp, y_gen, K)
        with record_function("vallex.ar.capture"):
            graph, launches = state.capture(generator)
        capture = time.perf_counter() - t0
        done = state.done
    else:
        done = torch.zeros((RB,), dtype=torch.bool, device=dev)
        sum_lp = torch.zeros((RB,), dtype=torch.float32, device=dev)
    while step < last:
        iterations += 1
        with record_function("vallex.ar.block"):
            if graph is not None:
                graph.replay()
                loader.launch_counts.update(launches)
            else:
                r = block(cur_tok, cur_lp, done, sum_lp, step)
                y_gen[:, step: step + K] = r.fed.T.long()
                cur_tok, cur_lp, done, sum_lp = r.next_tok, r.next_logp, r.done, r.sum_logprobs
        step += K
        with record_function("vallex.ar.read"):
            tr = time.perf_counter()
            finished = bool(done.all())
            wait += time.perf_counter() - tr
        if finished:
            break
    if graph is not None:
        sum_lp = state.sum_lp
        graph.reset()
    seconds = dict(ar_decode=time.perf_counter() - t0, ar_wait=wait,
                   ar_wrappers=sum(loader.launch_seconds.values()) - wrappers,
                   ar_graph_blocks=iterations if graph is not None else 0,
                   ar_graph_capture=capture)
    return y_gen, sum_lp, iterations, seconds


class VallexAR:
    """VALL-E X's AR (models/vallex.py), which runs every route: the decode
    weights of ops/decode_step.py and their int8 draft; the batched prefill
    (int8kv: the caches quantized under `vallex.ar.kv_quant`; best_of: the
    grouped prefix) and `_vallex_block`."""

    def __init__(self, cfg: ModelConfig):
        self.cfg, self.head_dims = cfg, (cfg.head_dim,)

    def refuse(self, ecfg: EngineConfig, *, best_of: int) -> None:
        """Every engine setting runs."""

    def refuse_single(self) -> None:
        """Single requests run."""

    def pack(self, model, dtype) -> Dict:
        return pack_layer_weights(model, dtype)

    def draft(self, packed: Dict) -> Dict:
        return quantize_weights(packed)

    def prefill(self, model, text, lang, x_lens, prompt_lens, y_init, caps, *, longest, s_text,
                p_audio, t_gen, K, beams, dtype, packed, quantize, top_k, top_p, temperature,
                generator):
        cfg, dev, grouped = self.cfg, text.device, beams > 1
        P = s_text + p_audio
        cache_k, cache_v, logits0 = prefill(
            model, cfg, text, lang, x_lens, y_init, prompt_lens, s_text=s_text, p_audio=p_audio,
            C=P if grouped else P + t_gen + K, dtype=dtype)
        kv_scales = None
        if quantize == "int8kv":  # the batch's caches, or the grouped prefix
            with record_function("vallex.ar.kv_quant"):
                cache_k, cache_v, kv_scales = int8_caches(cache_k, cache_v)
        prefix = None
        if grouped:
            prefix = (cache_k, cache_v)
            NL, R, H, _, hd = cache_k.shape
            cache_k = torch.zeros((NL, R * beams, H, t_gen + K, hd), dtype=cache_k.dtype,
                                  device=dev)
            cache_v = torch.zeros_like(cache_k)
        rep = (lambda t: t.repeat_interleave(beams, dim=0)) if grouped else (lambda t: t)
        max_gen = rep(torch.as_tensor(caps, device=dev))
        block = _vallex_block(
            packed, cache_k, cache_v, model.pe, prefix, x_lens=rep(x_lens),
            plens=rep(prompt_lens), max_gen=max_gen, beams=beams, s_text=s_text,
            p_audio=p_audio, K=K, temperature=temperature, vocab=cfg.num_audio_tokens + 1,
            eos=cfg.eos_id, greedy=top_k == 1, generator=generator,
            filt={} if is_plain(top_k, top_p) else dict(top_k=top_k, top_p=top_p),
            quant=dict(act_quant=quantize == "w8a8", kv_scales=kv_scales))
        return rep(logits0), max_gen, block, lambda: {}


class HybridAR:
    """The hybrid AR (models/granite_hybrid.py): batches alone, one sample
    a request, unquantized, greedy or plain sampling, no speculation. Its
    prefill fills the attention layers' K/V and the Mamba layers' states (a
    `vallex.ar.scan` span a layer); its block (ops/decode_hybrid.py)
    updates the states in place; its `seconds` add `HYBRID_SECONDS`' two."""

    NAME = "the hybrid AR (ModelConfig.ar_stack)"  # as its refusals name it

    def __init__(self, cfg: ModelConfig, stack):
        self.cfg, self.head_dims = cfg, (cfg.head_dim, stack.head_dim)

    def refuse(self, ecfg: EngineConfig, *, best_of: int) -> None:
        if ecfg.quantize != "none":
            raise ValueError(f"quantize {ecfg.quantize!r} is not run by {self.NAME}: it serves"
                             " unquantized weights and K/V")
        if ecfg.speculative == "on":
            raise ValueError(f"speculative decoding is not run by {self.NAME}; set speculative"
                             " 'off'")
        if best_of > 1:
            raise ValueError(f"best_of {best_of} is not run by {self.NAME}: one sample a request")

    def refuse_single(self) -> None:
        raise ValueError(f"single-request synthesize is not run by {self.NAME}: send two or more"
                         " requests to synthesize_batch")

    def pack(self, model, dtype) -> Dict:
        return pack_hybrid_weights(model, self.cfg, dtype)

    def prefill(self, model, text, lang, x_lens, prompt_lens, y_init, caps, *, longest, s_text,
                p_audio, t_gen, K, beams, dtype, packed, quantize, top_k, top_p, temperature,
                generator):
        if beams != 1 or quantize != "none" or not is_plain(top_k, top_p):
            raise ValueError(f"{self.NAME} runs best_of 1, quantize 'none' and greedy or plain"
                             f" sampling, not best_of {beams}, quantize {quantize!r}, top-k /"
                             f" top-p filtering {top_k} / {top_p}")
        cfg, scans = self.cfg, []
        cache_k, cache_v, state, logits0 = GH.prefill(
            model, cfg, text, lang, x_lens, y_init, prompt_lens, s_text=s_text, p_audio=p_audio,
            C=s_text + p_audio + t_gen + K, dtype=dtype, L=longest, scan_spans=scans)
        max_gen = torch.as_tensor(caps, device=text.device)

        def block(tok, lp, done, sum_lp, step):
            return decode_block_hybrid(
                tok, lp, done, sum_lp, packed, cfg, cache_k, cache_v, state, x_len=x_lens,
                prompt_len=prompt_lens, audio_pos=step, remaining=max_gen - step,
                temperature=temperature, steps=K, s_text=s_text, p_audio=p_audio,
                vocab=cfg.num_audio_tokens + 1, eos=cfg.eos_id, stochastic=top_k != 1,
                generator=generator)

        def seconds():
            return dict(ar_scan=sum(s.seconds() for s in scans),
                        ar_state_bytes=float(GH.state_bytes(cfg, text.shape[0])))
        return logits0, max_gen, block, seconds


def ar_arch(cfg: ModelConfig):
    """The AR architecture `cfg` names, VALL-E X's or the hybrid stack it
    holds: the one place the engine reads which AR the model has. One has
    `head_dims` (for check_head_dim), `refuse(ecfg, best_of=)` and
    `refuse_single()` (ValueError for what it does not run), `pack(model,
    dtype)` (its decode weights) and `prefill`, the batched prefill of
    `ar_generate_batch` (R requests on the device, their caps on the host,
    the keywords that call names) → (first-token logits and length caps of
    the R·beams request-major rows, the `block(tok, lp, done, sum_lp,
    step)` of `_block_loop`, a callable giving its `seconds` once the
    device is done)."""
    return VallexAR(cfg) if cfg.ar_stack is None else HybridAR(cfg, cfg.ar_stack)


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
    packed: Dict,  # the architecture's decode weights: bf16, int8 (W8A16) or f32
    beams: int = 1,
    top_p: float = 1.0,
    length_penalty: float = 1.0,
    quantize: str = "none",
) -> BatchARResult:
    """R independent requests decoded together, whatever the AR
    (`ar_arch`): its prefill, then K-step blocks of its batched decode,
    each streaming the weights once for all rows. Prefill runs once per
    request with per-request masks; each row's first token comes from its
    request's prefill logits; each row keeps its own EOS forcing, length
    cap max_gen = min(16·x_len, gen_cap, t_gen - 1) and logprob sum.
    beams > 1: R × beams request-major rows (row r·beams + b is request
    r's sample b), and each request keeps its best sample (`select_best`,
    lengths counting BOS + prompt + generated frames). One host read per
    block. `quantize` names how `packed` was prepared: "w8a8" runs its
    products as W8A8; "int8kv" quantizes the prefilled caches (grouped:
    the prefix) with scales taken over every request of the batch
    (`kv_int8_scales`). Profiler spans, inside the caller's:
    `vallex.ar.prefill` (with the architecture's own inside),
    `vallex.ar.decode` (the blocks and their reads, `_block_loop`),
    `vallex.ar.finish` (lengths, best samples, the copies to the host);
    the result's `seconds` holds `SECONDS` and the architecture's own."""
    arch, dev, R, K = ar_arch(cfg), model.pe.device, text_ids.shape[0], decode_steps
    if K < 2:
        raise ValueError("the batched decode runs K-step blocks (decode_steps >= 2)")
    stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
    prefill_time = DeviceSpan("ar_prefill", stream=stream)
    with record_function("vallex.ar.prefill"):
        # BOS, then each prompt's cb0 frames
        y_init = torch.cat([
            torch.full((R, 1), cfg.bos_id, dtype=torch.int64, device=dev),
            torch.as_tensor(np.asarray(prompt_audio), device=dev).long(),
        ], dim=1)
        plens = torch.as_tensor(np.asarray(prompt_lens, np.int32), device=dev)
        logits0, max_gen, block, arch_seconds = arch.prefill(
            model, torch.as_tensor(np.asarray(text_ids), device=dev),
            torch.as_tensor(np.asarray(lang_ids), device=dev),
            torch.as_tensor(np.asarray(x_lens, np.int32), device=dev),
            plens, y_init,
            np.minimum(np.minimum(16 * np.asarray(x_lens, np.int64),
                                  np.asarray(gen_caps, np.int64)), t_gen - 1),
            longest=int(np.max(np.asarray(x_lens) + 1 + np.asarray(prompt_lens))),
            s_text=s_text, p_audio=p_audio, t_gen=t_gen, K=K, beams=beams, dtype=dtype,
            packed=packed, quantize=quantize, top_k=top_k, top_p=top_p, temperature=temperature,
            generator=generator)
        cur_tok, cur_lp = first_token(_pad_logits(logits0, packed["wpred"].shape[0]), generator,
                                      vocab=cfg.num_audio_tokens + 1, top_k=top_k, top_p=top_p,
                                      temperature=temperature)
        prefill_time.close(stream)
        # the batch's one host read before the blocks: it waits for the
        # prefill, so the device work inside `vallex.ar.decode` is the blocks'
        last = int(max_gen.max())
    with record_function("vallex.ar.decode"):
        y_gen, sum_lp, iterations, seconds = _block_loop(
            cur_tok, cur_lp, block, last=last, t_gen=t_gen, K=K, eos=cfg.eos_id,
            generator=generator)
    with record_function("vallex.ar.finish"):
        # frames before each row's first EOS, clipped to its length cap
        alive = torch.cumprod((y_gen[:, :t_gen] != cfg.eos_id).to(torch.int32), dim=1)
        gen_len = torch.minimum(alive.sum(dim=1), max_gen)
        # each request's best sample (lengths: BOS + prompt + generated frames)
        best, scores = select_best(sum_lp.view(R, beams),
                                   1 + plens[:, None] + gen_len.view(R, beams), length_penalty)
        rows = torch.arange(R, device=dev) * beams + best
        # the device is done: reading the events waits for nothing
        return BatchARResult(y_gen[rows].cpu().numpy(), gen_len[rows].cpu().numpy(),
                             iterations, scores.cpu().numpy(),
                             dict(ar_prefill=prefill_time.seconds(), **seconds,
                                  **arch_seconds()))
