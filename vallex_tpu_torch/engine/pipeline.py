"""Synthesis pipeline: AR → NAR → Vocos for one utterance or a batch of
requests (port of vallex_tpu/engine/pipeline.py: _assemble_nar_input(_batch),
_shift_out_prompt(_batch), _nar_tail(_batch), PendingSynthesis,
SynthesisPipeline.synthesize, synthesize_async and synthesize_batch).

`synthesize_async` splits one utterance into dispatch and fetch, as the JAX
package does: it runs the AR, enqueues the tail (NAR, then Vocos) on the
pipeline's own CUDA stream and returns a `PendingSynthesis`, whose
`result()` waits for the tail and copies codes and wave to the host. Long
text runs sentence i + 1's AR while sentence i's tail runs (api.py).

Every sampling knob of the reference runs: best_of > 1 (samples of one
request, or of each batched request, and the best picked), filtered
top-k / top-p, greedy and plain sampling, in bf16 or f32, with every
serving quantization (bf16, int8, w8a8, int8kv), every decode_steps and
every decode_mode, on VALL-E X's AR; the pipeline asks its AR architecture
(engine/ar.py::ar_arch) for its weights and what it refuses.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..config import EngineConfig, ModelConfig
from ..kernels import check_head_dim
from ..models import vallex as V
from ..utils.profiling import DeviceSpan, PhaseTimer
from .ar import (
    ARResult,
    BatchARResult,
    ar_arch,
    ar_generate,
    ar_generate_batch,
    bucket,
    is_plain,
    pad_batched_requests,
    validate_prompt_len,
)
from .nar import nar_generate

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


QUANTIZE = ("none", "int8", "w8a8", "int8kv")  # EngineConfig.quantize
DECODE_MODES = ("auto", "megakernel", "pallas", "xla")  # EngineConfig.decode_mode


def check_config(ecfg: EngineConfig, *, best_of: int,
                 cfg: Optional[ModelConfig] = None) -> None:
    """Raise ValueError for values the engine does not know (CPU and GPU
    alike — there is no quiet fallback), and for the paths cfg's AR does
    not run (the `refuse` of its `ar_arch`)."""
    if best_of < 1:
        raise ValueError(f"best_of must be >= 1, got {best_of}")
    if cfg is not None:
        ar_arch(cfg).refuse(ecfg, best_of=best_of)
    if ecfg.quantize not in QUANTIZE:
        raise ValueError(f"unknown quantize {ecfg.quantize!r}; one of {QUANTIZE}")
    if ecfg.decode_steps < 1:
        raise ValueError(f"decode_steps must be >= 1, got {ecfg.decode_steps}")
    if ecfg.compute_dtype not in DTYPES:
        raise ValueError(f"unknown compute_dtype {ecfg.compute_dtype!r}")


def assemble_nar_input(ar_tokens: torch.Tensor, prompt_codes_pad: torch.Tensor,
                       t_audio: int, eos: int) -> torch.Tensor:
    """codes_in [1, t_audio, 8]: cb0 from the AR buffer (BOS stripped),
    cb1..7 from the prompt rows."""
    y = ar_tokens[:t_audio]
    cb0 = torch.cat([y[1:], y.new_full((1,), eos)])
    out = prompt_codes_pad.clone()
    out[..., 0] = cb0[None]
    return out


def shift_out_prompt(codes: torch.Tensor, prompt_len: int, gen_len: int) -> torch.Tensor:
    """Roll the prompt region out (row 0 = first generated frame) and zero
    the rows beyond gen_len."""
    shifted = torch.roll(codes, -prompt_len, dims=1)
    rows = torch.arange(shifted.shape[1], device=codes.device)[None, :, None]
    return torch.where(rows < gen_len, shifted, 0)


def assemble_nar_input_batch(y_gen: torch.Tensor, prompt_codes_pad: torch.Tensor,
                             prompt_lens: torch.Tensor, t_audio: int) -> torch.Tensor:
    """Per-request NAR input [R, t_audio, 8]: audio position j carries the
    prompt's codes for j < prompt_len[r] and the request's generated cb0
    y_gen[r, j - prompt_len[r]] after (y_gen [R, t_gen + K], column 0 =
    first generated frame)."""
    rows = torch.arange(t_audio, device=y_gen.device)[None, :]
    pl = prompt_lens.long()[:, None]
    gen_idx = torch.clamp(rows - pl, 0, y_gen.shape[1] - 1)
    cb0 = torch.where(rows < pl, prompt_codes_pad[..., 0],
                      torch.gather(y_gen, 1, gen_idx.expand(y_gen.shape[0], -1)))
    out = prompt_codes_pad.clone()
    out[..., 0] = cb0
    return out


def shift_out_prompt_batch(codes: torch.Tensor, prompt_lens: torch.Tensor,
                           gen_lens: torch.Tensor) -> torch.Tensor:
    """Per-request prompt shift-out: row i ← row i + prompt_len[r], rows
    at or beyond gen_len[r] zeroed (see shift_out_prompt)."""
    TA = codes.shape[1]
    rows = torch.arange(TA, device=codes.device)[None, :]
    src = torch.clamp(rows + prompt_lens.long()[:, None], 0, TA - 1)
    shifted = torch.gather(codes, 1, src[..., None].expand(-1, -1, codes.shape[2]))
    return torch.where((rows < gen_lens.long()[:, None])[..., None], shifted, 0)


class SynthesisResult(NamedTuple):
    codes: np.ndarray  # [T_gen, 8]
    wave: Optional[np.ndarray]  # [T_gen * 320] or None
    ar: ARResult
    # "ar": host clock; "nar", "vocos": CUDA events on the tail stream (host
    # clock on the CPU); "enqueue": host time to enqueue the tail; "sync":
    # result()'s wait and copies
    seconds: Dict[str, float]


class BatchSynthesisResult(NamedTuple):
    outputs: List[Tuple[np.ndarray, Optional[np.ndarray]]]  # per request (codes, wave)
    ar: Optional[BatchARResult]  # None when one request took synthesize
    seconds: Dict[str, float]  # phase times of the whole batch: decode_padded_batch's, "vocos"


def _on(stream):
    """torch.cuda.stream(stream), or nothing on the CPU (stream None)."""
    return contextlib.nullcontext() if stream is None else torch.cuda.stream(stream)


class PendingSynthesis:
    """A synthesis whose AR has run and whose tail (NAR, then Vocos) may
    still run on the pipeline's tail stream. It holds device tensors only;
    `result()` waits for the tail's end event, copies codes (and wave) to
    the host on the tail stream and returns the SynthesisResult, the same
    one each call (a long text's worker and its reader may both ask)."""

    __slots__ = ("_ar", "_codes", "_wave", "_done", "_stream", "_spans", "_seconds",
                 "_timer", "_lock", "_result")

    def __init__(self, ar: ARResult, gen_codes: torch.Tensor, wave: Optional[torch.Tensor],
                 done, stream, spans: List[DeviceSpan], seconds: Dict[str, float],
                 timer: PhaseTimer):
        self._ar, self._codes, self._wave = ar, gen_codes, wave
        self._done, self._stream, self._spans = done, stream, spans
        self._seconds, self._timer = seconds, timer
        self._lock = threading.Lock()
        self._result: Optional[SynthesisResult] = None

    def result(self) -> SynthesisResult:
        with self._lock:
            if self._result is None:
                from ..codec.vocos import HOP

                gl = self._ar.gen_len
                dev = [self._codes[0, :gl]]
                if self._wave is not None:
                    dev.append(self._wave[0, : gl * HOP])
                t0 = time.perf_counter()
                if self._done is not None:
                    self._done.synchronize()
                with _on(self._stream):  # the tail stream the tensors were made on
                    host = [t.cpu().numpy() for t in dev]
                self._seconds["sync"] = time.perf_counter() - t0
                self._timer.add("sync", self._seconds["sync"])
                for span in self._spans:
                    self._seconds[span.name] = span.seconds()
                self._result = SynthesisResult(host[0], host[1] if len(host) > 1 else None,
                                               self._ar, self._seconds)
                self._codes = self._wave = self._done = None
            return self._result


class SynthesisPipeline:
    """AR + NAR (+ Vocos) on one device. decode_mode "auto" runs the
    hand-written kernels on CUDA and the per-token loop on the CPU. Each
    phase is a profiler span ("vallex.ar", "vallex.nar", "vallex.vocos";
    the tail's two close when their work is enqueued) and a phase of
    `timer`."""

    def __init__(self, model: V.VALLE, cfg: ModelConfig, ecfg: EngineConfig,
                 vocos=None):
        self.model = model
        self.cfg = cfg
        self.ecfg = ecfg
        self.vocos = vocos
        self.device = model.pe.device
        self.arch = ar_arch(cfg)
        for hd in self.arch.head_dims:
            check_head_dim(hd, self.device)
        self.arch.refuse(ecfg, best_of=1)
        self.dtype = DTYPES[ecfg.compute_dtype]
        mode = ecfg.decode_mode
        if mode not in DECODE_MODES:
            raise ValueError(f"unknown decode_mode {mode!r}; one of {DECODE_MODES}")
        if mode == "auto":
            mode = "megakernel" if self.device.type == "cuda" else "xla"
        self.decode_mode = mode
        self._packed: Optional[Dict] = None
        self._draft: Optional[Dict] = None
        self._tail: Optional[torch.cuda.Stream] = None
        self.timer = PhaseTimer()

    def packed_weights(self, need_draft: bool):
        """bf16 packed decode weights and the int8 draft, prepared once."""
        if self._packed is None:
            self._packed = self.arch.pack(self.model, self.dtype)
        if need_draft and self._draft is None:
            self._draft = self.arch.draft(self._packed)
        return self._packed, self._draft

    def serving_weights(self) -> Dict:
        """The decode weights without speculation: bf16 (or f32), or with
        quantize "int8", "w8a8" or "int8kv" the int8 dict (the same one the
        draft uses; w8a8 is a mode of the products, int8kv of the cache)."""
        int8 = self.ecfg.quantize != "none"
        packed, draft = self.packed_weights(int8)
        return draft if int8 else packed

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def tail_stream(self) -> Optional[torch.cuda.Stream]:
        """The stream the NAR + Vocos tail of `synthesize_async` runs on
        (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        if self._tail is None:
            self._tail = torch.cuda.Stream(self.device)
        return self._tail

    @torch.inference_mode()
    def synthesize(
        self,
        text_ids: np.ndarray,  # [S]
        lang_ids: np.ndarray,  # [S]
        prompt_codes: Optional[np.ndarray] = None,  # [Tp, 8]
        *,
        best_of: Optional[int] = None,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        temperature: Optional[float] = None,
        seed: int = 0,
        return_wave: bool = True,
        max_gen_frames: Optional[int] = None,
        buckets: Optional[Tuple[int, int, int]] = None,
    ) -> SynthesisResult:
        """→ SynthesisResult: `synthesize_async(...).result()`.
        max_gen_frames caps the generated length (75 frames/s) and
        right-sizes the audio bucket; `buckets` = (s_text, p_audio,
        t_audio) replaces the request's own (a batch's, engine/batch.py)."""
        return self.synthesize_async(
            text_ids, lang_ids, prompt_codes, best_of=best_of, top_k=top_k, top_p=top_p,
            temperature=temperature, seed=seed, return_wave=return_wave,
            max_gen_frames=max_gen_frames, buckets=buckets).result()

    @torch.inference_mode()
    def synthesize_async(
        self,
        text_ids: np.ndarray,  # [S]
        lang_ids: np.ndarray,  # [S]
        prompt_codes: Optional[np.ndarray] = None,  # [Tp, 8]
        *,
        best_of: Optional[int] = None,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        temperature: Optional[float] = None,
        seed: int = 0,
        return_wave: bool = True,
        max_gen_frames: Optional[int] = None,
        buckets: Optional[Tuple[int, int, int]] = None,
    ) -> "PendingSynthesis":
        """Run the AR, enqueue the tail (NAR, then Vocos when a wave is
        asked for) and return without waiting for it (PendingSynthesis):
        a caller that knows its next utterance can run that one's AR while
        this tail runs. On the card the AR runs on the current stream and
        ends with its own host read of the tokens; the tail runs on
        `tail_stream()`, after `wait_stream` on the current one. On the CPU
        the tail runs eagerly here and `result()` only slices."""
        e, cfg, dev = self.ecfg, self.cfg, self.device
        best_of = best_of or e.best_of
        top_k = e.top_k if top_k is None else top_k
        top_p = e.top_p if top_p is None else top_p
        temperature = e.temperature if temperature is None else temperature
        check_config(e, best_of=best_of, cfg=cfg)
        self.arch.refuse_single()
        seconds = {}
        t0 = time.perf_counter()

        S = len(text_ids)
        s_text = bucket(S, e.text_buckets)
        prompt = (np.zeros((0, cfg.num_quantizers), np.int32) if prompt_codes is None
                  else np.asarray(prompt_codes, np.int32))
        Tp = len(prompt)
        validate_prompt_len(Tp, e.audio_buckets)
        p_audio = bucket(Tp + 1, e.audio_buckets)
        want = 16 * S if max_gen_frames is None else min(16 * S, max_gen_frames)
        t_audio = bucket(min(Tp + 1 + want + 1, e.audio_buckets[-1]),
                         e.audio_buckets, granularity=512)
        p_audio = min(p_audio, t_audio)
        if buckets is not None:
            s_text, p_audio, t_audio = buckets

        text_pad = np.zeros((s_text,), np.int64)
        text_pad[:S] = text_ids
        lang_pad = np.zeros((s_text,), np.int64)
        lang_pad[:S] = lang_ids
        prompt_pad = np.full((p_audio - 1,), cfg.eos_id, np.int64)
        prompt_pad[:Tp] = prompt[:, 0]

        # speculation drafts with int8 and verifies with the serving dtype:
        # unquantized K-step serving, one sample, greedy or plain sampling
        # (EngineConfig.speculative; vallex_tpu/engine/ar.py:373-392)
        speculative = (e.speculative in ("auto", "on") and e.quantize == "none"
                       and e.decode_steps > 1 and best_of == 1
                       and (top_k == 1 or is_plain(top_k, top_p)))
        kernels = self.decode_mode == "megakernel"
        packed, draft = None, None
        if kernels:
            packed, draft = (self.packed_weights(True) if speculative
                             else (self.serving_weights(), None))
        generator = torch.Generator(device=dev)
        generator.manual_seed(int(seed) & 0x7FFFFFFF)
        with self.timer.phase("ar"), record_function("vallex.ar"):
            # ends with a host read of the tokens: the current stream is
            # idle when it returns
            ar = ar_generate(
                self.model, cfg, text_pad, lang_pad, S, prompt_pad, Tp,
                generator=generator, top_k=top_k, temperature=temperature,
                gen_limit=max_gen_frames, s_text=s_text, p_audio=p_audio,
                t_audio=t_audio, dtype=self.dtype, decode_mode=self.decode_mode,
                decode_steps=e.decode_steps, speculative=speculative and kernels,
                packed=packed, packed_draft=draft, top_p=top_p, beams=best_of,
                length_penalty=e.length_penalty, quantize=e.quantize,
            )
        seconds["ar"] = time.perf_counter() - t0

        t1 = time.perf_counter()
        gl = ar.gen_len
        # the tail's inputs, uploaded on the current stream (a pageable
        # upload on the tail stream would wait for the previous tail)
        codes_pad = torch.zeros((1, t_audio, cfg.num_quantizers), dtype=torch.int64)
        codes_pad[0, :Tp] = torch.from_numpy(np.array(prompt, np.int64))
        inputs = [t.to(dev) for t in (torch.from_numpy(ar.tokens.astype(np.int64)),
                                      codes_pad, torch.from_numpy(text_pad)[None],
                                      torch.from_numpy(lang_pad)[None])]
        tail = self.tail_stream()
        if tail is not None:
            tail.wait_stream(torch.cuda.current_stream(dev))
            for t in inputs:  # the allocator may not hand them out while the tail reads
                t.record_stream(tail)
        tokens, codes_pad, text_d, lang_d = inputs
        wave = None
        with _on(tail):
            with self.timer.device_phase("nar", tail) as nar_span, \
                    record_function("vallex.nar"):
                codes_in = assemble_nar_input(tokens, codes_pad, t_audio, cfg.eos_id)
                codes = nar_generate(self.model, cfg, text_d, lang_d, S, codes_in,
                                     Tp + gl, Tp, dtype=self.dtype)
                gen_codes = shift_out_prompt(codes, Tp, gl)
            spans = [nar_span]
            if return_wave and self.vocos is not None:
                from ..codec.vocos import vocos_decode

                with self.timer.device_phase("vocos", tail) as vocos_span, \
                        record_function("vallex.vocos"):
                    wave = vocos_decode(self.vocos, gen_codes, bandwidth_id=2, t_len=gl)
                spans.append(vocos_span)
            done = None
            if tail is not None:
                done = torch.cuda.Event(blocking=True)
                done.record(tail)
        seconds["enqueue"] = time.perf_counter() - t1
        return PendingSynthesis(ar, gen_codes, wave, done, tail, spans, seconds,
                                self.timer)

    @torch.inference_mode()
    def decode_padded_batch(self, pb: Dict, prompt_codes_pad: np.ndarray, *, best_of: int,
                            top_k: int, top_p: float, temperature: float, seed: int):
        """The AR and NAR of a padded batch (`pad_batched_requests`'s dict,
        or a slice of a larger batch's with its buckets; prompt_codes_pad
        [R, t_audio, 8]) → (BatchARResult, generated codes [R, t_audio, 8]
        on the device, gen lens [R] int64, phase seconds: "ar" and "nar" on
        the host clock, ending in a synchronize, and the AR's own
        (engine/ar.py::SECONDS))."""
        e, cfg, dev = self.ecfg, self.cfg, self.device
        seconds = {}
        t0 = time.perf_counter()
        t_audio = prompt_codes_pad.shape[1]
        generator = torch.Generator(device=dev)
        generator.manual_seed(int(seed) & 0x7FFFFFFF)
        with record_function("vallex.ar"):
            ar = ar_generate_batch(
                self.model, cfg, pb["text"], pb["lang"], pb["x_lens"], pb["prompt_pad"],
                pb["prompt_lens"], pb["caps"], generator=generator, top_k=top_k,
                temperature=temperature, s_text=pb["s_text"], p_audio=pb["p_audio"],
                t_gen=pb["t_gen"], dtype=self.dtype, decode_steps=max(2, e.decode_steps),
                packed=self.serving_weights(), beams=best_of, top_p=top_p,
                length_penalty=e.length_penalty, quantize=e.quantize)
            self._sync()
        seconds["ar"] = time.perf_counter() - t0
        seconds.update(ar.seconds)

        t1 = time.perf_counter()
        lens = ar.gen_len.astype(np.int64)
        with record_function("vallex.nar"):
            plens = torch.as_tensor(pb["prompt_lens"].astype(np.int64), device=dev)
            gl = torch.as_tensor(lens, device=dev)
            codes_in = assemble_nar_input_batch(
                torch.as_tensor(ar.y_gen, device=dev),
                torch.as_tensor(prompt_codes_pad, device=dev), plens, t_audio)
            codes = nar_generate(
                self.model, cfg, torch.as_tensor(pb["text"], device=dev).long(),
                torch.as_tensor(pb["lang"], device=dev).long(),
                torch.as_tensor(pb["x_lens"], device=dev), codes_in, plens + gl, plens,
                dtype=self.dtype)
            gen_codes = shift_out_prompt_batch(codes, plens, gl)
            self._sync()
        seconds["nar"] = time.perf_counter() - t1
        return ar, gen_codes, lens, seconds

    @torch.inference_mode()
    def synthesize_batch(
        self,
        requests,  # list of (text_ids [S], lang_ids [S], prompt [Tp, 8] | None)
        *,
        best_of: int = 1,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        temperature: Optional[float] = None,
        seed: int = 0,
        return_wave: bool = True,
    ) -> BatchSynthesisResult:
        """Batched synthesis on one device: the AR decode runs all requests
        (× best_of samples each) as rows of one batched decode
        (engine/ar.py::ar_generate_batch), so each step streams the weights
        once for the batch; the NAR and Vocos run on each request's best
        sample at batch R with per-row lengths. One request takes
        `synthesize`.
        The batched decode runs its AR's K-step blocks whatever decode_mode
        and decode_steps say (the JAX package's batched decode has only its
        kernel path, at K = max(2, decode_steps)): the kernels on CUDA,
        their plain versions on the CPU."""
        e, cfg, dev = self.ecfg, self.cfg, self.device
        top_k = e.top_k if top_k is None else top_k
        top_p = e.top_p if top_p is None else top_p
        temperature = e.temperature if temperature is None else temperature
        check_config(e, best_of=best_of, cfg=cfg)
        R = len(requests)
        if R == 1:
            t, lg, p = requests[0]
            res = self.synthesize(t, lg, p, best_of=best_of, top_k=top_k, top_p=top_p,
                                  temperature=temperature, seed=seed,
                                  return_wave=return_wave)
            return BatchSynthesisResult([(res.codes, res.wave)], None, res.seconds)
        pb = pad_batched_requests(requests, cfg.eos_id, cfg.num_quantizers,
                                  e.text_buckets, e.audio_buckets)
        prompts = pb["prompts"]
        Tp_max = max(len(p) for p in prompts)
        t_audio = bucket(min(Tp_max + 1 + 16 * int(max(pb["x_lens"])) + 1,
                             e.audio_buckets[-1]), e.audio_buckets, granularity=512)
        prompt_codes_pad = np.zeros((R, t_audio, cfg.num_quantizers), np.int64)
        for r, pr in enumerate(prompts):
            prompt_codes_pad[r, : len(pr)] = pr
        ar, gen_codes, lens, seconds = self.decode_padded_batch(
            pb, prompt_codes_pad, best_of=best_of, top_k=top_k, top_p=top_p,
            temperature=temperature, seed=seed)
        gl = torch.as_tensor(lens, device=dev)

        waves = None
        if return_wave and self.vocos is not None:
            from ..codec.vocos import HOP, vocos_decode

            t2 = time.perf_counter()
            with record_function("vallex.vocos"):
                w = vocos_decode(self.vocos, gen_codes, bandwidth_id=2, t_len=gl)
                waves = w.cpu().numpy()
            seconds["vocos"] = time.perf_counter() - t2
        codes_np = gen_codes.cpu().numpy()
        outputs = [(codes_np[r, : lens[r]],
                    None if waves is None else waves[r, : lens[r] * HOP])
                   for r in range(R)]
        return BatchSynthesisResult(outputs, ar, seconds)
