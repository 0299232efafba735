"""Synthesis pipeline: AR → NAR → Vocos for one utterance or a batch of
requests (port of vallex_tpu/engine/pipeline.py: _assemble_nar_input(_batch),
_shift_out_prompt(_batch), _nar_tail(_batch), SynthesisPipeline.synthesize
and synthesize_batch).

Every sampling knob of the reference runs: best_of > 1 (samples of one
request, or of each batched request, and the best picked), filtered
top-k / top-p, greedy and plain sampling, in bf16 or f32, with bf16 or int8
serving weights. Configurations the port does not run yet raise
NotImplementedError naming their ROADMAP.md item: the int8 KV cache and
w8a8, single-step decode and decode_mode="pallas".
"""

from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..config import EngineConfig, ModelConfig
from ..models import vallex as V
from ..ops.decode_step import pack_layer_weights, quantize_weights
from .ar import (
    ARResult,
    BatchARResult,
    ar_generate,
    ar_generate_batch,
    bucket,
    is_plain,
    pad_batched_requests,
    validate_prompt_len,
)
from .nar import nar_generate

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


QUANTIZE_ITEMS = {"int8kv": "§2 item 1c (the int8 KV cache)", "w8a8": "§2 item 1d (w8a8)"}


def check_slice(ecfg: EngineConfig, *, best_of: int) -> None:
    """Raise for configurations the port does not run yet (CPU and GPU
    alike — there is no quiet fallback)."""
    if best_of < 1:
        raise ValueError(f"best_of must be >= 1, got {best_of}")
    if ecfg.quantize not in ("none", "int8"):
        item = QUANTIZE_ITEMS.get(ecfg.quantize, "§2 item 1")
        raise NotImplementedError(
            f"quantize={ecfg.quantize!r} is not ported yet: ROADMAP.md {item},"
            " slice 4")
    if ecfg.decode_steps < 2:
        raise NotImplementedError(
            "decode_steps=1 (the single-step decode_step kernel) is not ported"
            " yet: ROADMAP.md §2 item 2, slice 4")
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
    seconds: Dict[str, float]  # host-clock phase times, device-synchronized


class BatchSynthesisResult(NamedTuple):
    outputs: List[Tuple[np.ndarray, Optional[np.ndarray]]]  # per request (codes, wave)
    ar: Optional[BatchARResult]  # None when one request took synthesize
    seconds: Dict[str, float]  # host-clock phase times of the whole batch


class SynthesisPipeline:
    """AR + NAR (+ Vocos) on one device. decode_mode "auto" runs the
    hand-written kernels on CUDA and the per-token loop on the CPU. Each
    phase is a profiler span ("vallex.ar", "vallex.nar", "vallex.vocos")
    that a torch.profiler trace reads its device-busy share from."""

    def __init__(self, model: V.VALLE, cfg: ModelConfig, ecfg: EngineConfig,
                 vocos=None):
        self.model = model
        self.cfg = cfg
        self.ecfg = ecfg
        self.vocos = vocos
        self.device = model.pe.device
        self.dtype = DTYPES[ecfg.compute_dtype]
        mode = ecfg.decode_mode
        if mode == "auto":
            mode = "megakernel" if self.device.type == "cuda" else "xla"
        if mode not in ("megakernel", "xla"):
            raise NotImplementedError(
                f"decode_mode={ecfg.decode_mode!r} is not ported: the port has"
                " the kernel path and the per-token path (ROADMAP.md §2 item 3,"
                " decode_attention, slice 4)")
        self.decode_mode = mode
        self._packed: Optional[Dict] = None
        self._draft: Optional[Dict] = None

    def packed_weights(self, need_draft: bool):
        """bf16 packed decode weights and the int8 draft, prepared once."""
        if self._packed is None:
            self._packed = pack_layer_weights(self.model, self.dtype)
        if need_draft and self._draft is None:
            self._draft = quantize_weights(self._packed)
        return self._packed, self._draft

    def serving_weights(self) -> Dict:
        """The decode weights of K-step blocks: bf16, or with
        quantize="int8" the W8A16 dict (the same one the draft uses)."""
        int8 = self.ecfg.quantize == "int8"
        packed, draft = self.packed_weights(int8)
        return draft if int8 else packed

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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
    ) -> SynthesisResult:
        e, cfg, dev = self.ecfg, self.cfg, self.device
        best_of = best_of or e.best_of
        top_k = e.top_k if top_k is None else top_k
        top_p = e.top_p if top_p is None else top_p
        temperature = e.temperature if temperature is None else temperature
        check_slice(e, best_of=best_of)
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

        text_pad = np.zeros((s_text,), np.int64)
        text_pad[:S] = text_ids
        lang_pad = np.zeros((s_text,), np.int64)
        lang_pad[:S] = lang_ids
        prompt_pad = np.full((p_audio - 1,), cfg.eos_id, np.int64)
        prompt_pad[:Tp] = prompt[:, 0]

        # speculation drafts with int8 and verifies with the serving dtype:
        # unquantized serving, one sample, greedy or plain sampling
        # (EngineConfig.speculative; vallex_tpu/engine/ar.py:373-392)
        speculative = (e.speculative in ("auto", "on") and e.quantize == "none"
                       and best_of == 1 and (top_k == 1 or is_plain(top_k, top_p)))
        kernels = self.decode_mode == "megakernel"
        packed, draft = None, None
        if kernels:
            packed, draft = (self.packed_weights(True) if speculative
                             else (self.serving_weights(), None))
        generator = torch.Generator(device=dev)
        generator.manual_seed(int(seed) & 0x7FFFFFFF)
        with record_function("vallex.ar"):
            ar = ar_generate(
                self.model, cfg, text_pad, lang_pad, S, prompt_pad, Tp,
                generator=generator, top_k=top_k, temperature=temperature,
                gen_limit=max_gen_frames, s_text=s_text, p_audio=p_audio,
                t_audio=t_audio, dtype=self.dtype, decode_mode=self.decode_mode,
                decode_steps=e.decode_steps, speculative=speculative and kernels,
                packed=packed, packed_draft=draft, top_p=top_p, beams=best_of,
                length_penalty=e.length_penalty,
            )
            self._sync()
        seconds["ar"] = time.perf_counter() - t0

        t1 = time.perf_counter()
        gl = ar.gen_len
        with record_function("vallex.nar"):
            codes_pad = torch.zeros((1, t_audio, cfg.num_quantizers), dtype=torch.int64, device=dev)
            codes_pad[0, :Tp] = torch.from_numpy(np.array(prompt, np.int64)).to(dev)
            codes_in = assemble_nar_input(
                torch.as_tensor(ar.tokens, device=dev), codes_pad, t_audio, cfg.eos_id)
            codes = nar_generate(
                self.model, cfg, torch.as_tensor(text_pad, device=dev)[None],
                torch.as_tensor(lang_pad, device=dev)[None], S, codes_in, Tp + gl, Tp,
                dtype=self.dtype,
            )
            gen_codes = shift_out_prompt(codes, Tp, gl)
            self._sync()
        seconds["nar"] = time.perf_counter() - t1

        wave = None
        if return_wave and self.vocos is not None:
            from ..codec.vocos import HOP, vocos_decode

            t2 = time.perf_counter()
            with record_function("vallex.vocos"):
                w = vocos_decode(self.vocos, gen_codes, bandwidth_id=2, t_len=gl)
                wave = w[0, : gl * HOP].cpu().numpy()
            seconds["vocos"] = time.perf_counter() - t2
        return SynthesisResult(gen_codes[0, :gl].cpu().numpy(), wave, ar, seconds)

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
        The batched decode runs ops/decode_block.py whatever decode_mode
        says (the JAX package's batched decode has only its kernel path):
        the kernels on CUDA, their plain versions on the CPU."""
        e, cfg, dev = self.ecfg, self.cfg, self.device
        top_k = e.top_k if top_k is None else top_k
        top_p = e.top_p if top_p is None else top_p
        temperature = e.temperature if temperature is None else temperature
        check_slice(e, best_of=best_of)
        R = len(requests)
        if R == 1:
            t, lg, p = requests[0]
            res = self.synthesize(t, lg, p, best_of=best_of, top_k=top_k, top_p=top_p,
                                  temperature=temperature, seed=seed,
                                  return_wave=return_wave)
            return BatchSynthesisResult([(res.codes, res.wave)], None, res.seconds)
        seconds = {}
        t0 = time.perf_counter()
        pb = pad_batched_requests(requests, cfg.eos_id, cfg.num_quantizers,
                                  e.text_buckets, e.audio_buckets)
        s_text, p_audio, t_gen = pb["s_text"], pb["p_audio"], pb["t_gen"]
        prompts = pb["prompts"]
        Tp_max = max(len(p) for p in prompts)
        t_audio = bucket(min(Tp_max + 1 + 16 * int(max(pb["x_lens"])) + 1,
                             e.audio_buckets[-1]), e.audio_buckets, granularity=512)
        prompt_codes_pad = np.zeros((R, t_audio, cfg.num_quantizers), np.int64)
        for r, pr in enumerate(prompts):
            prompt_codes_pad[r, : len(pr)] = pr
        generator = torch.Generator(device=dev)
        generator.manual_seed(int(seed) & 0x7FFFFFFF)
        with record_function("vallex.ar"):
            ar = ar_generate_batch(
                self.model, cfg, pb["text"], pb["lang"], pb["x_lens"], pb["prompt_pad"],
                pb["prompt_lens"], pb["caps"], generator=generator, top_k=top_k,
                temperature=temperature, s_text=s_text, p_audio=p_audio, t_gen=t_gen,
                dtype=self.dtype, decode_steps=max(2, e.decode_steps),
                packed=self.serving_weights(), beams=best_of, top_p=top_p,
                length_penalty=e.length_penalty)
            self._sync()
        seconds["ar"] = time.perf_counter() - t0

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
