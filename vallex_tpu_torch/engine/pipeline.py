"""Synthesis pipeline: AR → NAR → Vocos for one utterance (port of
vallex_tpu/engine/pipeline.py: _assemble_nar_input, _shift_out_prompt,
_nar_tail and SynthesisPipeline.synthesize).

Configurations outside the port's first slice raise NotImplementedError
naming their ROADMAP.md item: beams, filtered top-k/top-p, quantized
serving, single-step decode and batched requests.
"""

from __future__ import annotations

import time
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..config import EngineConfig, ModelConfig
from ..models import vallex as V
from ..ops.decode_step import pack_layer_weights, quantize_weights
from .ar import ARResult, ar_generate, bucket, validate_prompt_len
from .nar import nar_generate

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_slice(ecfg: EngineConfig, *, best_of: int, top_k: int, top_p: float) -> None:
    """Raise for configurations the port does not run yet (CPU and GPU
    alike — there is no quiet fallback)."""
    if best_of != 1:
        raise NotImplementedError(
            "best_of > 1 (beam search) is not ported yet: ROADMAP.md §2 item 1"
            " (decode_block_fused beams) and §1 item 4")
    if not ((top_k <= 0 or top_k == 1) and top_p >= 1.0):
        raise NotImplementedError(
            "filtered top-k/top-p sampling is not ported yet: ROADMAP.md §2"
            " item 1 (the filtered epilogue) and §1 item 3")
    if ecfg.quantize != "none":
        raise NotImplementedError(
            f"quantize={ecfg.quantize!r} is not ported yet: ROADMAP.md §2"
            " item 1 (int8 serving weights, int8kv, w8a8)")
    if ecfg.decode_steps < 2:
        raise NotImplementedError(
            "decode_steps=1 (the single-step decode_step kernel) is not ported"
            " yet: ROADMAP.md §2 item 3")
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


class SynthesisResult(NamedTuple):
    codes: np.ndarray  # [T_gen, 8]
    wave: Optional[np.ndarray]  # [T_gen * 320] or None
    ar: ARResult
    seconds: Dict[str, float]  # host-clock phase times, device-synchronized


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
                " the kernel path and the per-token path (ROADMAP.md §2 item 4"
                " for decode_attention)")
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
        check_slice(e, best_of=best_of, top_k=top_k, top_p=top_p)
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

        greedy = top_k == 1
        speculative = e.speculative in ("auto", "on")
        kernels = self.decode_mode == "megakernel"
        packed, draft = (self.packed_weights(speculative) if kernels else (None, None))
        generator = torch.Generator(device=dev)
        generator.manual_seed(int(seed) & 0x7FFFFFFF)
        with record_function("vallex.ar"):
            ar = ar_generate(
                self.model, cfg, text_pad, lang_pad, S, prompt_pad, Tp,
                generator=generator, top_k=top_k, temperature=temperature,
                gen_limit=max_gen_frames, s_text=s_text, p_audio=p_audio,
                t_audio=t_audio, dtype=self.dtype, decode_mode=self.decode_mode,
                decode_steps=e.decode_steps, speculative=speculative and kernels,
                packed=packed, packed_draft=draft,
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
