"""Training losses for VALL-E X, AR + NAR (port of vallex_tpu/train/loss.py).

  AR: teacher-forced next-token cross-entropy over codebook 0 with the
      BOS-prepend / EOS-append convention of `pad_y_eos` (reference:
      models/vallex.py:294-305).
  NAR: one uniformly drawn stage j in [1, 7] per step; the acoustic prompt
      follows the reference's `_prepare_prompts` (models/vallex.py:307-365)
      for every prefix_mode it defines (0 none, 1 prefix of the same
      utterance, 2 random window prepended, 4 dataset-provided prompt).

`use_flash` routes attention through the flash kernel with segment ids
(kernels/flash_attention.cu): the AR's prefix-causal mask over
[text | audio] and the NAR's key padding. The JAX package pads each region
to a multiple of 128 for the Pallas block shapes; the CUDA kernel takes any
length, so this port concatenates the regions as they are. The padded
rows' segment id is 0, which no valid row shares, and no padded row is in
a loss, so the losses equal the JAX package's on either route.

`rng` is a CPU torch.Generator. The stage and the prompt draws follow the
reference's distributions (`sample_nar_prompt`), not JAX's bits.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..config import ModelConfig
from ..models import vallex as V

Batch = Dict[str, torch.Tensor]

PROMPT_FRAMES = 225  # 24000/320 · 3 s (reference: models/vallex.py:323)
FLASH_AUTO_FRAMES = 800  # the JAX package's "auto" crossover (loss.py:400-404)


def _ce(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean cross-entropy; logits [..., V] f32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, device=like.device)


def ar_loss(
    m: V.VALLE,
    cfg: ModelConfig,
    text_ids: torch.Tensor,  # [B, S]
    lang_ids: torch.Tensor,  # [B, S]
    text_lens: torch.Tensor,  # [B]
    audio_cb0: torch.Tensor,  # [B, T] codebook-0 tokens
    audio_lens: torch.Tensor,  # [B]
    dtype=torch.bfloat16,
    use_flash: bool = False,
    remat: bool = True,
) -> torch.Tensor:
    B, S = text_ids.shape
    T = audio_cb0.shape[1]
    audio_cb0 = audio_cb0.long()
    # pad_y_eos: inputs [BOS, y]; targets [y, EOS at len] (later positions
    # are EOS too and masked out)
    y_in = torch.cat([torch.full((B, 1), cfg.bos_id, dtype=torch.long,
                                 device=audio_cb0.device), audio_cb0], dim=1)
    pos_t = _arange(T + 1, audio_cb0)[None]
    lens = audio_lens[:, None]
    targets = torch.where(pos_t < lens, torch.cat([audio_cb0, torch.zeros_like(audio_cb0[:, :1])], 1),
                          cfg.eos_id)

    x = V.text_input(m, text_ids.long(), lang_ids.long(), "ar", dtype)
    y_emb = V.ar_audio_input(m, y_in, 0, dtype)
    loss_mask = (pos_t <= lens).float()
    xy = torch.cat([x, y_emb], dim=1)  # [B, S + T + 1]

    if use_flash:
        text_seg = _arange(S, x)[None] < text_lens[:, None]
        seg = torch.cat([text_seg, pos_t <= lens], dim=1).int().contiguous()
        h = V.ar_forward(m, xy, None, remat=remat, segments=(seg, seg), prefix_flash=S)
        return _ce(V.ar_logits(m, h[:, S:]), targets, loss_mask)

    total = S + T + 1
    rows = _arange(total, x)[None, :, None]
    cols = _arange(total, x)[None, None, :]
    col_text_ok = cols < text_lens[:, None, None]
    col_audio_ok = (cols >= S) & ((cols - S) <= audio_lens[:, None, None])
    causal = torch.where(cols < S, True, cols <= rows)
    ok = (col_text_ok | col_audio_ok) & causal
    mask = torch.where(ok, 0.0, V.NEG_INF).float()[:, None]
    h = V.ar_forward(m, xy, mask, remat=remat)
    return _ce(V.ar_logits(m, h[:, S:]), targets, loss_mask)


def _sum_codebook_embs(emb: torch.Tensor, codes: torch.Tensor, upto: int, dtype) -> torch.Tensor:
    """emb[0][codes[..., 0]] + Σ_{1 <= j < upto} emb[j][codes[..., j]]."""
    y = emb[0][codes[..., 0]].to(dtype)
    for j in range(1, min(upto, codes.shape[-1])):
        y = y + emb[j][codes[..., j]].to(dtype)
    return y


def _sine_pe(m: V.VALLE, x: torch.Tensor, offset: int = 0) -> torch.Tensor:
    return m.nar_audio_position(m.pe, x, offset)


def nar_prepare(
    m: V.VALLE,
    cfg: ModelConfig,
    codes: torch.Tensor,  # [B, T, 8]
    audio_lens: torch.Tensor,  # [B]
    stage: int,  # in [1, 7]
    prefix_len: int,  # mode 1: drawn, <= 225; mode 2: the batch's window length
    prefix_mode: int = 1,
    prompt_codes: Optional[torch.Tensor] = None,  # [B, P, 8] (mode 4)
    prompt_starts: Optional[torch.Tensor] = None,  # [B] (mode 2 window starts)
    dtype=torch.bfloat16,
):
    """Audio-side inputs of one NAR pass, per prefix_mode (the JAX
    function's fixed-width layout: mode 2's window in a 225-frame buffer
    with its tail masked, the prompt's positions at offset 0 and the
    utterance's at offset prefix_len).

    → (y_pos [B, L, D], col_valid [B, L] bool, loss_mask [B, T] f32,
    targets [B, T] int64, y_start) with L = T (modes 0/1) or P + T (2/4);
    logits come from h[:, S + y_start:]."""
    B, T = codes.shape[:2]
    codes = codes.long()
    emb = m.nar_audio_embeddings.weight  # [8, 1025, D]
    pos_t = _arange(T, codes)[None, :]
    valid = pos_t < audio_lens[:, None]  # [B, T]
    targets = codes[..., stage]

    if prefix_mode in (0, 1):
        if prefix_mode == 0:
            y_emb = _sum_codebook_embs(emb, codes, stage, dtype)
            loss_mask = valid
        else:
            # the first prefix_len frames sum every codebook, the suffix
            # those below the stage; loss over the suffix
            in_prefix = pos_t < prefix_len
            y_emb = emb[0][codes[..., 0]].to(dtype)
            for j in range(1, cfg.num_quantizers):
                add = in_prefix | (~in_prefix & (j < stage))
                y_emb = y_emb + emb[j][codes[..., j]].to(dtype) * add[..., None].to(dtype)
            loss_mask = ~in_prefix & valid
        y_emb = y_emb * valid[..., None].to(dtype)
        return _sine_pe(m, y_emb), valid, loss_mask.float(), targets, 0

    if prefix_mode == 2:
        # window [start_b, start_b + prefix_len) of the same utterance, all
        # codebooks, prepended; its frames leave the loss (the reference
        # sets their codebook-`stage` code to its CE ignore_index)
        if prompt_starts is None:
            raise ValueError("prefix_mode 2 needs per-utterance prompt_starts")
        P = min(PROMPT_FRAMES, T)
        padded = torch.cat([codes, torch.zeros_like(codes[:, :P])], dim=1)
        idx = prompt_starts.long()[:, None] + _arange(P, codes)[None]  # [B, P]
        window = torch.gather(padded, 1, idx[..., None].expand(B, P, codes.shape[-1]))
        prompt_valid = _arange(P, codes)[None] < prefix_len  # [1, P]
        prompt_emb = _sum_codebook_embs(emb, window, cfg.num_quantizers, dtype)
        prompt_pos = _sine_pe(m, prompt_emb * prompt_valid[..., None].to(dtype))
        y_emb = _sum_codebook_embs(emb, codes, stage, dtype) * valid[..., None].to(dtype)
        y_pos = _sine_pe(m, y_emb, prefix_len)
        starts = prompt_starts.long()[:, None]
        in_window = (pos_t >= starts) & (pos_t < starts + prefix_len)
        col_valid = torch.cat([prompt_valid.expand(B, P), valid], dim=1)
        return (torch.cat([prompt_pos, y_pos], dim=1), col_valid,
                (valid & ~in_window).float(), targets, P)

    if prefix_mode == 4:
        # the dataset's prompt, prepended whole; loss over the utterance
        if prompt_codes is None:
            raise ValueError("prefix_mode 4 needs prompt_codes [B, P, 8]")
        P = prompt_codes.shape[1]
        prompt_pos = _sine_pe(m, _sum_codebook_embs(emb, prompt_codes.long(),
                                                    cfg.num_quantizers, dtype))
        y_emb = _sum_codebook_embs(emb, codes, stage, dtype) * valid[..., None].to(dtype)
        y_pos = _sine_pe(m, y_emb, P)
        col_valid = torch.cat([torch.ones_like(valid[:, :1]).expand(B, P), valid], dim=1)
        return torch.cat([prompt_pos, y_pos], dim=1), col_valid, valid.float(), targets, P

    raise ValueError(f"prefix_mode must be 0/1/2/4, got {prefix_mode}")


def nar_loss(
    m: V.VALLE,
    cfg: ModelConfig,
    text_ids: torch.Tensor,  # [B, S]
    lang_ids: torch.Tensor,
    text_lens: torch.Tensor,
    codes: torch.Tensor,  # [B, T, 8]
    audio_lens: torch.Tensor,  # [B]
    stage: int,  # in [1, 7]
    prefix_len: int,
    dtype=torch.bfloat16,
    prefix_mode: int = 1,
    prompt_codes: Optional[torch.Tensor] = None,
    prompt_starts: Optional[torch.Tensor] = None,
    use_flash: bool = False,
    remat: bool = True,
) -> torch.Tensor:
    S, T = text_ids.shape[1], codes.shape[1]
    x = V.text_input(m, text_ids.long(), lang_ids.long(), "nar", dtype)
    y_pos, col_valid, loss_mask, targets, y_start = nar_prepare(
        m, cfg, codes, audio_lens, stage, prefix_len, prefix_mode, prompt_codes,
        prompt_starts, dtype)
    text_valid = _arange(S, x)[None, :] < text_lens[:, None]
    xy = torch.cat([x, y_pos], dim=1)
    ok = torch.cat([text_valid, col_valid], dim=1)
    if use_flash:
        # the NAR mask is pure key padding: segment 1 valid, 0 padding
        seg = ok.int().contiguous()
        h = V.nar_forward_stage(m, xy, stage - 1, segments=(seg, seg), remat=remat)
    else:
        mask = torch.where(ok, 0.0, V.NEG_INF).float()[:, None, None, :]
        h = V.nar_forward_stage(m, xy, stage - 1, mask, remat=remat)
    logits = V.nar_logits(m, h[:, S + y_start: S + y_start + T], stage - 1)
    return _ce(logits, targets, loss_mask)


def sample_nar_prompt(rng: torch.Generator, audio_lens: torch.Tensor, prefix_mode: int
                      ) -> Tuple[int, Optional[torch.Tensor]]:
    """(prefix_len, prompt_starts) by the reference's samplers.

    mode 1: prefix_len ~ U[0, 2·⌊min_len/4⌋), then capped at 225
            (models/vallex.py:321-323, torch.randint's exclusive upper end);
    mode 2: prefix_len = min(225, ⌊min_len/4⌋); per-utterance window start
            ~ U[0, len_b − prefix_len], inclusive (models/vallex.py:339-342,
            random.Random.randint);
    modes 0/4: (0, None), nothing drawn."""
    min_len = int(audio_lens.min())
    if prefix_mode == 1:
        hi = max((min_len // 4) * 2, 1)
        return min(int(torch.randint(0, hi, (), generator=rng)), PROMPT_FRAMES), None
    if prefix_mode == 2:
        prefix_len = min(min_len // 4, PROMPT_FRAMES)
        hi = torch.clamp(audio_lens.cpu().long() - prefix_len + 1, min=1)
        u = torch.rand(hi.shape, generator=rng, dtype=torch.float64)
        starts = torch.minimum((u * hi).long(), hi - 1)
        return prefix_len, starts.to(audio_lens.device)
    return 0, None


def _use_flash(use_flash, batch: Batch) -> bool:
    if use_flash == "auto":
        # the JAX package's routing, measured on a TPU (loss.py:400-404)
        return batch["codes"].shape[1] >= FLASH_AUTO_FRAMES
    return bool(use_flash)


def _draw_stage(rng: torch.Generator, cfg: ModelConfig) -> int:
    return int(torch.randint(1, cfg.num_quantizers, (), generator=rng))


def total_loss(
    m: V.VALLE,
    cfg: ModelConfig,
    batch: Batch,
    rng: torch.Generator,
    dtype=torch.bfloat16,
    prefix_mode: int = 1,
    use_flash=False,
    remat: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """AR + NAR objective over a collated batch (tensors on the model's
    device). prefix_mode 4 reads batch["prompt_codes"] [B, P, 8];
    use_flash True, False or "auto" (flash from 800 frames on)."""
    use_flash = _use_flash(use_flash, batch)
    stage = _draw_stage(rng, cfg)
    prefix_len, prompt_starts = sample_nar_prompt(rng, batch["audio_lens"], prefix_mode)
    l_ar = ar_loss(
        m, cfg, batch["text_ids"], batch["lang_ids"], batch["text_lens"],
        batch["codes"][..., 0], batch["audio_lens"], dtype, use_flash=use_flash, remat=remat)
    l_nar = nar_loss(
        m, cfg, batch["text_ids"], batch["lang_ids"], batch["text_lens"], batch["codes"],
        batch["audio_lens"], stage, prefix_len, dtype, prefix_mode=prefix_mode,
        prompt_codes=batch.get("prompt_codes") if prefix_mode == 4 else None,
        prompt_starts=prompt_starts, use_flash=use_flash, remat=remat)
    loss = l_ar + l_nar
    return loss, {"loss": loss, "ar_loss": l_ar, "nar_loss": l_nar}


# ---------------------------------------------------------------------------
# Sequence-packed training: several utterances share a batch row, back to
# back, with per-token positions (the PE restarts in each utterance) and
# per-token segment ids (the flash kernel keeps attention within each
# utterance). Row layout: text region [text_1 | text_2 | … | pad] (the
# prefix block, bidirectional within a segment), then audio region
# [BOS y_1 | BOS y_2 | … | pad] (causal; an utterance's audio sees its own
# text through the segment match). data/dataset.py::collate_packed builds
# the per-token arrays.
# ---------------------------------------------------------------------------

def _packed_input(m: V.VALLE, stack: str, ids, lang_ids, pos, dtype) -> torch.Tensor:
    """Token emb (+ language emb) + alpha·PE[pos] with per-token positions."""
    if stack in ("ar_text", "nar_text"):
        s = stack.split("_")[0]
        x = getattr(m, f"{s}_text_embedding")(ids.long(), dtype)
        x = x + getattr(m, f"{s}_language_embedding")(lang_ids.long(), dtype)
        alpha = getattr(m, f"{s}_text_position").alpha
    else:  # "ar_audio"
        x = m.ar_audio_embedding(ids.long(), dtype)
        alpha = m.ar_audio_position.alpha
    pe = m.pe[pos.long()].to(x.dtype)
    return x + (alpha * pe).to(x.dtype)


def ar_loss_packed(m: V.VALLE, cfg: ModelConfig, batch: Batch, dtype=torch.bfloat16,
                   remat: bool = True) -> torch.Tensor:
    """AR loss over a packed batch (flash only: the segment ids express the
    packing); p_targets already carry each utterance's EOS."""
    x = _packed_input(m, "ar_text", batch["p_text_ids"], batch["p_lang_ids"],
                      batch["p_text_pos"], dtype)
    y = _packed_input(m, "ar_audio", batch["p_audio_in"], None, batch["p_audio_pos"], dtype)
    Ws = x.shape[1]
    seg = torch.cat([batch["p_text_seg"], batch["p_audio_seg"]], dim=1).int().contiguous()
    h = V.ar_forward(m, torch.cat([x, y], dim=1), None, remat=remat, segments=(seg, seg),
                     prefix_flash=Ws)
    return _ce(V.ar_logits(m, h[:, Ws:]), batch["p_targets"], batch["p_loss_mask"].float())


def nar_loss_packed(m: V.VALLE, cfg: ModelConfig, batch: Batch, stage: int, prefix_len: int,
                    dtype=torch.bfloat16, prefix_mode: int = 1,
                    remat: bool = True) -> torch.Tensor:
    """NAR loss over a packed batch, prefix modes 0/1 (in_prefix by
    position id, validity by segment id; modes 2/4 prepend prompt buffers
    and stay unpacked)."""
    if prefix_mode not in (0, 1):
        raise ValueError("packed NAR supports prefix modes 0/1")
    codes = batch["p_codes"].long()
    pos = batch["p_codes_pos"].long()
    seg = batch["p_codes_seg"]
    valid = seg > 0
    emb = m.nar_audio_embeddings.weight
    targets = codes[..., stage]
    if prefix_mode == 0:
        y_emb = _sum_codebook_embs(emb, codes, stage, dtype)
        loss_mask = valid
    else:
        in_prefix = pos < prefix_len
        y_emb = emb[0][codes[..., 0]].to(dtype)
        for j in range(1, cfg.num_quantizers):
            add = in_prefix | (~in_prefix & (j < stage))
            y_emb = y_emb + emb[j][codes[..., j]].to(dtype) * add[..., None].to(dtype)
        loss_mask = ~in_prefix & valid
    y_emb = y_emb * valid[..., None].to(dtype)
    pe = m.pe[pos].to(y_emb.dtype)
    y_pos = y_emb + (m.nar_audio_position.alpha * pe).to(y_emb.dtype)

    x = _packed_input(m, "nar_text", batch["p_text_ids"], batch["p_lang_ids"],
                      batch["p_text_pos"], dtype)
    Ws = x.shape[1]
    seg_full = torch.cat([batch["p_text_seg"], seg], dim=1).int().contiguous()
    h = V.nar_forward_stage(m, torch.cat([x, y_pos], dim=1), stage - 1,
                            segments=(seg_full, seg_full), remat=remat)
    return _ce(V.nar_logits(m, h[:, Ws:], stage - 1), targets, loss_mask.float())


def total_loss_packed(m: V.VALLE, cfg: ModelConfig, batch: Batch, rng: torch.Generator,
                      dtype=torch.bfloat16, prefix_mode: int = 1, remat: bool = True
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """AR + NAR objective over a packed batch (collate_packed). The NAR
    prefix length draws from the shortest real utterance, as unpacked."""
    stage = _draw_stage(rng, cfg)
    prefix_len, _ = sample_nar_prompt(rng, batch["audio_lens"], prefix_mode)
    l_ar = ar_loss_packed(m, cfg, batch, dtype, remat=remat)
    l_nar = nar_loss_packed(m, cfg, batch, stage, prefix_len, dtype,
                            prefix_mode=prefix_mode, remat=remat)
    loss = l_ar + l_nar
    return loss, {"loss": loss, "ar_loss": l_ar, "nar_loss": l_nar}


def debug_activations(m: V.VALLE, cfg: ModelConfig, batch: Batch, dtype=torch.bfloat16
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(text-region hidden [B, S, D], audio-region hidden [B, T, D]) of a
    teacher-forced AR pass, for a training visualizer."""
    text_ids = batch["text_ids"].long()
    S = text_ids.shape[1]
    x = V.text_input(m, text_ids, batch["lang_ids"].long(), "ar", dtype)
    y = V.ar_audio_input(m, batch["codes"][..., 0].long(), 0, dtype)
    xy = torch.cat([x, y], dim=1)
    total = xy.shape[1]
    rows = _arange(total, x)[:, None]
    cols = _arange(total, x)[None, :]
    causal = torch.where(cols < S, True, cols <= rows)
    mask = torch.where(causal, 0.0, V.NEG_INF).float()[None, None]
    with torch.no_grad():
        h = V.ar_forward(m, xy, mask, remat=False)
    return h[:, :S], h[:, S:]
