"""NAR engine: codebooks 1..7 in 7 full-sequence passes (port of
vallex_tpu/engine/nar.py::nar_generate, prefix_mode 1), for one request or
R batched requests with their own x_len, t_len and prompt_len.

The prompt region's embeddings for codebooks 1..7 are summed into the
running embedding once; stage s runs the AdaLN decoder conditioned on stage
embedding s, argmax-decodes codebook s+1 and adds its embedding on the
generated suffix. The mask is pure key padding (valid text columns and
valid audio slots): from s_text + t_audio >= 1536 attention goes through
the flash forward (`flash_attention_fwd`, the JAX package's Pallas flash
attention) with that rule as segment ids (ok, ok) and prefix C, below that
through the plain masked core, as in the JAX package. With segments, pad
queries see the pad keys, as in JAX; their rows are discarded.
"""

from __future__ import annotations

import torch

from ..config import ModelConfig
from ..kernels.flash_attention import flash_attention_fwd
from ..kernels.masked_attention import IntOrRows
from ..models import vallex as V

FLASH_MIN_LEN = 1536
SITE = "flash_attention"
SITE_BATCHED = "flash_attention_batched"


def _col(v: IntOrRows):
    """int → itself; [R] tensor → [R, 1] (broadcasts over positions)."""
    return v.reshape(-1, 1) if isinstance(v, torch.Tensor) else v


def key_padding(s_text: int, t_audio: int, x_len: IntOrRows, t_len: IntOrRows,
                device=None) -> torch.Tensor:
    """[R or 1, s_text + t_audio] bool: the valid text columns and the valid
    audio slots of each row."""
    cols = torch.arange(s_text + t_audio, device=device)[None, :]
    return torch.where(cols < s_text, cols < _col(x_len), (cols - s_text) < _col(t_len))


def flash_attention_fn(ok: torch.Tensor, R: int):
    """The NAR's attention at C >= FLASH_MIN_LEN: the flash forward with the
    key-padding rule `ok` as segment ids (ok, ok) and prefix C, as the JAX
    package's NAR (valid rows see exactly the valid keys)."""
    C = ok.shape[-1]
    seg = ok.to(torch.int32).expand(R, C).contiguous()  # valid 1, padding 0
    site = SITE if R == 1 else SITE_BATCHED

    def attention(q, k, v):
        return flash_attention_fwd(q, k, v, seg, seg, C, site=site)[0]
    return attention


def nar_generate(
    model: V.VALLE,
    cfg: ModelConfig,
    text_ids: torch.Tensor,  # [R, s_text] int64
    lang_ids: torch.Tensor,  # [R, s_text]
    x_len: IntOrRows,
    codes_in: torch.Tensor,  # [R, t_audio, 8]: prompt rows full, then AR cb0
    t_len: IntOrRows,  # valid audio frames (prompt + generated)
    prompt_len: IntOrRows,
    *,
    dtype: torch.dtype,
    add_lang: bool = True,
) -> torch.Tensor:
    """→ codes [R, t_audio, 8] (valid region [prompt_len, t_len) per row)."""
    R, t_audio = codes_in.shape[:2]
    s_text = text_ids.shape[1]
    dev = codes_in.device
    tables = model.nar_audio_embeddings.weight  # [8, 1025, D]
    x = V.text_input(model, text_ids, lang_ids, "nar", dtype, add_lang)

    rows = torch.arange(t_audio, device=dev)[None, :]
    tl, pl = _col(t_len), _col(prompt_len)
    in_prompt = (rows < pl)[..., None]  # [R, TA, 1]
    in_suffix = ((rows >= pl) & (rows < tl))[..., None]
    y_emb = tables[0][codes_in[..., 0]].to(dtype)
    for j in range(1, cfg.num_quantizers):
        y_emb = y_emb + torch.where(in_prompt, tables[j][codes_in[..., j]].to(dtype), 0)

    ok = key_padding(s_text, t_audio, x_len, t_len, dev)
    mask, attention = None, None
    if s_text + t_audio >= FLASH_MIN_LEN:
        attention = flash_attention_fn(ok, R)
    else:
        mask = torch.where(ok, 0.0, V.NEG_INF)[:, None, None, :]

    stage_codes = []
    for stage in range(cfg.num_quantizers - 1):
        y_pos = model.nar_audio_position(model.pe, y_emb)
        xy = torch.cat([x, y_pos], dim=1)
        h = V.nar_forward_stage(model, xy, stage, mask, attention)
        logits = V.nar_logits(model, h[:, s_text:], stage)  # [R, TA, 1024]
        samples = torch.argmax(logits, dim=-1)
        y_emb = y_emb + torch.where(in_suffix, tables[stage + 1][samples].to(dtype), 0)
        stage_codes.append(samples)
    out = torch.stack([codes_in[..., 0].long()] + stage_codes, dim=-1)
    return torch.where(in_prompt, codes_in.long(), out)
