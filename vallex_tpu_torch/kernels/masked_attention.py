"""`masked_attention`: attention over the valid keys of a [text | audio]
sequence (kernel: masked_attention.cu).

Key c is valid for query qi iff c < x_len or
s_text <= c < s_text + audio_len + q_off·qi. With q_off = 1 and the new
columns already in the cache it is the draft/verify decode attention; with
q_off = 0 and Tq = T it is the NAR's key-padding flash attention.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .loader import check, launch_counts, library, stream_ptr

HEAD_DIM = 64


def valid_keys(
    Tq: int, C: int, x_len: int, s_text: int, audio_len: int, q_off: int,
    device=None,
) -> torch.Tensor:
    """[Tq, C] bool: the masking contract above."""
    c = torch.arange(C, device=device)[None, :]
    qi = torch.arange(Tq, device=device)[:, None]
    audio = (c >= s_text) & (c < s_text + audio_len + q_off * qi)
    return (c < x_len) | audio


def masked_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    x_len: int, s_text: int, audio_len: int, q_off: int,
) -> torch.Tensor:
    """softmax(q·kᵀ/√hd over the valid keys)·v in f32; q [B, H, Tq, hd],
    k/v [B, H, C, hd] → [B, H, Tq, hd] in q's dtype."""
    Tq, C, hd = q.shape[-2], k.shape[-2], q.shape[-1]
    ok = valid_keys(Tq, C, x_len, s_text, audio_len, q_off, q.device)
    s = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    s = s.masked_fill(~ok, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return (p @ v.float()).to(q.dtype)


def _strides3(t: torch.Tensor):
    return (ctypes.c_longlong * 3)(t.stride(0), t.stride(1), t.stride(2))


def masked_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    x_len: int, s_text: int, audio_len: int, q_off: int,
    out: Optional[torch.Tensor] = None, site: str = "",
) -> torch.Tensor:
    """q [B, H, Tq, 64] f32 or bf16; k/v [B, H, C, 64] bf16 (any strides
    with a unit last stride) → [B, H, Tq, 64] in q's dtype, written into
    `out` when given (e.g. a strided view of a [Tq, H·64] buffer). CPU
    tensors take the plain version; CUDA tensors launch or raise."""
    if q.device.type == "cpu":
        o = masked_attention_plain(
            q, k, v, x_len=x_len, s_text=s_text, audio_len=audio_len,
            q_off=q_off,
        )
        if out is None:
            return o
        out.copy_(o)
        return out
    B, H, Tq, hd = q.shape
    C = k.shape[2]
    if hd != HEAD_DIM or k.shape != (B, H, C, hd) or v.shape != k.shape:
        raise ValueError(f"masked_attention: want q [B,H,Tq,{HEAD_DIM}], k/v [B,H,C,{HEAD_DIM}]; got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"masked_attention: q must be f32 or bf16, got {q.dtype}")
    if k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise TypeError("masked_attention: k/v must be bf16")
    if out is None:
        out = torch.empty((B, H, Tq, hd), dtype=q.dtype, device=q.device)
    if out.shape != q.shape or out.dtype != q.dtype:
        raise ValueError("masked_attention: out must match q's shape and dtype")
    for t in (q, k, v, out):
        if t.device != q.device or t.stride(-1) != 1:
            raise ValueError("masked_attention: tensors must share q's device and have a unit last stride")
    if k.stride() != v.stride():
        raise ValueError("masked_attention: k and v must share strides")
    if k.stride(2) % 8 or k.stride(1) % 8 or k.stride(0) % 8:
        raise ValueError("masked_attention: k/v rows must be 16-byte aligned")
    if not 0 < x_len <= s_text:
        raise ValueError(f"masked_attention: need 0 < x_len <= s_text, got {x_len}, {s_text}")
    if s_text + audio_len + q_off * (Tq - 1) > C:
        raise ValueError("masked_attention: valid keys run past the cache")
    rc = library().vx_masked_attention(
        q.data_ptr(), _strides3(q), k.data_ptr(), v.data_ptr(), _strides3(k),
        out.data_ptr(), _strides3(out), int(q.dtype == torch.bfloat16),
        B, H, Tq, x_len, s_text, audio_len, q_off,
        ctypes.c_float(1.0 / math.sqrt(hd)), stream_ptr(q),
    )
    check(rc, "masked_attention")
    launch_counts[("masked_attention", site)] += 1
    return out
