"""`masked_attention`: attention over the valid keys of a [text | audio]
sequence, with bounds per batch row (kernel: masked_attention.cu).

Key c is valid for row b and query qi iff
    c < x_len[b]
    or a1_lo <= c < a1_lo + a1_len[b]                 (range 1)
    or a2_lo <= c < a2_lo + a2_len[b] + q_off·qi      (range 2).
The bounds travel as one [3, B] int32 tensor on the queries' device
(`Bounds.lens`), so a launch adds no host sync. `attention_bounds` builds
them from the engine's layouts:
  single request (gen_len None): range 1 empty, range 2 the audio rows
      [s_text, s_text + audio_len + q_off·qi) — with q_off = 1 and the new
      columns already in the cache the draft/verify decode attention, with
      q_off = 0 and Tq = T the NAR's key-padding flash attention;
  batched requests (engine/ar.py::ar_generate_batch): range 1 the BOS +
      prompt rows [s_text, s_text + audio_len), range 2 the generated rows
      [gen_lo, gen_lo + gen_len + q_off·qi).
"""

from __future__ import annotations

import ctypes
import math
from typing import List, NamedTuple, Optional, Union

import torch

from .loader import check, launch_counts, library, stream_ptr

HEAD_DIM = 64

IntOrRows = Union[int, torch.Tensor]  # one value for every row, or [B]


class Bounds(NamedTuple):
    lens: torch.Tensor  # [3, B] int32: x_len, a1_len, a2_len per row
    a1_lo: int
    a2_lo: int
    q_off: int


def attention_bounds(
    B: int, *, x_len: IntOrRows, s_text: int, audio_len: IntOrRows, q_off: int,
    gen_lo: Optional[int] = None, gen_len: Optional[IntOrRows] = None,
    device=None,
) -> Bounds:
    """The engine's layouts (module docstring) → Bounds on `device`, built
    with fills and device copies only."""
    if isinstance(x_len, int) and not 0 < x_len <= s_text:
        raise ValueError(f"masked_attention: need 0 < x_len <= s_text, got {x_len}, {s_text}")
    if gen_len is None:
        rows, a2_lo = (x_len, 0, audio_len), s_text
    else:
        rows, a2_lo = (x_len, audio_len, gen_len), gen_lo
    lens = torch.empty((3, B), dtype=torch.int32, device=device)
    for i, v in enumerate(rows):
        if isinstance(v, torch.Tensor):
            lens[i].copy_(v.reshape(-1))
        else:
            lens[i].fill_(int(v))
    return Bounds(lens, s_text, a2_lo, q_off)


def step_bounds(b: Bounds, steps: int) -> List[Bounds]:
    """b at decode steps 0..steps-1: range 2 longer by k rows at step k.
    Three small launches for all steps; step k's lens are a view."""
    lens = b.lens.repeat(steps, 1, 1)  # [steps, 3, B]
    lens[:, 2] += torch.arange(steps, dtype=torch.int32, device=lens.device)[:, None]
    return [Bounds(lens[k], b.a1_lo, b.a2_lo, b.q_off) for k in range(steps)]


def valid_keys(Tq: int, C: int, b: Bounds) -> torch.Tensor:
    """[B, Tq, C] bool: the masking contract above."""
    dev = b.lens.device
    c = torch.arange(C, device=dev)[None, None, :]
    qi = torch.arange(Tq, device=dev)[None, :, None]
    xl, a1, a2 = (b.lens[i].long()[:, None, None] for i in range(3))
    r1 = (c >= b.a1_lo) & (c < b.a1_lo + a1)
    r2 = (c >= b.a2_lo) & (c < b.a2_lo + a2 + b.q_off * qi)
    return (c < xl) | r1 | r2


def masked_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bounds: Optional[Bounds] = None, **layout,
) -> torch.Tensor:
    """softmax(q·kᵀ/√hd over the valid keys)·v in f32; q [B, H, Tq, hd],
    k/v [B, H, C, hd] → [B, H, Tq, hd] in q's dtype. Bounds, or the
    keywords of `attention_bounds`."""
    B, _, Tq, hd = q.shape
    C = k.shape[-2]
    if bounds is None:
        bounds = attention_bounds(B, device=q.device, **layout)
    ok = valid_keys(Tq, C, bounds)[:, None]  # [B, 1, Tq, C]
    s = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    s = s.masked_fill(~ok, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return (p @ v.float()).to(q.dtype)


def _strides3(t: torch.Tensor):
    return (ctypes.c_longlong * 3)(t.stride(0), t.stride(1), t.stride(2))


def masked_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bounds: Optional[Bounds] = None, *,
    out: Optional[torch.Tensor] = None, site: str = "", **layout,
) -> torch.Tensor:
    """q [B, H, Tq, 64] f32 or bf16; k/v [B, H, C, 64] bf16 (any strides
    with a unit last stride) → [B, H, Tq, 64] in q's dtype, written into
    `out` when given (e.g. a strided view of a [Tq, H·64] buffer). Bounds,
    or the keywords of `attention_bounds`. CPU tensors take the plain
    version; CUDA tensors launch or raise."""
    B, H, Tq, hd = q.shape
    if bounds is None:
        bounds = attention_bounds(B, device=q.device, **layout)
    if q.device.type == "cpu":
        o = masked_attention_plain(q, k, v, bounds)
        if out is None:
            return o
        out.copy_(o)
        return out
    C = k.shape[2]
    if hd != HEAD_DIM or k.shape != (B, H, C, hd) or v.shape != k.shape:
        raise ValueError(f"masked_attention: want q [B,H,Tq,{HEAD_DIM}], k/v [B,H,C,{HEAD_DIM}]; got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"masked_attention: q must be f32 or bf16, got {q.dtype}")
    if k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise TypeError("masked_attention: k/v must be bf16")
    lens = bounds.lens
    if lens.shape != (3, B) or lens.dtype != torch.int32 or not lens.is_contiguous():
        raise ValueError(f"masked_attention: bounds must be a contiguous [3, {B}] int32 tensor")
    if out is None:
        out = torch.empty((B, H, Tq, hd), dtype=q.dtype, device=q.device)
    if out.shape != q.shape or out.dtype != q.dtype:
        raise ValueError("masked_attention: out must match q's shape and dtype")
    for t in (q, k, v, out, lens):
        if t.device != q.device or t.stride(-1) != 1:
            raise ValueError("masked_attention: tensors must share q's device and have a unit last stride")
    if k.stride() != v.stride():
        raise ValueError("masked_attention: k and v must share strides")
    if k.stride(2) % 8 or k.stride(1) % 8 or k.stride(0) % 8:
        raise ValueError("masked_attention: k/v rows must be 16-byte aligned")
    rc = library().vx_masked_attention(
        q.data_ptr(), _strides3(q), k.data_ptr(), v.data_ptr(), _strides3(k),
        out.data_ptr(), _strides3(out), int(q.dtype == torch.bfloat16),
        B, H, Tq, C, lens.data_ptr(), bounds.a1_lo, bounds.a2_lo, bounds.q_off,
        ctypes.c_float(1.0 / math.sqrt(hd)), stream_ptr(q),
    )
    check(rc, "masked_attention")
    launch_counts[("masked_attention", site)] += 1
    return out
