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
Grouped mode (best_of samples of R requests, B = R·beams request-major
rows): `prefix` = (pk, pv) [R, H, P, hd] holds each request's text + BOS +
prompt rows once; row b reads its text and range-1 keys from prefix row
b // beams and its range-2 keys from its own cache row, where the generated
rows start at gen_lo = 0. It equals the batched layout with the prefix
repeated per sample in front of the generated rows (`with_prefix`), which
is the plain version.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, NamedTuple, Optional, Tuple, Union

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


Prefix = Tuple[torch.Tensor, torch.Tensor]  # grouped mode: (pk, pv) [R, H, P, hd]


def with_prefix(k: torch.Tensor, v: torch.Tensor, bounds: Bounds, prefix: Prefix,
                beams: int):
    """The grouped layout as the batched one: each row's prefix rows
    (repeated per sample) in front of its own rows, range 2 shifted by P."""
    pk, pv = (p.repeat_interleave(beams, dim=0).to(k.dtype) for p in prefix)
    P = pk.shape[2]
    return (torch.cat([pk, k], dim=2), torch.cat([pv, v], dim=2),
            bounds._replace(a2_lo=bounds.a2_lo + P))


def masked_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bounds: Optional[Bounds] = None, *, prefix: Optional[Prefix] = None,
    beams: int = 1, **layout,
) -> torch.Tensor:
    """softmax(q·kᵀ/√hd over the valid keys)·v in f32; q [B, H, Tq, hd],
    k/v [B, H, C, hd] (+ a grouped-mode prefix) → [B, H, Tq, hd] in q's
    dtype. Bounds, or the keywords of `attention_bounds`."""
    B, _, Tq, hd = q.shape
    if bounds is None:
        bounds = attention_bounds(B, device=q.device, **layout)
    if prefix is not None:
        k, v, bounds = with_prefix(k, v, bounds, prefix, beams)
    C = k.shape[-2]
    ok = valid_keys(Tq, C, bounds)[:, None]  # [B, 1, Tq, C]
    s = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    s = s.masked_fill(~ok, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return (p @ v.float()).to(q.dtype)


def _strides3(t: torch.Tensor):
    return (ctypes.c_longlong * 3)(t.stride(0), t.stride(1), t.stride(2))


KINDS = {  # (q/out dtype, k/v dtype) → the launcher's `kinds`
    (torch.float32, torch.bfloat16): 0,
    (torch.bfloat16, torch.bfloat16): 1,
    (torch.float32, torch.float32): 2,
}


def masked_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bounds: Optional[Bounds] = None, *,
    prefix: Optional[Prefix] = None, beams: int = 1,
    out: Optional[torch.Tensor] = None, site: str = "", **layout,
) -> torch.Tensor:
    """q [B, H, Tq, 64]; k/v [B, H, C, 64] (any strides with a unit last
    stride): f32 q with bf16 k/v (decode), all bf16 (NAR) or all f32
    (compute_dtype="float32") → [B, H, Tq, 64] in q's dtype, written into
    `out` when given (e.g. a strided view of a [Tq, H·64] buffer). Bounds,
    or the keywords of `attention_bounds`; `prefix` + `beams` for the
    grouped mode. CPU tensors take the plain version; CUDA tensors launch
    or raise."""
    B, H, Tq, hd = q.shape
    if bounds is None:
        bounds = attention_bounds(B, device=q.device, **layout)
    if q.device.type == "cpu":
        o = masked_attention_plain(q, k, v, bounds, prefix=prefix, beams=beams)
        if out is None:
            return o
        out.copy_(o)
        return out
    C = k.shape[2]
    if hd != HEAD_DIM or k.shape != (B, H, C, hd) or v.shape != k.shape:
        raise ValueError(f"masked_attention: want q [B,H,Tq,{HEAD_DIM}], k/v [B,H,C,{HEAD_DIM}]; got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    kinds = KINDS.get((q.dtype, k.dtype))
    if kinds is None or v.dtype != k.dtype:
        raise TypeError(f"masked_attention: q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype} not taken"
                        " (f32/bf16/bf16, bf16/bf16/bf16 or f32/f32/f32)")
    lens = bounds.lens
    if lens.shape != (3, B) or lens.dtype != torch.int32 or not lens.is_contiguous():
        raise ValueError(f"masked_attention: bounds must be a contiguous [3, {B}] int32 tensor")
    if out is None:
        out = torch.empty((B, H, Tq, hd), dtype=q.dtype, device=q.device)
    if out.shape != q.shape or out.dtype != q.dtype:
        raise ValueError("masked_attention: out must match q's shape and dtype")
    kv = (k, v) if prefix is None else (k, v, *prefix)
    for t in (q, out, lens) + kv:
        if t.device != q.device or t.stride(-1) != 1:
            raise ValueError("masked_attention: tensors must share q's device and have a unit last stride")
    align = 16 // k.element_size()
    for a, b in zip(kv[::2], kv[1::2]):
        if a.stride() != b.stride():
            raise ValueError("masked_attention: k and v (and the prefix pair) must share strides")
        if any(st % align for st in a.stride()[:3]):
            raise ValueError("masked_attention: k/v rows must be 16-byte aligned")
    P, pk, pv, ps = 0, None, None, None
    if prefix is not None:
        pk, pv = prefix
        if pk.dtype != k.dtype or pv.dtype != k.dtype or pk.shape != pv.shape \
                or pk.shape[0] * beams != B or pk.shape[1] != H or pk.shape[3] != hd:
            raise ValueError(f"masked_attention: prefix must be [{B}/{beams}, {H}, P, {hd}] of"
                             f" k's dtype, got {tuple(pk.shape)} {pk.dtype}")
        P, ps = pk.shape[2], _strides3(pk)
        pk, pv = pk.data_ptr(), pv.data_ptr()
    elif beams != 1:
        raise ValueError("masked_attention: beams > 1 needs the prefix")
    rc = library().vx_masked_attention(
        q.data_ptr(), _strides3(q), k.data_ptr(), v.data_ptr(), _strides3(k),
        pk, pv, ps, P, beams, out.data_ptr(), _strides3(out), kinds,
        B, H, Tq, C, lens.data_ptr(), bounds.a1_lo, bounds.a2_lo, bounds.q_off,
        ctypes.c_float(1.0 / math.sqrt(hd)), stream_ptr(q),
    )
    check(rc, "masked_attention")
    launch_counts[("masked_attention", site)] += 1
    return out
