"""`masked_attention`: the decode attention — any number of queries over
the valid keys of a [text | audio] cache, with bounds per batch row, head
dim 64 or 128 on the card (kernel: masked_attention.cu, a cluster of
SPLIT_BLOCKS blocks per (row, head, group of QUERY_GROUP queries) splitting
the keys, merged through distributed shared memory). The NAR's
full-sequence attention is `flash_attention`'s.

Key c is valid for row b and query qi iff
    c < x_len[b]
    or a1_lo <= c < a1_lo + a1_len[b]                 (range 1)
    or a2_lo <= c < a2_lo + a2_len[b] + q_off·qi      (range 2).
The bounds travel as one [3, B] int32 tensor on the queries' device
(`Bounds.lens`), so a launch adds no host sync. `attention_bounds` builds
them from the engine's layouts:
  single request (gen_len None): range 1 empty, range 2 the audio rows
      [s_text, s_text + audio_len + q_off·qi) — with q_off = 1 and the new
      columns already in the cache the draft/verify decode attention;
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

int8 K/V (the int8 KV cache): `kv_scales` = (ks, vs), one f32 per head of
this layer; k/v hold clip(round(x / s)). The k-scale multiplies the query
and the v-scale the output, so the attention runs on the int8 values.
Own-column mode (`new_kv` = this step's (k, v) [B, H, 1, hd] f32, `slot`,
Tq = 1): the walk stops before cache row `slot` (range 2 ends there), the
new column is folded in unrounded (int8: k / ks and v / vs, unrounded), and
the column is written into row `slot` of k/v, rounded to the cache type or
quantized (`write_column`). `slot` is a host int, or a one-element int32
tensor on q's device that the kernel reads (so one captured launch serves
every row); a device row outside [0, C) writes nothing. The TPU decode
kernels fold their own column this way (vallex_tpu/ops/decode_step.py,
decode_attention.py, and decode_block.py with kv_scales).

The kernel walks a row's virtual keys (text, then range 1, then range 2;
`key_counts`) in tiles of SPLIT_TILE; the cluster's block r takes the r-th
run of ceil(tiles / SPLIT_BLOCKS) tiles, counted for the group's last query
(`split_chunks_plain`), and the blocks' softmax states merge in rank order
(`masked_attention_split_plain`, the kernel's arithmetic in f32 torch; the
tests and chip_smoke.py use it, the port does not).
"""

from __future__ import annotations

import ctypes
import math
import time
from typing import List, NamedTuple, Optional, Tuple, Union

import torch

from .loader import HEAD_DIMS, check, count_launch, library, stream_ptr

MAX_QUERIES = 65535  # the kernel's limit on Tq
# the kernel's partition (masked_attention.cu: ATT_CLUSTER, ATT_TILE, ATT_QG)
SPLIT_BLOCKS = 8  # blocks a cluster: a (row, head, query group)'s keys split over them
SPLIT_TILE = 32  # keys a tile
QUERY_GROUP = 16  # queries sharing one read of K/V
NEG_BIG = -1e30  # the kernel's VX_NEG_BIG: the max over no keys

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


Scales = Tuple[torch.Tensor, torch.Tensor]  # int8 K/V: (ks, vs) [H] f32
NewKV = Tuple[torch.Tensor, torch.Tensor]  # own column: (k, v) [B, H, 1, hd] f32


def _column(x: torch.Tensor, dtype: torch.dtype,
            scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """This step's k or v [B, H, 1, hd] as the cache stores it: rounded to
    `dtype`, or for int8 clip(round_half_even(x / scale), ±127) with the
    head's scale [H]."""
    if dtype != torch.int8:
        return x.to(dtype)
    q = torch.round(x.float() / scale.float()[None, :, None, None])
    return torch.clamp(q, -127.0, 127.0).to(torch.int8)


def masked_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bounds: Optional[Bounds] = None, *, prefix: Optional[Prefix] = None,
    beams: int = 1, kv_scales: Optional[Scales] = None,
    new_kv: Optional[NewKV] = None, slot: Optional[int] = None, **layout,
) -> torch.Tensor:
    """softmax(q·kᵀ/√hd over the valid keys)·v in f32; q [B, H, Tq, hd],
    k/v [B, H, C, hd] (+ a grouped-mode prefix) → [B, H, Tq, hd] in q's
    dtype. Bounds, or the keywords of `attention_bounds`. With
    `kv_scales` the int8 k/v are dequantized through q·ks and out·vs; with
    `new_kv` the keys stop before `slot` and the new column is folded in
    (module docstring). Reads k/v only; the column write is the caller's
    (`write_column`)."""
    B, H, Tq, hd = q.shape
    if bounds is None:
        bounds = attention_bounds(B, device=q.device, **layout)
    if prefix is not None:
        k, v, bounds = with_prefix(k, v, bounds, prefix, beams)
        if new_kv is not None:
            slot += prefix[0].shape[2]
    C = k.shape[-2]
    ok = valid_keys(Tq, C, bounds)[:, None]  # [B, 1, Tq, C]
    qf, kf, vf = q.float(), k.float(), v.float()
    if kv_scales is not None:
        ks, vs = (s.float()[None, :, None, None] for s in kv_scales)
        qf = qf * ks
    if new_kv is not None:
        if Tq != 1:
            raise ValueError("masked_attention: the own-column mode takes one query")
        ok = ok & (torch.arange(C, device=ok.device) < slot)
        nk, nv = (t.float() for t in new_kv)
        if kv_scales is not None:  # cache units, unrounded
            nk, nv = nk / ks, nv / vs
        kf, vf = torch.cat([kf, nk], dim=2), torch.cat([vf, nv], dim=2)
        ok = torch.cat([ok, ok.new_ones(ok.shape[:-1] + (1,))], dim=-1)
    s = (qf @ kf.transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    s = s.masked_fill(~ok, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = p @ vf
    if kv_scales is not None:
        o = o * vs
    return o.to(q.dtype)


def _text_counts(bounds: Bounds, C: int, P: Optional[int]):
    """([B], [B]) int64: the virtual keys before range 1 (the text rows) and
    before range 2 (text + range 1), clamped into the rows they read (the
    prefix's P in the grouped mode, else the cache's C)."""
    lens = bounds.lens.long()
    c1 = C if P is None else P
    x = lens[0].clamp(min=0).clamp(max=c1)
    return x, x + lens[1].clamp(min=0).clamp(max=max(c1 - bounds.a1_lo, 0))


def key_counts(bounds: Bounds, Tq: int, C: int, *, P: Optional[int] = None,
               slot: Optional[int] = None) -> torch.Tensor:
    """[B, Tq] int64: the virtual keys (text, range 1, then range 2) query qi
    of row b sees, each range clamped into the rows it reads as the kernel
    clamps it; P: the grouped mode's prefix rows (text and range 1 read
    there), slot: the own-column mode's (range 2 stops before it)."""
    _, x_a1 = _text_counts(bounds, C, P)
    cap = max((C if slot is None else min(C, slot)) - bounds.a2_lo, 0)
    qi = torch.arange(Tq, device=x_a1.device)
    a2 = (bounds.lens[2].long()[:, None] + bounds.q_off * qi).clamp(min=0).clamp(max=cap)
    return x_a1[:, None] + a2


def split_chunks_plain(bounds: Bounds, Tq: int, C: int, *, P: Optional[int] = None,
                       slot: Optional[int] = None) -> torch.Tensor:
    """[B, G, SPLIT_BLOCKS, 2] int64, G = ceil(Tq / QUERY_GROUP): the
    virtual keys [start, end) that cluster rank r of row b's query group g
    walks, by the kernel's rule: the group's count n (its largest query's,
    `key_counts`) falls into ceil(n / SPLIT_TILE) tiles, rank r takes tiles
    [r·k, r·k + k) with k = ceil(tiles / SPLIT_BLOCKS), cut at the count. A
    chunk starts on a tile boundary, so its tiles are the SPLIT_TILE-key
    runs from its start. It depends on the count alone."""
    counts = key_counts(bounds, Tq, C, P=P, slot=slot)
    B = counts.shape[0]
    G = -(-Tq // QUERY_GROUP)
    out = torch.zeros((B, G, SPLIT_BLOCKS, 2), dtype=torch.int64, device=counts.device)
    rank = torch.arange(SPLIT_BLOCKS, device=counts.device)
    for g in range(G):
        lo, hi = g * QUERY_GROUP, min(Tq, (g + 1) * QUERY_GROUP)
        n = torch.maximum(counts[:, lo], counts[:, hi - 1])[:, None]  # [B, 1]
        tiles = (n + SPLIT_TILE - 1) // SPLIT_TILE
        per = (tiles + SPLIT_BLOCKS - 1) // SPLIT_BLOCKS
        t0 = torch.minimum(rank * per, tiles)
        t1 = torch.minimum(t0 + per, tiles)
        out[:, g, :, 0] = torch.minimum(t0 * SPLIT_TILE, n)
        out[:, g, :, 1] = torch.minimum(t1 * SPLIT_TILE, n)
    return out


def masked_attention_split_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bounds: Optional[Bounds] = None, *, prefix: Optional[Prefix] = None,
    beams: int = 1, kv_scales: Optional[Scales] = None,
    new_kv: Optional[NewKV] = None, slot: Optional[int] = None, **layout,
) -> torch.Tensor:
    """`masked_attention_plain`'s function by the kernel's arithmetic, in
    f32 torch: each cluster rank's online-softmax state (m, l, acc) over
    its chunk of virtual keys (`split_chunks_plain`), masked per query by
    its own count, then the ranks merged in rank order, the own column
    folded in last and the v-scale applied. An empty chunk leaves
    m = NEG_BIG, l = 0; a query with no key at all gives 0. Reads k/v only."""
    B, H, Tq, hd = q.shape
    if bounds is None:
        bounds = attention_bounds(B, device=q.device, **layout)
    if new_kv is not None and Tq != 1:
        raise ValueError("masked_attention: the own-column mode takes one query")
    C = k.shape[2]
    P = None if prefix is None else prefix[0].shape[2]
    counts = key_counts(bounds, Tq, C, P=P, slot=slot)  # [B, Tq]
    chunks = split_chunks_plain(bounds, Tq, C, P=P, slot=slot)  # [B, G, S, 2]
    # the virtual keys' rows: text and range 1 on the prefix side (the
    # prefix row of the request, or the row's own cache), range 2 in the cache
    dev = q.device
    n_v = max(int(counts.max()), 1)
    x, x_a1 = (t[:, None] for t in _text_counts(bounds, C, P))
    vk = torch.arange(n_v, device=dev)[None, :]  # [1, V]
    side_p = vk < x_a1
    row = torch.where(vk < x, vk, torch.where(side_p, bounds.a1_lo + vk - x,
                                              bounds.a2_lo + vk - x_a1))
    kp, vp = (k, v) if prefix is None else \
        (t.repeat_interleave(beams, dim=0) for t in prefix)

    def gather(src, rows_in):  # [B, H, R, hd] at rows [B, V] -> [B, H, V, hd] f32
        idx = row.clamp(0, rows_in - 1)[:, None, :, None].expand(B, H, n_v, hd)
        return src.float().gather(2, idx)

    keep = side_p[:, None, :, None]
    kv_ = torch.where(keep, gather(kp, kp.shape[2]), gather(k, C))
    vv_ = torch.where(keep, gather(vp, vp.shape[2]), gather(v, C))
    qf = q.float()
    if kv_scales is not None:
        ks, vs = (t.float()[None, :, None, None] for t in kv_scales)
        qf = qf * ks
    qf = qf * (1.0 / math.sqrt(hd))
    s = qf @ kv_.transpose(-1, -2)  # [B, H, Tq, V]
    valid = vk[:, None, :] < counts[:, :, None]  # [B, Tq, V]
    group = torch.arange(Tq, device=dev) // QUERY_GROUP
    lo, hi = chunks[:, group, :, 0], chunks[:, group, :, 1]  # [B, Tq, S]
    mm = torch.full((B, H, Tq, 1), NEG_BIG, device=dev)
    states = []
    for r in range(SPLIT_BLOCKS):  # each rank's state over its chunk
        mask = (valid & (vk[:, None, :] >= lo[..., r:r + 1])
                & (vk[:, None, :] < hi[..., r:r + 1]))[:, None]  # [B, 1, Tq, V]
        m = torch.where(mask, s, NEG_BIG).amax(-1, keepdim=True)
        p = torch.where(mask, torch.exp(s - m), 0.0)
        states.append((m, p.sum(-1, keepdim=True), p @ vv_))
        mm = torch.maximum(mm, m)
    if new_kv is not None:
        nk, nv = (t.float() for t in new_kv)  # [B, H, 1, hd]
        if kv_scales is not None:  # cache units, unrounded
            nk, nv = nk / ks, nv / vs
        s_own = (qf * nk).sum(-1, keepdim=True)
        mm = torch.maximum(mm, s_own)
    ll = torch.zeros_like(mm)
    acc = torch.zeros((B, H, Tq, hd), device=dev)
    for m, l, a in states:  # rank order
        f = torch.exp(m - mm)
        ll = ll + l * f
        acc = acc + a * f
    if new_kv is not None:  # the new column, last
        p = torch.exp(s_own - mm)
        ll = ll + p
        acc = acc + p * nv
    o = torch.where(ll > 0, acc / torch.where(ll > 0, ll, 1.0), 0.0)
    if kv_scales is not None:
        o = o * vs
    return o.to(q.dtype)


def write_column(k: torch.Tensor, v: torch.Tensor, new_kv: NewKV, slot: int,
                 kv_scales: Optional[Scales] = None) -> None:
    """The own-column mode's cache write, in PyTorch: row `slot` of k/v
    [B, H, C, hd] ← the new k/v as the cache stores them (in place)."""
    ks, vs = kv_scales if kv_scales is not None else (None, None)
    k[:, :, slot: slot + 1] = _column(new_kv[0], k.dtype, ks)
    v[:, :, slot: slot + 1] = _column(new_kv[1], v.dtype, vs)


def _strides3(t: torch.Tensor):
    return (ctypes.c_longlong * 3)(t.stride(0), t.stride(1), t.stride(2))


KINDS = {  # (q/out dtype, k/v dtype) → the launcher's `kinds`
    (torch.float32, torch.bfloat16): 0,
    (torch.float32, torch.float32): 2,
    (torch.float32, torch.int8): 3,  # with kv_scales
}


def masked_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bounds: Optional[Bounds] = None, *,
    prefix: Optional[Prefix] = None, beams: int = 1,
    kv_scales: Optional[Scales] = None, new_kv: Optional[NewKV] = None,
    slot: Optional[Union[int, torch.Tensor]] = None,
    out: Optional[torch.Tensor] = None, site: str = "", **layout,
) -> torch.Tensor:
    """q [B, H, Tq, hd]; k/v [B, H, C, hd] (any strides with a unit last
    stride; hd 64 or 128 on the card): f32 q with bf16 k/v, all f32
    (compute_dtype="float32") or f32 q with int8 k/v and `kv_scales` (the
    int8 KV cache) → [B, H, Tq, hd] in q's dtype, written into `out` when
    given (e.g. a strided view of a [Tq, H·hd] buffer). Bounds, or the
    keywords of `attention_bounds`; `prefix` + `beams` for the grouped
    mode; `new_kv` + `slot` (an int or a one-element int32 tensor) for the
    own-column mode, which also writes the column into k/v. CPU tensors
    take the plain version; CUDA tensors launch or raise."""
    t0 = time.perf_counter()
    B, H, Tq, hd = q.shape
    if bounds is None:
        bounds = attention_bounds(B, device=q.device, **layout)
    if (k.dtype == torch.int8) != (kv_scales is not None):
        raise TypeError("masked_attention: int8 k/v go with kv_scales, and only they")
    if (new_kv is None) != (slot is None):
        raise ValueError("masked_attention: the own-column mode needs new_kv and slot")
    if q.device.type == "cpu":
        if isinstance(slot, torch.Tensor):
            slot = int(slot)
        o = masked_attention_plain(q, k, v, bounds, prefix=prefix, beams=beams,
                                   kv_scales=kv_scales, new_kv=new_kv, slot=slot)
        if new_kv is not None:
            write_column(k, v, new_kv, slot, kv_scales)
        if out is None:
            return o
        out.copy_(o)
        return out
    C = k.shape[2]
    if not 1 <= Tq <= MAX_QUERIES:
        raise ValueError(f"masked_attention: the kernel takes 1 to {MAX_QUERIES} queries,"
                         f" got Tq = {Tq}")
    if hd not in HEAD_DIMS or k.shape != (B, H, C, hd) or v.shape != k.shape:
        raise ValueError(f"masked_attention: want q [B,H,Tq,hd], k/v [B,H,C,hd] with hd in"
                         f" {HEAD_DIMS}; got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    kinds = KINDS.get((q.dtype, k.dtype))
    if kinds is None or v.dtype != k.dtype:
        raise TypeError(f"masked_attention: q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype} not taken"
                        " (f32/bf16/bf16, f32/f32/f32 or f32/int8/int8)")
    ks = vs = nk = nv = ns = slot_d = None
    if kv_scales is not None:
        ks, vs = kv_scales
        for t in kv_scales:
            if t.shape != (H,) or t.dtype != torch.float32 or not t.is_contiguous() \
                    or t.device != q.device:
                raise ValueError(f"masked_attention: kv_scales must be contiguous [{H}] f32 on q's device")
        ks, vs = ks.data_ptr(), vs.data_ptr()
    if new_kv is not None:
        nk, nv = new_kv
        if isinstance(slot, torch.Tensor):
            if slot.numel() != 1 or slot.dtype != torch.int32 or slot.device != q.device:
                raise ValueError("masked_attention: a device slot is one int32 on q's device")
            slot, slot_d = 0, slot.data_ptr()
        if Tq != 1 or not 0 <= slot < C:
            raise ValueError(f"masked_attention: the own-column mode takes Tq = 1 and"
                             f" 0 <= slot < {C}; got Tq {Tq}, slot {slot}")
        if nk.shape != (B, H, 1, hd) or nv.shape != nk.shape or nk.stride() != nv.stride() \
                or nk.dtype != torch.float32 or nv.dtype != torch.float32 \
                or nk.device != q.device or nv.device != q.device or nk.stride(-1) != 1:
            raise ValueError(f"masked_attention: new_kv must be two f32 [{B}, {H}, 1, {hd}]"
                             " tensors with the same strides on q's device")
        ns = _strides3(nk)
        nk, nv = nk.data_ptr(), nv.data_ptr()
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
        if any(st % align for st in a.stride()[:3]) or a.data_ptr() % 16 or b.data_ptr() % 16:
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
        B, H, Tq, C, hd, lens.data_ptr(), bounds.a1_lo, bounds.a2_lo, bounds.q_off,
        ctypes.c_float(1.0 / math.sqrt(hd)), ks, vs, nk, nv, ns,
        0 if slot is None else slot, slot_d, stream_ptr(q),
    )
    check(rc, "masked_attention")
    count_launch("masked_attention", site, t0)
    return out


def kernel_info(dtype: torch.dtype, hd: int, Tq: int) -> dict:
    """The kernel instance that k/v of `dtype` at head dim `hd` with Tq
    queries launch: its dynamic shared memory, threads a block, clusters the
    card holds at once (cudaOccupancyMaxActiveClusters) and blocks a
    cluster. Needs the card."""
    out = (ctypes.c_int * 4)()
    check(library().vx_masked_attention_info(KINDS[(torch.float32, dtype)], hd, Tq, out),
          "masked_attention_info")
    return dict(smem_bytes=out[0], threads=out[1], clusters=out[2], cluster_blocks=out[3])
