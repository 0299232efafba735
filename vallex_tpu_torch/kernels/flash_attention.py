"""`flash_attention`: full-sequence attention with segment ids and a
prefix-causal bound, forward and backward (kernel: flash_attention.cu) —
the NAR's key-padded attention when serving, and the training attention.

Key j is valid for query i of batch row b iff

    q_seg[b, i] == kv_seg[b, j]   and   j <= max(i, prefix - 1).

`prefix` = T is the non-causal (key padding, packed segments) attention,
0 the causal one, and the text length the AR training mask of
`attention_core_flash_prefix` (vallex_tpu/models/layers.py:259): a text row
i < prefix sees the text keys j < prefix, an audio row sees every key
j <= i. That is the JAX package's two-call composition (a causal pass over
the whole sequence whose text rows are replaced by a non-causal pass over
the text block alone) in one launch. The NAR (engine/nar.py) passes its
key-padding rule as segments (ok, ok) with prefix T, as the JAX package's
NAR does: valid rows see exactly the valid keys.

q, k, v are [B, H, T, hd] in bf16 or f32 (any strides with a unit last
stride; hd 64 or 128 on the card), segment ids [B, T] int32. The forward
returns the output in q's dtype and the row log-sum-exp [B, H, T] f32;
the backward takes both and dO and returns dq, dk, dv in the inputs'
dtype. Rows without a valid key
give a zero output, lse 0 and zero gradients.

On the card each kernel is picked by dtype and head dim: bf16 at hd 64 runs
on the tensor cores (the forward and both backward kernels; they read
q/k/v and dO by TMA, so their base addresses and strides, and those of O
for the dQ kernel, must be multiples of 16 bytes: the wrappers raise
otherwise), f32 and bf16 at hd 128 on the CUDA cores. `FlashAttention` is
the autograd.Function; its backward makes the incoming gradient
contiguous when it breaks that rule. CPU tensors take the
plain versions, CUDA tensors launch the kernels or raise. Launch counts:
the forward at its caller's site (`flash_attention_prefix` for the AR
training mask, `flash_attention_train` for the NAR's and packed
key-padding calls in training, `flash_attention` / `flash_attention_batched`
for the serving NAR of one request / a batch), both backward kernels at
`flash_attention_bwd`. A forward re-run by activation checkpointing counts
again.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from .loader import HEAD_DIMS, check, launch_counts, library, stream_ptr

KINDS = {torch.float32: 0, torch.bfloat16: 1}


def valid_pairs(q_seg: torch.Tensor, kv_seg: torch.Tensor, prefix: int) -> torch.Tensor:
    """[B, T, T] bool: key j valid for query i (the module docstring's rule)."""
    T = q_seg.shape[1]
    i = torch.arange(T, device=q_seg.device)
    bound = torch.clamp(i, min=prefix - 1)[:, None]  # max(i, prefix - 1)
    causal = i[None, :] <= bound
    return (q_seg[:, :, None] == kv_seg[:, None, :]) & causal[None]


def _scores(q, k, ok):
    s = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    return s.masked_fill(~ok[:, None], float("-inf"))


def flash_attention_plain(q, k, v, q_seg, kv_seg, prefix: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, H, T, hd] in q's dtype, lse [B, H, T] f32) with the valid
    pairs materialized; p cast to v's dtype before p·v, as the kernel."""
    ok = valid_pairs(q_seg, kv_seg, prefix)
    s = _scores(q, k, ok)
    m = s.amax(-1, keepdim=True)
    has = torch.isfinite(m)
    p = torch.exp(s - torch.where(has, m, torch.zeros_like(m)))
    lsum = p.sum(-1, keepdim=True)
    o = (p.to(v.dtype).float() @ v.float()) / torch.where(has, lsum, torch.ones_like(lsum))
    lse = torch.where(has, m + torch.log(lsum), torch.zeros_like(m))[..., 0]
    return o.to(q.dtype), lse


def _bwd_terms(q, k, v, q_seg, kv_seg, prefix, out, lse, dout):
    """(p, ds, di) of the flash backward, f32; p and ds rounded to the
    inputs' dtype as the kernels round them before their products."""
    ok = valid_pairs(q_seg, kv_seg, prefix)
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(_scores(q, k, ok) - lse[..., None])  # exactly 0 on the masked pairs
    do = dout.float()
    di = (out.float() * do).sum(-1)
    ds = p * (do @ v.float().transpose(-1, -2) - di[..., None]) * scale
    return p.to(v.dtype).float(), ds.to(q.dtype).float(), di


def flash_attention_bwd_dq_plain(q, k, v, q_seg, kv_seg, prefix: int, out, lse, dout
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dq, di) — the dQ kernel's half: dq = ds·k, di = Σ out·dout (f32)."""
    _, ds, di = _bwd_terms(q, k, v, q_seg, kv_seg, prefix, out, lse, dout)
    return (ds @ k.float()).to(q.dtype), di


def flash_attention_bwd_dkv_plain(q, k, v, q_seg, kv_seg, prefix: int, out, lse, dout
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) — the dK/dV kernel's half: dk = dsᵀ·q, dv = pᵀ·dout."""
    p, ds, _ = _bwd_terms(q, k, v, q_seg, kv_seg, prefix, out, lse, dout)
    dk = ds.transpose(-1, -2) @ q.float()
    dv = p.transpose(-1, -2) @ dout.float()
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, q_seg, kv_seg, prefix: int, out, lse, dout
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) by the flash backward's formula, not autograd:
    p = exp(s - lse) on the valid pairs, di = Σ out·dout (f32),
    dv = pᵀ·dout, ds = p ⊙ (dout·vᵀ − di) · scale, dk = dsᵀ·q, dq = ds·k,
    with p and ds cast to the inputs' dtype before their products."""
    p, ds, _ = _bwd_terms(q, k, v, q_seg, kv_seg, prefix, out, lse, dout)
    dq = ds @ k.float()
    dk = ds.transpose(-1, -2) @ q.float()
    dv = p.transpose(-1, -2) @ dout.float()
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _strides(t: torch.Tensor):
    return (ctypes.c_longlong * 3)(t.stride(0), t.stride(1), t.stride(2))


def _check(q, k, v, q_seg, kv_seg, prefix: int, name: str) -> int:
    B, H, T, hd = q.shape
    if hd not in HEAD_DIMS or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: want q/k/v [B, H, T, hd] of one shape with hd in"
                         f" {HEAD_DIMS}, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    kind = KINDS.get(q.dtype)
    if kind is None or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q/k/v must all be f32 or all bf16, got"
                        f" {q.dtype}/{k.dtype}/{v.dtype}")
    if k.stride() != v.stride():
        raise ValueError(f"{name}: k and v must share strides")
    for t in (q_seg, kv_seg):
        if t.shape != (B, T) or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: segment ids must be contiguous [{B}, {T}] int32")
    for t in (q, k, v, q_seg, kv_seg):
        if t.device != q.device:
            raise ValueError(f"{name}: tensors must share q's device")
    for t in (q, k, v):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: q/k/v need a unit last stride")
    if not 0 <= prefix <= T:
        raise ValueError(f"{name}: need 0 <= prefix <= T, got {prefix}, {T}")
    return kind


def _tma_ok(t: torch.Tensor) -> bool:
    """The base address and each stride of a dim longer than 1 are
    multiples of 16 bytes (TMA's rule; the views of the fused QKV product
    and a transposed dO meet it)."""
    es = t.element_size()
    return t.data_ptr() % 16 == 0 and all(st * es % 16 == 0 for st, n in zip(t.stride(), t.shape)
                                          if n > 1 and st != 1)


def _tensor_cores(q: torch.Tensor) -> bool:
    """bf16 at hd 64: the tensor-core kernels (picked by shape, as the
    launcher does); everything else runs on the CUDA-core ones."""
    return q.dtype == torch.bfloat16 and q.shape[-1] == 64


def _check_tma(*ts, name: str = "flash_attention") -> None:
    """Raise unless every tensor meets `_tma_ok` (the bf16 kernels read them
    by TMA or in 16-byte loads)."""
    for t in ts:
        if not _tma_ok(t):
            raise ValueError(f"{name}: bf16 tensors need 16-byte aligned base addresses and"
                             f" strides, got strides {t.stride()} at {t.data_ptr():#x}")


def flash_attention_fwd(q, k, v, q_seg, kv_seg, prefix: int, *, site: str = ""
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse): the plain version on the CPU, the kernel on the card."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, q_seg, kv_seg, prefix)
    kind = _check(q, k, v, q_seg, kv_seg, prefix, "flash_attention")
    if _tensor_cores(q):
        _check_tma(q, k, v)
    B, H, T, hd = q.shape
    out = torch.empty((B, H, T, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    rc = library().vx_flash_attention_fwd(
        q.data_ptr(), _strides(q), k.data_ptr(), v.data_ptr(), _strides(k),
        q_seg.data_ptr(), kv_seg.data_ptr(), out.data_ptr(), _strides(out),
        lse.data_ptr(), kind, hd, B, H, T, prefix, ctypes.c_float(1.0 / math.sqrt(hd)),
        stream_ptr(q))
    check(rc, "flash_attention")
    launch_counts[("flash_attention_fwd", site)] += 1
    return out, lse


def _check_bwd(q, k, v, q_seg, kv_seg, prefix, lse, name, *like_q) -> int:
    """_check, plus lse [B, H, T] f32 and each of `like_q` (out, dout) of
    q's shape, dtype and device with a unit last stride."""
    kind = _check(q, k, v, q_seg, kv_seg, prefix, name)
    B, H, T, _ = q.shape
    for t in like_q:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device \
                or t.stride(-1) != 1:
            raise ValueError(f"{name}: out and dout must match q's shape and dtype"
                             " with a unit last stride")
    if lse.shape != (B, H, T) or lse.dtype != torch.float32 or not lse.is_contiguous() \
            or lse.device != q.device:
        raise ValueError(f"{name}: lse must be contiguous [{B}, {H}, {T}] f32 on q's device")
    return kind


def flash_attention_bwd_dq(q, k, v, q_seg, kv_seg, prefix: int, out, lse, dout
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dq, di) from the dQ kernel (CUDA tensors only)."""
    kind = _check_bwd(q, k, v, q_seg, kv_seg, prefix, lse, "flash_attention_bwd_dq", out, dout)
    if _tensor_cores(q):
        _check_tma(q, k, v, out, dout, name="flash_attention_bwd_dq")
    B, H, T, hd = q.shape
    di = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    dq = torch.empty((B, H, T, hd), dtype=q.dtype, device=q.device)
    rc = library().vx_flash_attention_bwd_dq(
        q.data_ptr(), _strides(q), k.data_ptr(), v.data_ptr(), _strides(k),
        out.data_ptr(), _strides(out), dout.data_ptr(), _strides(dout),
        q_seg.data_ptr(), kv_seg.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
        kind, hd, B, H, T, prefix, ctypes.c_float(1.0 / math.sqrt(hd)), stream_ptr(q))
    check(rc, "flash_attention_bwd_dq")
    launch_counts[("flash_attention_bwd_dq", "flash_attention_bwd")] += 1
    return dq, di


def flash_attention_bwd_dkv(q, k, v, q_seg, kv_seg, prefix: int, dout, lse, di
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) from the dK/dV kernel (CUDA tensors only), given the dQ
    kernel's di; both on q's stream, so it runs after that kernel."""
    kind = _check_bwd(q, k, v, q_seg, kv_seg, prefix, lse, "flash_attention_bwd_dkv", dout)
    if _tensor_cores(q):
        _check_tma(q, k, v, dout, name="flash_attention_bwd_dkv")
    B, H, T, hd = q.shape
    if di.shape != (B, H, T) or di.dtype != torch.float32 or not di.is_contiguous():
        raise ValueError(f"flash_attention_bwd_dkv: di must be contiguous [{B}, {H}, {T}] f32")
    dk, dv = (torch.empty((B, H, T, hd), dtype=q.dtype, device=q.device) for _ in range(2))
    rc = library().vx_flash_attention_bwd_dkv(
        q.data_ptr(), _strides(q), k.data_ptr(), v.data_ptr(), _strides(k),
        dout.data_ptr(), _strides(dout), q_seg.data_ptr(), kv_seg.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        kind, hd, B, H, T, prefix, ctypes.c_float(1.0 / math.sqrt(hd)), stream_ptr(q))
    check(rc, "flash_attention_bwd_dkv")
    launch_counts[("flash_attention_bwd_dkv", "flash_attention_bwd")] += 1
    return dk, dv


def flash_attention_bwd(q, k, v, q_seg, kv_seg, prefix: int, out, lse, dout
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv): the plain version on the CPU; on the card the dQ kernel
    (which also writes di) then the dK/dV kernel, both on the tensor cores
    in bf16 at hd 64 and on the CUDA cores otherwise."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, q_seg, kv_seg, prefix, out, lse, dout)
    dq, di = flash_attention_bwd_dq(q, k, v, q_seg, kv_seg, prefix, out, lse, dout)
    dk, dv = flash_attention_bwd_dkv(q, k, v, q_seg, kv_seg, prefix, dout, lse, di)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """out = flash attention of (q, k, v) under (q_seg, kv_seg, prefix);
    its backward is `flash_attention_bwd` on the saved (out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, prefix: int, site: str):
        out, lse = flash_attention_fwd(q, k, v, q_seg, kv_seg, prefix, site=site)
        ctx.save_for_backward(q, k, v, q_seg, kv_seg, out, lse)
        ctx.prefix = prefix
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_seg, kv_seg, out, lse = ctx.saved_tensors
        if dout.stride(-1) != 1 or not _tma_ok(dout):  # a layout rule of the kernels
            dout = dout.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, q_seg, kv_seg, ctx.prefix, out, lse, dout)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, q_seg, kv_seg, prefix: int, *, site: str = "") -> torch.Tensor:
    """Differentiable flash attention (module docstring) → [B, H, T, hd]."""
    return FlashAttention.apply(q, k, v, q_seg, kv_seg, int(prefix), site)
