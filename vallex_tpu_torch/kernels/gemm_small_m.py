"""`gemm_small_m`: the decode products, a few rows (kernel: gemm_small_m.cu).

Y[M, N] = epilogue(prologue(X)[M, K] · W[N, K]ᵀ) with an optional
LayerNorm prologue and scale / bias / ReLU / residual epilogue. W is bf16,
int8 with f32 per-output-channel scales (W8A16), or f32; activations are
rounded to bf16 before the product for bf16 and int8 weights and stay f32
for f32 weights, and the sum is f32, as in the TPU kernels. With
`act_quant` (W8A8, the TPU kernels' `qmat`) the int8 weights meet int8
activations with a dynamic scale per row, sx = max(max|x|, 1e-6) / 127,
and the int32 sum is scaled by sx · srow. It carries QKV, out-proj, FFN1,
FFN2 and the head of the draft and batched-request steps
(ops/decode_block.py, one row per request and sample), of the verify pass
(ops/decode_verify.py) and of the single steps (ops/decode_step.py). Any
M: the kernel takes the rows in groups of 24 (f32: 8), and each row is
bitwise its M = 1 product.

On the card a bf16, int8 or W8A8 product runs the prologue once (a prep
kernel writing bf16 rows, or int8 codes and their scales, into scratch
that this wrapper allocates; a bf16 / int8 cast prologue over 16-byte
aligned rows needs none) and the product on the tensor cores, launched
back to back with programmatic dependent launch (gemm_small_m.cu). One
call counts one launch of `gemm_small_m`, whatever it launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .loader import check, launch_counts, library, stream_ptr

W_KINDS = {torch.bfloat16: 0, torch.int8: 1, torch.float32: 2}  # the launcher's w_kind
W_W8A8 = 3  # int8 weights with int8 activations (act_quant)


def quantize_rows(x: torch.Tensor):
    """The W8A8 activations: per-row scale sx = max(max|x|, 1e-6) · (1/127)
    and xq = clip(round_half_even(x / sx), ±127) as f32 values (the TPU
    kernels' `qmat`, vallex_tpu/ops/decode_block.py:160-165) → (xq, sx [M, 1])."""
    sx = x.abs().amax(-1, keepdim=True).clamp_min(1e-6) * (1.0 / 127.0)
    return torch.clamp(torch.round(x / sx), -127.0, 127.0), sx


def _prologue(x: torch.Tensor, ln, eps: float) -> torch.Tensor:
    """The f32 LayerNorm of each row (or the rows themselves)."""
    xf = x.float()
    if ln is not None:
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        xf = (xf - mean) * torch.rsqrt(var + eps) * ln[0].float() + ln[1].float()
    return xf


def gemm_prep_plain(x: torch.Tensor, *, ln=None, eps: float = 1e-5, act_quant: bool = False):
    """The prologue alone, as the prep kernel writes it: bf16 rows [M, K],
    or with act_quant the int8 codes [M, K] and their scales sx [M]."""
    xf = _prologue(x, ln, eps)
    if act_quant:
        xq, sx = quantize_rows(xf)
        return xq.to(torch.int8), sx[:, 0]
    return xf.to(torch.bfloat16)


def gemm_prep(x: torch.Tensor, *, ln=None, eps: float = 1e-5, act_quant: bool = False):
    """The prep kernel alone on CUDA tensors (plain version on the CPU): the
    rows the product reads. x [M, K] f32 with a unit last stride, K % 64 == 0."""
    if x.device.type == "cpu":
        return gemm_prep_plain(x, ln=ln, eps=eps, act_quant=act_quant)
    M, K = x.shape
    if x.dtype != torch.float32 or x.stride(-1) != 1 or K % 64 or M < 1:
        raise ValueError("gemm_prep: x must be f32 [M, K] with a unit last stride, K % 64 == 0")
    for t in (ln if ln is not None else ()):
        if t.shape != (K,) or t.dtype != torch.float32 or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"gemm_prep: ln must be two contiguous f32 [{K}] on x's device")
    act = torch.empty((M, K), dtype=torch.int8 if act_quant else torch.bfloat16, device=x.device)
    sx = torch.empty((M,), dtype=torch.float32, device=x.device) if act_quant else None
    rc = library().vx_gemm_small_m_prep(
        x.data_ptr(), x.stride(0), _ptr(ln[0]) if ln is not None else None,
        _ptr(ln[1]) if ln is not None else None, M, K, ctypes.c_float(eps), int(act_quant),
        act.data_ptr(), _ptr(sx), stream_ptr(x))
    check(rc, "gemm_prep")
    return (act, sx) if act_quant else act


def gemm_small_m_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    ln: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    relu: bool = False,
    residual: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
    act_quant: bool = False,
) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch ops (any device, any float W).
    Activations are rounded to bf16 for bf16/int8 weights and kept in the
    weight's dtype otherwise (the fp32 CPU path). act_quant: int8
    activations (`quantize_rows`); the integer sum is taken in float64,
    which holds it exactly (|sum| <= 127·127·K < 2^53; an f32 sum would
    round past 2^24), and rounded to f32 once, as the kernel's int32 sum."""
    xf = _prologue(x, ln, eps)
    if act_quant:
        if w.dtype != torch.int8 or scale is None:
            raise ValueError("gemm_small_m: act_quant needs int8 weights with scales")
        xq, sx = quantize_rows(xf)
        y = (xq.double() @ w.double().t()).float() * (sx * scale.float())
    else:
        act = torch.bfloat16 if w.dtype in (torch.int8, torch.bfloat16) else w.dtype
        y = xf.to(act).float() @ w.float().t()
        if scale is not None:
            y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    if relu:
        y = torch.relu(y)
    if residual is not None:
        y = y + residual.float()
    return y


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def gemm_small_m(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    ln: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    relu: bool = False,
    residual: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
    act_quant: bool = False,
    site: str = "",
) -> torch.Tensor:
    """x [M, K] f32, w [N, K] → y [M, N] f32 (act_quant: W8A8, int8 w).
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if x.device.type == "cpu":
        return gemm_small_m_plain(
            x, w, scale=scale, bias=bias, ln=ln, relu=relu,
            residual=residual, eps=eps, act_quant=act_quant,
        )
    M, K = x.shape
    N = w.shape[0]
    f32 = (x, scale, bias, residual) + (ln if ln is not None else ())
    if M < 1:
        raise ValueError(f"gemm_small_m takes at least one row, got {M}")
    if w.dtype not in W_KINDS:
        raise TypeError(f"gemm_small_m: weights must be bf16, int8 or f32, got {w.dtype}")
    if w.dtype == torch.int8 and scale is None:
        raise ValueError("gemm_small_m: int8 weights need per-channel scales")
    if act_quant and w.dtype != torch.int8:
        raise TypeError(f"gemm_small_m: act_quant (W8A8) needs int8 weights, got {w.dtype}")
    k_mult = 16 if w.dtype == torch.float32 else 64
    if w.shape != (N, K) or not w.is_contiguous() or K % k_mult or w.data_ptr() % 16:
        raise ValueError(f"gemm_small_m: w must be contiguous [N, K], 16-byte aligned, with"
                         f" K % {k_mult} == 0 for {w.dtype} weights; got {tuple(w.shape)}")
    for t in f32:
        if t is not None and (t.dtype != torch.float32 or t.device != x.device
                              or t.stride(-1) != 1):
            raise TypeError("gemm_small_m: x/scale/bias/ln/residual must be f32 on x's device with unit last stride")
    if residual is not None and residual.shape != (M, N):
        raise ValueError("gemm_small_m: residual must be [M, N]")
    if w.device != x.device:
        raise ValueError("gemm_small_m: w and x on different devices")
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    scratch = None
    if w.dtype != torch.float32 and (act_quant or ln is not None or x.data_ptr() % 16
                                     or x.stride(0) % 4):
        # the prep kernel's rows: int8 codes then M f32 scales (W8A8), or bf16
        nbytes = -(-M * K // 16) * 16 + 4 * M if act_quant else 2 * M * K
        scratch = torch.empty((nbytes,), dtype=torch.uint8, device=x.device)
    rc = library().vx_gemm_small_m(
        x.data_ptr(), x.stride(0), w.data_ptr(), W_W8A8 if act_quant else W_KINDS[w.dtype],
        _ptr(scale), _ptr(bias),
        _ptr(ln[0]) if ln is not None else None,
        _ptr(ln[1]) if ln is not None else None,
        _ptr(residual), residual.stride(0) if residual is not None else 0,
        y.data_ptr(), y.stride(0), M, N, K, int(relu), ctypes.c_float(eps),
        _ptr(scratch), stream_ptr(x),
    )
    check(rc, "gemm_small_m")
    launch_counts[("gemm_small_m", site)] += 1
    if scratch is not None:
        launch_counts[("gemm_small_m_prep", site)] += 1
    return y
