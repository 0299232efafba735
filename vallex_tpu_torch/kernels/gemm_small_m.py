"""`gemm_small_m`: the decode products, a few rows (kernel: gemm_small_m.cu).

Y[M, N] = epilogue(prologue(X)[M, K] · W[N, K]ᵀ) with an optional
LayerNorm prologue and scale / bias / ReLU / residual epilogue. W is bf16,
int8 with f32 per-output-channel scales (W8A16), or f32; activations are
rounded to bf16 before the product for bf16 and int8 weights and stay f32
for f32 weights, and the sum is f32, as in the TPU kernels. It carries
QKV, out-proj, FFN1, FFN2 and the head of the draft and batched-request
steps (ops/decode_block.py, one row per request and sample) and of the
verify pass (ops/decode_verify.py). Any M: the kernel takes the rows in
groups of 8, and each row is bitwise its M = 1 product.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .loader import check, launch_counts, library, stream_ptr

W_KINDS = {torch.bfloat16: 0, torch.int8: 1, torch.float32: 2}  # the launcher's w_kind


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
) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch ops (any device, any float W).
    Activations are rounded to bf16 for bf16/int8 weights and kept in the
    weight's dtype otherwise (the fp32 CPU path)."""
    xf = x.float()
    if ln is not None:
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        xf = (xf - mean) * torch.rsqrt(var + eps) * ln[0].float() + ln[1].float()
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
    site: str = "",
) -> torch.Tensor:
    """x [M, K] f32, w [N, K] → y [M, N] f32. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return gemm_small_m_plain(
            x, w, scale=scale, bias=bias, ln=ln, relu=relu,
            residual=residual, eps=eps,
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
    if w.shape != (N, K) or not w.is_contiguous() or K % 16:
        raise ValueError(f"gemm_small_m: w must be contiguous [N, K], K % 16 == 0; got {tuple(w.shape)}")
    for t in f32:
        if t is not None and (t.dtype != torch.float32 or t.device != x.device
                              or t.stride(-1) != 1):
            raise TypeError("gemm_small_m: x/scale/bias/ln/residual must be f32 on x's device with unit last stride")
    if residual is not None and residual.shape != (M, N):
        raise ValueError("gemm_small_m: residual must be [M, N]")
    if w.device != x.device:
        raise ValueError("gemm_small_m: w and x on different devices")
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    rc = library().vx_gemm_small_m(
        x.data_ptr(), x.stride(0), w.data_ptr(), W_KINDS[w.dtype],
        _ptr(scale), _ptr(bias),
        _ptr(ln[0]) if ln is not None else None,
        _ptr(ln[1]) if ln is not None else None,
        _ptr(residual), residual.stride(0) if residual is not None else 0,
        y.data_ptr(), y.stride(0), M, N, K, int(relu), ctypes.c_float(eps),
        stream_ptr(x),
    )
    check(rc, "gemm_small_m")
    launch_counts[("gemm_small_m", site)] += 1
    return y
