"""The hybrid AR's decode-step kernels (kernel: ssm_step.cu): the Mamba-2
state update `ssm_step`, the width-4 causal convolution step `conv_step`,
RMSNorm rows `rms_norm_rows` and `swiglu_rows`, each with its plain
version for the CPU (and the tests).

Layouts (one Mamba layer, M rows): `zd` is the input projection's output
[M, inner + conv_dim + H] (z, then x B C, then dt); `xbc` the convolved x B
C [M, conv_dim] (x [H·P], then B [N], then C [N]: one group); the state
`S` [M, H, P, N] f32 and the convolution's state [M, 3, conv_dim] f32 are
updated in place. Every wrapper allocates its output (none for the states),
so a captured launch reads and writes fixed addresses; nothing is
allocated inside the kernels. One call counts one launch of its kernel
(`loader.count_launch`) at the caller's site.
"""

from __future__ import annotations

import ctypes
import time
import torch
import torch.nn.functional as F

from .loader import check, count_launch, library, stream_ptr

KERNEL_P, KERNEL_N = 64, 128  # the head and state widths ssm_step_kernel is built for


def ssm_step_plain(xbc: torch.Tensor, zd: torch.Tensor, S: torch.Tensor, dt_bias: torch.Tensor,
                   A_log: torch.Tensor, D: torch.Tensor, *, z_off: int,
                   dt_off: int) -> torch.Tensor:
    """One step per row and head, in place on S [M, H, P, N] f32:
    dt = softplus(dt_raw + dt_bias), S ← exp(dt·A)·S + dt·x ⊗ B with A =
    −exp(A_log), y = (S·C + D·x) · silu(z) → y [M, H·P] f32."""
    M, H, P, N = S.shape
    x = xbc[:, : H * P].float().view(M, H, P)
    B, C = xbc[:, H * P: H * P + N].float(), xbc[:, H * P + N: H * P + 2 * N].float()
    z = zd[:, z_off: z_off + H * P].float().view(M, H, P)
    # softplus with torch's threshold 20, as the kernel
    dt = F.softplus(zd[:, dt_off: dt_off + H].float() + dt_bias.float())  # [M, H]
    dA = torch.exp(dt * -torch.exp(A_log.float()))
    S.mul_(dA[:, :, None, None]).add_((dt[:, :, None] * x)[..., None] * B[:, None, None, :])
    y = (S @ C[:, None, :, None])[..., 0] + D.float()[:, None] * x
    return (y * F.silu(z)).reshape(M, H * P)


def conv_step_plain(zd: torch.Tensor, state: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                    x_off: int) -> torch.Tensor:
    """silu(b + Σ_j w[:, j] · tap_j) over the taps (state [M, 3, C] oldest
    first, then this step's x = zd[:, x_off: x_off + C]); the state shifts
    in place → [M, C] f32."""
    C = state.shape[2]
    x = zd[:, x_off: x_off + C].float()
    taps = torch.cat([state, x[:, None]], dim=1)  # [M, 4, C]
    out = F.silu(b.float() + (taps * w.float().t()[None]).sum(1))
    state.copy_(taps[:, 1:])
    return out


def rms_norm_rows_plain(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    return xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps) * g.float()


def swiglu_rows_plain(x: torch.Tensor) -> torch.Tensor:
    """[M, 2F] → silu(x[:, :F]) · x[:, F:]."""
    a, b = x.float().chunk(2, dim=-1)
    return F.silu(a) * b


def _f32_rows(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.dtype != torch.float32 or t.stride(-1) != 1 or t.data_ptr() % 16 \
                or (t.dim() > 1 and t.stride(0) % 4):
            raise ValueError(f"{name}: tensors must be f32 with a unit last stride, 16-byte"
                             " aligned rows")


def ssm_step(xbc: torch.Tensor, zd: torch.Tensor, S: torch.Tensor, dt_bias: torch.Tensor,
             A_log: torch.Tensor, D: torch.Tensor, *, z_off: int, dt_off: int,
             site: str = "") -> torch.Tensor:
    """`ssm_step_plain` on CPU tensors; CUDA tensors launch
    ssm_step_kernel (P = 64, N = 128) or raise."""
    t0 = time.perf_counter()
    if xbc.device.type == "cpu":
        return ssm_step_plain(xbc, zd, S, dt_bias, A_log, D, z_off=z_off, dt_off=dt_off)
    M, H, P, N = S.shape
    if (P, N) != (KERNEL_P, KERNEL_N) or not S.is_contiguous() or S.dtype != torch.float32:
        raise ValueError(f"ssm_step: the kernel takes a contiguous f32 state [M, H, {KERNEL_P},"
                         f" {KERNEL_N}], got {tuple(S.shape)} {S.dtype}")
    _f32_rows("ssm_step", xbc, zd, S)
    for t in (dt_bias, A_log, D):
        if t.shape != (H,) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"ssm_step: dt_bias, A_log and D must be contiguous f32 [{H}]")
    y = torch.empty((M, H * P), dtype=torch.float32, device=xbc.device)
    rc = library().vx_ssm_step(
        xbc.data_ptr(), xbc.stride(0), zd.data_ptr(), zd.stride(0), z_off, dt_off, S.data_ptr(),
        dt_bias.data_ptr(), A_log.data_ptr(), D.data_ptr(), y.data_ptr(), y.stride(0),
        M, H, P, N, stream_ptr(xbc))
    check(rc, "ssm_step")
    count_launch("ssm_step", site, t0)
    return y


def conv_step(zd: torch.Tensor, state: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
              x_off: int, site: str = "") -> torch.Tensor:
    """`conv_step_plain` on CPU tensors; CUDA tensors launch
    conv_step_kernel (width 4: w [C, 4] f32) or raise."""
    t0 = time.perf_counter()
    if zd.device.type == "cpu":
        return conv_step_plain(zd, state, w, b, x_off=x_off)
    M, taps, C = state.shape
    if taps != 3 or w.shape != (C, 4) or b.shape != (C,) or not state.is_contiguous() \
            or not w.is_contiguous() or not b.is_contiguous():
        raise ValueError("conv_step: the kernel takes a contiguous state [M, 3, C], w [C, 4],"
                         " b [C]")
    _f32_rows("conv_step", zd, state, w, b)
    out = torch.empty((M, C), dtype=torch.float32, device=zd.device)
    rc = library().vx_conv_step(zd.data_ptr(), zd.stride(0), x_off, state.data_ptr(),
                                w.data_ptr(), b.data_ptr(), out.data_ptr(), out.stride(0), M, C,
                                stream_ptr(zd))
    check(rc, "conv_step")
    count_launch("conv_step", site, t0)
    return out


def rms_norm_rows(x: torch.Tensor, g: torch.Tensor, eps: float, *,
                  site: str = "") -> torch.Tensor:
    """x [M, K] f32 → x · rsqrt(mean(x²) + eps) · g; the plain version on
    the CPU, rms_norm_rows_kernel on CUDA."""
    t0 = time.perf_counter()
    if x.device.type == "cpu":
        return rms_norm_rows_plain(x, g, eps)
    M, K = x.shape
    if g.shape != (K,) or not g.is_contiguous():
        raise ValueError(f"rms_norm_rows: g must be contiguous [{K}]")
    out = torch.empty((M, K), dtype=torch.float32, device=x.device)
    _f32_rows("rms_norm_rows", x, g, out)
    rc = library().vx_rms_norm_rows(x.data_ptr(), x.stride(0), g.data_ptr(), out.data_ptr(),
                                    out.stride(0), M, K, ctypes.c_float(eps), stream_ptr(x))
    check(rc, "rms_norm_rows")
    count_launch("rms_norm_rows", site, t0)
    return out


def swiglu_rows(x: torch.Tensor, *, site: str = "") -> torch.Tensor:
    """x [M, 2F] f32 → silu(x[:, :F]) · x[:, F:] [M, F]; the plain version
    on the CPU, swiglu_rows_kernel on CUDA."""
    t0 = time.perf_counter()
    if x.device.type == "cpu":
        return swiglu_rows_plain(x)
    M, F2 = x.shape
    if F2 % 2 or x.dtype != torch.float32 or x.stride(-1) != 1:
        raise ValueError("swiglu_rows: x must be f32 [M, 2F] with a unit last stride")
    y = torch.empty((M, F2 // 2), dtype=torch.float32, device=x.device)
    rc = library().vx_swiglu_rows(x.data_ptr(), x.stride(0), y.data_ptr(), y.stride(0), M,
                                  F2 // 2, stream_ptr(x))
    check(rc, "swiglu_rows")
    count_launch("swiglu_rows", site, t0)
    return y
