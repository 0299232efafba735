"""Plain Vocos (the charactr/vocos-encodec-24khz architecture, at the widths
the tree has): EnCodec codes [T, 8] of one request → its 24 kHz waveform
[T · 320], on exactly its T frames, from the parameter tree the benchmark
made. Imports nothing of the program.

features = Σ_q codebook_q[code_q] → Conv1d(128 → dim, k 7, same) →
AdaLayerNorm(bandwidth) → 8 ConvNeXt blocks (depthwise k 7 conv, AdaLN,
dim → intermediate, GELU, intermediate → dim, layer scale, residual) →
LayerNorm → Linear(dim → 1282) → log-magnitude and phase → inverse STFT (n_fft 1280, hop 320,
periodic Hann, "same" padding, window-envelope normalisation). LayerNorm
eps 1e-6. `dtype` lowers the convolutions and products for the control.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .vallex import as_f32

N_FFT, HOP = 1280, 320


def _ln(x, scale, shift, eps=1e-6):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + shift


def _conv(x, w, b, dtype, groups=1):
    """x [T, Cin], w [K, Cin / groups, Cout] → [T, Cout], zero "same" padding."""
    y = F.conv1d(x.T[None].to(dtype), w.permute(2, 1, 0).to(dtype), b.to(dtype),
                 padding=w.shape[0] // 2, groups=groups)
    return y[0].T.float()


def _lin(x, w, b, dtype):
    return (x.to(dtype) @ w.to(dtype) + b.to(dtype)).float()


def istft(spec: torch.Tensor) -> torch.Tensor:
    """complex [T, N_FFT // 2 + 1] → [T · HOP]."""
    T = spec.shape[0]
    R = N_FFT // HOP
    win = torch.hann_window(N_FFT, periodic=True, dtype=torch.float64,
                            device=spec.device).float()
    frames = torch.fft.irfft(spec, n=N_FFT, dim=-1) * win
    n = N_FFT + HOP * (T - 1)
    out = torch.zeros(n, device=spec.device)
    env = torch.zeros(n, device=spec.device)
    for t in range(R):  # frame i covers [i·HOP, i·HOP + N_FFT): strip t of each frame
        idx = (torch.arange(T, device=spec.device)[:, None] * HOP + t * HOP
               + torch.arange(HOP, device=spec.device)[None]).reshape(-1)
        out.index_add_(0, idx, frames[:, t * HOP:(t + 1) * HOP].reshape(-1))
        env.index_add_(0, idx, (win[t * HOP:(t + 1) * HOP] ** 2).repeat(T))
    pad = (N_FFT - HOP) // 2
    return (out / env.clamp_min(1e-11))[pad: n - pad]


class Vocos:
    def __init__(self, tree: Dict):
        self.p = as_f32(tree)

    def wave(self, codes: torch.Tensor, bandwidth_id: int = 2,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
        p, bw = self.p, bandwidth_id
        cb = p["codebook_weights"]
        x = sum(cb[q][codes[:, q].long()] for q in range(cb.shape[0]))
        x = _conv(x, p["embed"]["w"], p["embed"]["b"], dtype)
        x = _ln(x, p["norm"]["scale"][bw], p["norm"]["shift"][bw])
        B = p["blocks"]
        dim = x.shape[-1]
        for i in range(B["gamma"].shape[0]):
            h = _conv(x, B["dwconv"]["w"][i], B["dwconv"]["b"][i], dtype, groups=dim)
            h = _ln(h, B["norm"]["scale"][i, bw], B["norm"]["shift"][i, bw])
            h = F.gelu(_lin(h, B["pwconv1"]["w"][i], B["pwconv1"]["b"][i], dtype))
            h = _lin(h, B["pwconv2"]["w"][i], B["pwconv2"]["b"][i], dtype)
            x = x + B["gamma"][i] * h
        x = _ln(x, p["final_norm"]["scale"], p["final_norm"]["bias"])
        h = _lin(x, p["head"]["w"], p["head"]["b"], dtype)
        mag, phase = h.chunk(2, dim=-1)
        mag = torch.clamp(torch.exp(torch.clamp(mag, max=1e2)), max=1e30)
        return istft(torch.complex(mag * torch.cos(phase), mag * torch.sin(phase)))
