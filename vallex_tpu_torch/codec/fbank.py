"""100-bin log-mel filterbank (port of vallex_tpu/codec/fbank.py, the
reference's BigVGAN-style extractor, data/fbank.py:28-173).

24 kHz audio → STFT (n_fft 1024, hop 256, periodic Hann, reflect-padded by
(n_fft − hop)/2 on both sides, no centring; data/fbank.py:103-108) →
MAGNITUDE spectrum sqrt(re² + im² + 1e-9) (data/fbank.py:126) → 100 mel
bins on librosa's SLANEY scale with slaney area normalization (the
librosa_mel_fn defaults, data/fbank.py:75-77) → log, clipped at 1e-5.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..config import NUM_MEL_BINS

N_FFT = 1024
HOP = 256
SAMPLE_RATE = 24000
FMIN = 0.0
FMAX = 12000.0

_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_LOGSTEP = math.log(6.4) / 27.0


def _hz_to_mel_slaney(f: torch.Tensor) -> torch.Tensor:
    """librosa htk=False: linear below 1 kHz, logarithmic above."""
    lin = f / _F_SP
    log = _MIN_LOG_HZ / _F_SP + torch.log(torch.clamp(f, min=1e-10) / _MIN_LOG_HZ) / _LOGSTEP
    return torch.where(f >= _MIN_LOG_HZ, log, lin)


def _mel_to_hz_slaney(m: torch.Tensor) -> torch.Tensor:
    min_log_mel = _MIN_LOG_HZ / _F_SP
    lin = m * _F_SP
    log = _MIN_LOG_HZ * torch.exp(_LOGSTEP * (m - min_log_mel))
    return torch.where(m >= min_log_mel, log, lin)


def mel_filterbank(n_mels: int = NUM_MEL_BINS, n_fft: int = N_FFT, sr: int = SAMPLE_RATE,
                   fmin: float = FMIN, fmax: float = FMAX, device=None) -> torch.Tensor:
    """Slaney-scale, slaney-normalized triangular filters → [n_fft//2 + 1,
    n_mels] f32 (librosa.filters.mel(htk=False, norm='slaney'))."""
    f32 = dict(dtype=torch.float32, device=device)
    freqs = torch.linspace(0, sr / 2, n_fft // 2 + 1, **f32)
    lo, hi = _hz_to_mel_slaney(torch.tensor([fmin, fmax], **f32))
    hz = _mel_to_hz_slaney(torch.linspace(float(lo), float(hi), n_mels + 2, **f32))
    lower, center, upper = hz[:-2][None], hz[1:-1][None], hz[2:][None]
    f = freqs[:, None]
    up = (f - lower) / torch.clamp(center - lower, min=1e-9)
    down = (upper - f) / torch.clamp(upper - center, min=1e-9)
    fb = torch.clamp(torch.minimum(up, down), min=0.0)
    return fb * (2.0 / (hz[2:] - hz[:-2]))[None]


def extract_fbank(wav: torch.Tensor) -> torch.Tensor:
    """[B, samples] → [B, T, 100] log-mel features (T = samples // HOP for
    HOP-aligned inputs)."""
    pad = (N_FFT - HOP) // 2
    x = F.pad(wav.float()[:, None], (pad, pad), mode="reflect")[:, 0]
    win = torch.hann_window(N_FFT, periodic=True, dtype=torch.float32, device=wav.device)
    spec = torch.stft(x, N_FFT, HOP, window=win, center=False, return_complex=True)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)  # [B, F, T]
    mel = mag.transpose(1, 2) @ mel_filterbank(device=wav.device)
    return torch.log(torch.clamp(mel, min=1e-5))
