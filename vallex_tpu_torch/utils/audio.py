"""WAV I/O without libsndfile or torchaudio (port of vallex_tpu/utils/audio.py).

Enrollment clips are decoded and resampled by the native host runtime
(native.py: 8/16/24/32-bit PCM and 32-bit float, stereo downmixed to
mono as the reference does, utils/prompt_making.py:62-64; a windowed-sinc
resampler), in the JAX package's order. `read_wav_plain` (the stdlib
`wave` module, integer PCM) and `resample_plain` (the resampler's formula
in numpy) are their plain versions, for the tests. Output is 16-bit PCM.
"""

from __future__ import annotations

import io
import wave
from math import gcd
from typing import Tuple

import numpy as np

from .. import native


def load_wav(path: str, target_sr: int = 24000) -> Tuple[np.ndarray, int]:
    """→ (mono float32 waveform in [-1, 1] at target_sr, target_sr)."""
    data, sr = native.load_wav(path)
    if sr != target_sr:
        data = native.resample(data, sr, target_sr)
    return data, target_sr


def read_wav_plain(path: str) -> Tuple[np.ndarray, int]:
    """The plain version of the native decoder for integer PCM: → (mono
    float32 samples, the file's rate), each sample scaled in f32, then an
    f32 mean over the channels."""
    with wave.open(path, "rb") as f:
        sr = f.getframerate()
        n_ch = f.getnchannels()
        width = f.getsampwidth()
        raw = f.readframes(f.getnframes())

    if width == 2:
        data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 3:
        # little-endian 3-byte samples widened to int32, bit 23 sign-extended
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3).astype(np.int32)
        as32 = ((b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)) << 8) >> 8
        data = as32.astype(np.float32) / 8388608.0
    elif width == 4:
        data = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")

    if n_ch > 1:
        data = data.reshape(-1, n_ch).mean(axis=1)
    return data, sr


def resample_plain(wav: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """The plain version of the native resampler, in numpy float64: output
    m at input time m·down/up, a Hann-windowed sinc low-passed at
    min(sr_in, sr_out)/2 over 16 zero crossings each side, the taps that
    fall inside the input normalised by their sum."""
    wav = np.asarray(wav, np.float32)
    if sr_in == sr_out:
        return wav.copy()
    g = gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g
    n_out = len(wav) * up // down
    zc = 16
    cutoff = 0.5 * (up / down if up < down else 1.0)
    k = np.arange(-zc, zc + 1)
    block = 1 << 16  # output samples a pass: bounds the [block, 33] temporaries
    out = np.empty(n_out, np.float32)
    for lo in range(0, n_out, block):
        num = np.arange(lo, min(lo + block, n_out), dtype=np.int64) * down
        idx = (num // up)[:, None] + k
        x = k - (num % up / up)[:, None]
        arg = 2 * np.pi * cutoff * x
        s = np.where(x == 0, 1.0, np.sin(arg) / np.where(x == 0, 1.0, arg))
        h = 2 * cutoff * s * 0.5 * (1 + np.cos(np.pi * x / (zc + 1)))
        h = np.where((idx >= 0) & (idx < len(wav)), h, 0.0)
        acc = (wav[np.clip(idx, 0, len(wav) - 1)] * h).sum(-1)
        wsum = h.sum(-1)
        out[lo: lo + len(num)] = np.where(wsum > 1e-9, acc / np.where(wsum > 1e-9, wsum, 1.0),
                                          acc)
    return out


def pcm16(wav: np.ndarray) -> bytes:
    """Mono float waveform → raw 16-bit little-endian PCM bytes (the one
    clip/scale conversion the WAV files and the streamed output share)."""
    pcm = np.clip(np.asarray(wav), -1.0, 1.0)
    return (pcm * 32767.0).astype("<i2").tobytes()


def wav_bytes(wav: np.ndarray, sr: int = 24000) -> bytes:
    """Mono float waveform → 16-bit PCM WAV container bytes."""
    buf = io.BytesIO()
    with wave.open(buf, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm16(wav))
    return buf.getvalue()


def save_wav(path: str, wav: np.ndarray, sr: int = 24000) -> None:
    """Write a mono float waveform as 16-bit PCM."""
    with open(path, "wb") as f:
        f.write(wav_bytes(wav, sr))
