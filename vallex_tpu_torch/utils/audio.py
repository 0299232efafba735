"""WAV I/O without libsndfile or torchaudio (port of vallex_tpu/utils/audio.py).

Enrollment clips are read with the stdlib `wave` module (8-, 16-, 24- and
32-bit PCM), stereo is downmixed to mono (reference:
utils/prompt_making.py:62-64), and another rate is resampled with scipy's
polyphase resampler. The JAX package prefers its C++ resampler when that
builds; the port always takes `resample_poly`. Output is 16-bit PCM.
"""

from __future__ import annotations

import io
import wave
from math import gcd
from typing import Tuple

import numpy as np


def load_wav(path: str, target_sr: int = 24000) -> Tuple[np.ndarray, int]:
    """→ (mono float32 waveform in [-1, 1] at target_sr, target_sr)."""
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
    if sr != target_sr:
        from scipy.signal import resample_poly

        g = gcd(sr, target_sr)
        data = resample_poly(data, target_sr // g, sr // g).astype(np.float32)
    return data, target_sr


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
