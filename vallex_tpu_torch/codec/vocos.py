"""Vocos vocoder: EnCodec codes → 24 kHz waveform (port of
vallex_tpu/codec/vocos.py, the `charactr/vocos-encodec-24khz` architecture).

  codes → features: sum of the 8 codebook vectors per frame → [B, T, 128]
  backbone: Conv1d(128→512, k7) + AdaLayerNorm(bandwidth id), 8 ConvNeXt
      blocks (depthwise k7 conv → AdaLayerNorm → 512→1536 → GELU → 1536→512
      → layer-scale → residual), final LayerNorm
  head: Linear(512 → n_fft+2) → (log-magnitude, phase) → inverse STFT
      (n_fft 1280, hop 320, Hann, "same" padding ⇒ T frames → T·320 samples)

Tensors are channels-last [B, T, C] as in the JAX code. Runs in f32.
`convert_vocos_state_dict` reads the public checkpoint's state dict.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

INPUT_CHANNELS = 128
DIM = 512
INTERMEDIATE_DIM = 1536
NUM_LAYERS = 8
N_FFT = 1280
HOP = 320
NUM_BANDWIDTHS = 4
NUM_CODEBOOKS = 8
CODEBOOK_SIZE = 1024


class _Params(nn.Module):
    """A group of named parameters (one node of the JAX tree)."""

    def __init__(self, **shapes):
        super().__init__()
        for name, shape in shapes.items():
            self.register_parameter(
                name, nn.Parameter(torch.zeros(*shape), requires_grad=False))


class _Block(nn.Module):
    def __init__(self):
        super().__init__()
        self.dwconv = _Params(w=(7, 1, DIM), b=(DIM,))
        self.norm = _Params(scale=(NUM_BANDWIDTHS, DIM), shift=(NUM_BANDWIDTHS, DIM))
        self.pwconv1 = _Params(w=(DIM, INTERMEDIATE_DIM), b=(INTERMEDIATE_DIM,))
        self.pwconv2 = _Params(w=(INTERMEDIATE_DIM, DIM), b=(DIM,))
        self.gamma = nn.Parameter(torch.zeros(DIM), requires_grad=False)


class Vocos(nn.Module):
    def __init__(self):
        super().__init__()
        self.codebook_weights = nn.Parameter(
            torch.zeros(NUM_CODEBOOKS, CODEBOOK_SIZE, INPUT_CHANNELS),
            requires_grad=False)
        self.embed = _Params(w=(7, INPUT_CHANNELS, DIM), b=(DIM,))
        self.norm = _Params(scale=(NUM_BANDWIDTHS, DIM), shift=(NUM_BANDWIDTHS, DIM))
        self.blocks = nn.ModuleList(_Block() for _ in range(NUM_LAYERS))
        self.final_norm = _Params(scale=(DIM,), bias=(DIM,))
        self.head = _Params(w=(DIM, N_FFT + 2), b=(N_FFT + 2,))


def init_vocos(generator: torch.Generator) -> Dict:
    """Random tree with the JAX package's names and shapes (truncated
    normal std 0.02 ≈ clipped normal here)."""
    g = generator

    def tn(*shape):
        return (torch.randn(shape, generator=g).clamp(-2.0, 2.0)) * 0.02

    L = NUM_LAYERS
    return {
        "codebook_weights": torch.randn(
            NUM_CODEBOOKS, CODEBOOK_SIZE, INPUT_CHANNELS, generator=g),
        "embed": {"w": tn(7, INPUT_CHANNELS, DIM), "b": torch.zeros(DIM)},
        "norm": {"scale": torch.ones(NUM_BANDWIDTHS, DIM),
                 "shift": torch.zeros(NUM_BANDWIDTHS, DIM)},
        "blocks": {
            "dwconv": {"w": tn(L, 7, 1, DIM), "b": torch.zeros(L, DIM)},
            "norm": {"scale": torch.ones(L, NUM_BANDWIDTHS, DIM),
                     "shift": torch.zeros(L, NUM_BANDWIDTHS, DIM)},
            "pwconv1": {"w": tn(L, DIM, INTERMEDIATE_DIM),
                        "b": torch.zeros(L, INTERMEDIATE_DIM)},
            "pwconv2": {"w": tn(L, INTERMEDIATE_DIM, DIM), "b": torch.zeros(L, DIM)},
            "gamma": torch.full((L, DIM), 1e-6),
        },
        "final_norm": {"scale": torch.ones(DIM), "bias": torch.zeros(DIM)},
        "head": {"w": tn(DIM, N_FFT + 2), "b": torch.zeros(N_FFT + 2)},
    }


def codes_to_features(v: Vocos, codes: torch.Tensor) -> torch.Tensor:
    """[B, T, 8] int codes → [B, T, 128] (codebook-vector sum)."""
    cb = v.codebook_weights
    feats = torch.zeros(codes.shape[:2] + (INPUT_CHANNELS,), dtype=cb.dtype,
                        device=cb.device)
    for q in range(NUM_CODEBOOKS):
        feats = feats + cb[q][codes[..., q].clamp(0, CODEBOOK_SIZE - 1)]
    return feats


def _conv1d_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 groups: int = 1) -> torch.Tensor:
    """x [B, T, Cin], w [K, Cin/groups, Cout] → [B, T, Cout], SAME padding."""
    K = w.shape[0]
    y = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), b,
                 padding=K // 2, groups=groups)
    return y.transpose(1, 2)


def _ln(x, scale, shift, eps=1e-6):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + shift


TLen = Optional[Union[int, torch.Tensor]]  # valid frames: all rows, or [B]


def _valid_frames(T: int, t_len, device) -> torch.Tensor:
    """[B or 1, T] bool: frame j < t_len (of its row)."""
    tl = t_len.reshape(-1, 1) if isinstance(t_len, torch.Tensor) else t_len
    return torch.arange(T, device=device)[None, :] < tl


def backbone_apply(v: Vocos, feats: torch.Tensor, bandwidth_id: int,
                   t_len: TLen = None) -> torch.Tensor:
    """[B, T, 128] → [B, T, 512]. Rows ≥ t_len (per batch row when t_len
    is a [B] tensor) are re-zeroed after the embed conv and after every
    block, so the conv windows at the boundary see the zeros an
    exact-length run would see."""
    if t_len is None:
        mask = lambda x: x  # noqa: E731
    else:
        valid = _valid_frames(feats.shape[1], t_len, feats.device)[..., None]
        mask = lambda x: torch.where(valid, x, 0.0)  # noqa: E731
    bw = bandwidth_id
    x = _conv1d_same(feats, v.embed.w, v.embed.b)
    x = mask(_ln(x, v.norm.scale[bw], v.norm.shift[bw]))
    for bp in v.blocks:
        h = _conv1d_same(x, bp.dwconv.w, bp.dwconv.b, groups=DIM)
        h = _ln(h, bp.norm.scale[bw], bp.norm.shift[bw])
        h = h @ bp.pwconv1.w + bp.pwconv1.b
        h = F.gelu(h)
        h = h @ bp.pwconv2.w + bp.pwconv2.b
        x = mask(x + bp.gamma * h)
    return mask(_ln(x, v.final_norm.scale, v.final_norm.bias))


def istft(spec: torch.Tensor, n_fft: int = N_FFT, hop: int = HOP,
          frame_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse STFT, periodic Hann window, "same" padding: complex
    [B, T, n_fft//2 + 1] → [B, T·hop]. irfft + overlap-add of R = n_fft/hop
    hop-sized strips, normalized by the window envelope; frames with
    frame_valid [B, T] false leave both the sum and the envelope."""
    B, T, _ = spec.shape
    R = n_fft // hop
    win = torch.hann_window(n_fft, periodic=True, dtype=torch.float64,
                            device=spec.device).float()
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * win  # [B, T, n_fft]
    out_len = n_fft + hop * (T - 1)
    fv = None
    if frame_valid is not None:
        fv = frame_valid.to(frames.dtype)
        frames = frames * fv[:, :, None]
    strips = frames.reshape(B, T, R, hop)
    out = torch.zeros((B, T + R - 1, hop), dtype=frames.dtype, device=spec.device)
    env_strips = (win ** 2).reshape(R, hop)
    env = torch.zeros((B if fv is not None else 1, T + R - 1, hop),
                      dtype=frames.dtype, device=spec.device)
    for j in range(R):
        out[:, j: j + T] += strips[:, :, j]
        if fv is None:
            env[:, j: j + T] += env_strips[j]
        else:
            env[:, j: j + T] += env_strips[j][None, None] * fv[:, :, None]
    wave = out.reshape(B, out_len) / torch.clamp(env.reshape(-1, out_len), min=1e-11)
    pad = (n_fft - hop) // 2
    return wave[:, pad: out_len - pad]


def head_apply(v: Vocos, x: torch.Tensor, frame_valid=None) -> torch.Tensor:
    """[B, T, 512] → waveform [B, T·hop] via the log-magnitude/phase ISTFT.
    The magnitude clamp keeps untrained weights finite (a no-op for a
    trained checkpoint)."""
    h = x @ v.head.w + v.head.b
    mag, phase = h.chunk(2, dim=-1)
    mag = torch.clamp(torch.exp(torch.clamp(mag, max=1e2)), max=1e30)
    spec = torch.complex(mag * torch.cos(phase), mag * torch.sin(phase))
    return istft(spec, frame_valid=frame_valid)


def vocos_decode(v: Vocos, codes: torch.Tensor, bandwidth_id: int = 2,
                 t_len: TLen = None) -> torch.Tensor:
    """[B, T, 8] codes → [B, T·hop] waveform. t_len (an int, or [B] for a
    batch of requests) marks the valid frames: features beyond it are
    zeroed before the conv stack (code 0 is a real codebook vector, not
    silence) and their frames leave the ISTFT."""
    feats = codes_to_features(v, codes)
    fv = None
    if t_len is not None:
        fv = _valid_frames(codes.shape[1], t_len, codes.device).expand(codes.shape[0], -1)
        feats = torch.where(fv[..., None], feats, 0.0)
    x = backbone_apply(v, feats, bandwidth_id, t_len=t_len)
    return head_apply(v, x, frame_valid=fv)


def convert_vocos_state_dict(sd: Dict[str, Any]) -> Dict[str, Any]:
    """The `charactr/vocos-encodec-24khz` state dict (numpy or torch leaves,
    torch layouts) → the tree `load_tree(Vocos(), ...)` takes, f32 numpy
    leaves: Conv1d [Cout, Cin, K] → [K, Cin, Cout], the depthwise conv
    [C, 1, K] → [K, 1, C], Linear [out, in] → [in, out]; AdaLayerNorm's
    scale and shift stay [num_bandwidths, C] tables; the 8 blocks stacked."""

    def g(key):
        a = sd[key]
        if isinstance(a, torch.Tensor):
            a = a.detach().to("cpu", torch.float32).numpy()
        return np.ascontiguousarray(a, np.float32)

    def conv(key):
        return {"w": np.ascontiguousarray(g(f"{key}.weight").transpose(2, 1, 0)),
                "b": g(f"{key}.bias")}

    def lin(key):
        return {"w": np.ascontiguousarray(g(f"{key}.weight").T), "b": g(f"{key}.bias")}

    def ada(key):
        return {"scale": g(f"{key}.scale.weight"), "shift": g(f"{key}.shift.weight")}

    blocks = [{"dwconv": conv(f"backbone.convnext.{i}.dwconv"),
               "norm": ada(f"backbone.convnext.{i}.norm"),
               "pwconv1": lin(f"backbone.convnext.{i}.pwconv1"),
               "pwconv2": lin(f"backbone.convnext.{i}.pwconv2"),
               "gamma": g(f"backbone.convnext.{i}.gamma")} for i in range(NUM_LAYERS)]

    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return np.stack(nodes)

    return {
        # the EnCodec quantizer's codebooks, stored under the feature extractor
        "codebook_weights": np.stack([
            g(f"feature_extractor.encodec.quantizer.vq.layers.{q}._codebook.embed")
            for q in range(NUM_CODEBOOKS)]),
        "embed": conv("backbone.embed"),
        "norm": ada("backbone.norm"),
        "blocks": stack(blocks),
        "final_norm": {"scale": g("backbone.final_layer_norm.weight"),
                       "bias": g("backbone.final_layer_norm.bias")},
        "head": lin("head.out"),
    }
