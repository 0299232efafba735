"""EnCodec 24 kHz codec (SEANet encoder / decoder + residual VQ), the port of
vallex_tpu/codec/encodec.py: 24 kHz mono, 6 kbps ⇒ 8 codebooks × 1024 bins
at 75 frames/s (320-sample hop).

  encoder: Conv1d(1→32, k7) → per ratio r ∈ [2, 4, 5, 8]: [ResidualUnit(C):
      ELU → Conv(k3, C→C/2) → ELU → Conv(k1, C/2→C), added to a 1×1 conv
      shortcut of the input; then ELU → Conv(C→2C, k=2r, stride r)]
      → 2-layer LSTM (residual skip) → ELU → Conv1d(512→128, k7)
  quantizer: residual VQ, nearest neighbour per stage over 128-d codebooks
  decoder: the mirror with transposed convs (k=2r, stride r), ratios [8, 5, 4, 2]

Every conv is causal with a REFLECT left pad of K_eff − stride samples
(encodec's SConv1d, causal=True, pad_mode='reflect'); a pad longer than
the input reflects again, as `jnp.pad` does, so a clip of under 7 frames
encodes as in the JAX package. A transposed conv trims K − stride samples
on the right.

The module holds torch's layouts (conv [Cout, Cin, K], transposed conv
[Cin, Cout, K], `nn.LSTM`); the parameter tree (`init_encodec`,
`convert_encodec_state_dict`, `encodec-jax.npz`) is the JAX package's
([K, Cin, Cout] kernels, the transposed ones spatially flipped for
`lax.conv_transpose`; LSTM `wi [C, 4H]`, `wh [H, 4H]`, `bi`, `bh`), and
`encodec_from_tree` converts one into the other. Tensors in and out are
channels-last ([B, T, C]) as in the JAX code. The convolutions, the LSTM
and the RVQ distances run in true f32 whatever the global TF32 flags say:
TF32 can move an RVQ argmin.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

Params = Dict[str, Any]

RATIOS = [8, 5, 4, 2]  # decoder order; the encoder runs them reversed
N_FILTERS = 32
DIM = 128  # latent dim
LSTM_DIM = 512
NUM_CODEBOOKS = 8
CODEBOOK_SIZE = 1024
HOP = 320  # = prod(RATIOS)
SAMPLE_RATE = 24000


# ---------------------------------------------------------------------------
# Module
# ---------------------------------------------------------------------------

class _Conv(nn.Module):
    """Causal Conv1d (weight [Cout, Cin, K]), or with `transposed` a causal
    ConvTranspose1d (weight [Cin, Cout, K])."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, transposed: bool = False):
        super().__init__()
        shape = (cin, cout, k) if transposed else (cout, cin, k)
        self.weight = nn.Parameter(torch.zeros(shape), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout), requires_grad=False)
        self.stride, self.transposed = stride, transposed

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, C, T]
        K, s = self.weight.shape[-1], self.stride
        if self.transposed:
            y = F.conv_transpose1d(x, self.weight, self.bias, stride=s)
            return y[..., : y.shape[-1] - (K - s)] if K > s else y
        return F.conv1d(_reflect_left(x, max(K - s, 0)), self.weight, self.bias, stride=s)


class _Stage(nn.Module):
    def __init__(self, ch: int, ratio: int, decoder: bool):
        super().__init__()
        if decoder:  # ch → ch/2 up, then a residual unit at ch/2
            self.up = _Conv(ch, ch // 2, 2 * ratio, ratio, transposed=True)
            ch //= 2
        self.res_conv1 = _Conv(ch, ch // 2, 3)
        self.res_conv2 = _Conv(ch // 2, ch, 1)
        self.shortcut = _Conv(ch, ch, 1)
        if not decoder:
            self.down = _Conv(ch, 2 * ch, 2 * ratio, ratio)

    def residual(self, x: torch.Tensor) -> torch.Tensor:
        h = self.res_conv2(F.elu(self.res_conv1(F.elu(x))))
        return self.shortcut(x) + h


class _Half(nn.Module):
    """The encoder or the decoder: init conv, stages, LSTM, final conv."""

    def __init__(self, decoder: bool):
        super().__init__()
        ch = N_FILTERS * 2 ** len(RATIOS) if decoder else N_FILTERS
        self.init = _Conv(DIM, ch, 7) if decoder else _Conv(1, ch, 7)
        stages = []
        for r in (RATIOS if decoder else reversed(RATIOS)):
            stages.append(_Stage(ch, r, decoder))
            ch = ch // 2 if decoder else ch * 2
        self.stages = nn.ModuleList(stages)
        self.lstm = nn.LSTM(LSTM_DIM, LSTM_DIM, num_layers=2, batch_first=True)
        self.final = _Conv(ch, 1, 7) if decoder else _Conv(ch, DIM, 7)
        for p in self.lstm.parameters():
            p.requires_grad_(False)

    def skip_lstm(self, x: torch.Tensor) -> torch.Tensor:
        """encodec's SLSTM: y = x + lstm(x), over [B, C, T]."""
        h = x.transpose(1, 2)
        return (h + self.lstm(h)[0]).transpose(1, 2)


class EnCodec(nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder = _Half(decoder=False)
        self.decoder = _Half(decoder=True)
        self.codebooks = nn.Parameter(torch.zeros(NUM_CODEBOOKS, CODEBOOK_SIZE, DIM),
                                      requires_grad=False)


def _reflect_left(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the last axis on the left by `pad`, reflecting again where
    `pad` exceeds the length − 1, as `jnp.pad(mode="reflect")`."""
    if pad == 0:
        return x
    n = x.shape[-1]
    idx = torch.arange(-pad, n, device=x.device)
    if n == 1:
        idx = torch.zeros_like(idx)
    else:
        period = 2 * (n - 1)
        idx = idx.abs() % period
        idx = torch.where(idx >= n, period - idx, idx)
    return x.index_select(-1, idx)


@contextlib.contextmanager
def true_f32():
    """f32 products and convolutions, not TF32, for the calls inside
    (restores both flags after)."""
    mm, cd = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


# ---------------------------------------------------------------------------
# Parameter trees (the JAX package's layout)
# ---------------------------------------------------------------------------

def init_encodec(generator: torch.Generator) -> Params:
    """Random tree with the JAX package's names, shapes and distributions
    (uniform ±1/sqrt(K·Cin) conv kernels and biases, uniform ±1/sqrt(H)
    LSTM weights, normal codebooks), drawn from `generator`."""
    g = generator

    def uniform(shape, s):
        return (torch.rand(shape, generator=g) * 2 - 1) * s

    def conv(k, cin, cout):
        s = 1.0 / (k * cin) ** 0.5
        return {"w": uniform((k, cin, cout), s), "b": uniform((cout,), s)}

    def lstm(cin, h):
        s = 1.0 / h ** 0.5
        return {"wi": uniform((cin, 4 * h), s), "wh": uniform((h, 4 * h), s),
                "bi": uniform((4 * h,), s), "bh": uniform((4 * h,), s)}

    enc: Params = {"init": conv(7, 1, N_FILTERS), "stages": []}
    ch = N_FILTERS
    for r in reversed(RATIOS):
        enc["stages"].append({"res_conv1": conv(3, ch, ch // 2), "res_conv2": conv(1, ch // 2, ch),
                              "shortcut": conv(1, ch, ch), "down": conv(2 * r, ch, 2 * ch)})
        ch *= 2
    enc["lstm"] = [lstm(ch, ch), lstm(ch, ch)]
    enc["final"] = conv(7, ch, DIM)
    dec: Params = {"init": conv(7, DIM, ch), "lstm": [lstm(ch, ch), lstm(ch, ch)], "stages": []}
    for r in RATIOS:
        dec["stages"].append({"up": conv(2 * r, ch, ch // 2), "res_conv1": conv(3, ch // 2, ch // 4),
                              "res_conv2": conv(1, ch // 4, ch // 2),
                              "shortcut": conv(1, ch // 2, ch // 2)})
        ch //= 2
    dec["final"] = conv(7, ch, 1)
    codebooks = torch.randn((NUM_CODEBOOKS, CODEBOOK_SIZE, DIM), generator=g)
    return {"encoder": enc, "decoder": dec, "codebooks": codebooks}


def _f32(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).cpu()
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _module_state(tree: Params) -> Dict[str, torch.Tensor]:
    """JAX-layout tree → the module's state dict (torch layouts)."""
    sd: Dict[str, torch.Tensor] = {}

    def conv(name: str, p: Params, transposed: bool = False) -> None:
        w = _f32(p["w"])  # [K, Cin, Cout]
        # lax.conv_transpose correlates with the kernel torch's transposed
        # conv scatters: un-flip K on the way back
        sd[f"{name}.weight"] = (w.flip(0).permute(1, 2, 0) if transposed
                                else w.permute(2, 1, 0)).contiguous()
        sd[f"{name}.bias"] = _f32(p["b"])

    def lstm(name: str, layers: List[Params]) -> None:
        for i, p in enumerate(layers):
            sd[f"{name}.weight_ih_l{i}"] = _f32(p["wi"]).T.contiguous()
            sd[f"{name}.weight_hh_l{i}"] = _f32(p["wh"]).T.contiguous()
            sd[f"{name}.bias_ih_l{i}"] = _f32(p["bi"])
            sd[f"{name}.bias_hh_l{i}"] = _f32(p["bh"])

    for half in ("encoder", "decoder"):
        t = tree[half]
        conv(f"{half}.init", t["init"])
        conv(f"{half}.final", t["final"])
        lstm(f"{half}.lstm", t["lstm"])
        for i, st in enumerate(t["stages"]):
            for k, p in st.items():
                conv(f"{half}.stages.{i}.{k}", p, transposed=(k == "up"))
    sd["codebooks"] = _f32(tree["codebooks"])
    return sd


def encodec_from_tree(tree: Params, *, device="cpu") -> EnCodec:
    """A parameter tree (numpy or torch leaves) → `EnCodec` on `device`, f32.
    Raises on a missing or extra leaf and on a shape mismatch."""
    model = EnCodec()
    model.load_state_dict(_module_state(tree), strict=True)
    model = model.to(device)
    model.encoder.lstm.flatten_parameters()
    model.decoder.lstm.flatten_parameters()
    return model


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

@torch.inference_mode()
def encode_latent(model: EnCodec, wav: torch.Tensor) -> torch.Tensor:
    """[B, samples] mono (a multiple of HOP) → [B, T, 128] latents."""
    enc = model.encoder
    with true_f32():
        x = enc.init(wav.float()[:, None, :])
        for st in enc.stages:
            x = st.down(F.elu(st.residual(x)))
        x = enc.final(F.elu(enc.skip_lstm(x)))
    return x.transpose(1, 2)


@torch.inference_mode()
def rvq_encode(model: EnCodec, latents: torch.Tensor) -> torch.Tensor:
    """[B, T, 128] → [B, T, 8] int64 codes (residual nearest neighbour by
    argmin ‖e‖² − 2 r·e, the JAX package's expression, so that near ties
    fall the same way)."""
    residual = latents
    codes = []
    with true_f32():
        for e in model.codebooks:  # [1024, 128]
            dist = (e * e).sum(-1) - 2 * (residual @ e.T)
            idx = torch.argmin(dist, dim=-1)
            codes.append(idx)
            residual = residual - e[idx]
    return torch.stack(codes, dim=-1)


@torch.inference_mode()
def rvq_decode(model: EnCodec, codes: torch.Tensor) -> torch.Tensor:
    """[B, T, 8] codes → [B, T, 128] quantized latents."""
    cb = model.codebooks
    out = torch.zeros(codes.shape[:2] + (DIM,), dtype=cb.dtype, device=cb.device)
    for q in range(NUM_CODEBOOKS):
        out = out + cb[q][codes[..., q]]
    return out


@torch.inference_mode()
def decode_wave(model: EnCodec, latents: torch.Tensor) -> torch.Tensor:
    """[B, T, 128] quantized latents → [B, T·320] waveform."""
    dec = model.decoder
    with true_f32():
        x = dec.skip_lstm(dec.init(latents.float().transpose(1, 2)))
        for st in dec.stages:
            x = st.residual(st.up(F.elu(x)))
        x = dec.final(F.elu(x))
    return x[:, 0]


def encode(model: EnCodec, wav: torch.Tensor) -> torch.Tensor:
    """[B, samples] → [B, T, 8] codes, T = ceil(samples / 320) (reference:
    data/tokenizer.py:99-111). The waveform is zero-padded on the right to
    a multiple of HOP, as in the JAX package."""
    rem = wav.shape[-1] % HOP
    if rem:
        wav = F.pad(wav, (0, HOP - rem))
    return rvq_encode(model, encode_latent(model, wav))


def decode(model: EnCodec, codes: torch.Tensor) -> torch.Tensor:
    """[B, T, 8] → [B, T·320] waveform (reference: data/tokenizer.py:95-96)."""
    return decode_wave(model, rvq_decode(model, codes))


# ---------------------------------------------------------------------------
# Torch conversion (the encodec pip checkpoint, weight norm fused)
# ---------------------------------------------------------------------------

def _fuse_weight_norm(g, v) -> np.ndarray:
    """weight_norm: w = g · v / ‖v‖ (norm over all dims but dim 0)."""
    v = np.asarray(v, np.float32)
    g = np.asarray(g, np.float32)
    norm = np.sqrt((v ** 2).sum(axis=(1, 2), keepdims=True))
    return g * v / norm


def convert_encodec_state_dict(sd: Dict[str, Any]) -> Params:
    """The encodec_model_24khz state dict (numpy, torch layouts: conv
    [Cout, Cin, K]) → the JAX-layout tree, weight norm fused.

    Module paths follow encodec's conv wrappers (SConv1d.conv = NormConv1d,
    NormConv1d.conv = the weight-normed nn.Conv1d, so two `.conv` levels;
    SConvTranspose1d.convtr.convtr likewise; reference:
    data/tokenizer.py:41-60)."""

    def kernel(base: str) -> np.ndarray:
        if f"{base}.weight_g" in sd:
            return _fuse_weight_norm(sd[f"{base}.weight_g"], sd[f"{base}.weight_v"])
        return np.asarray(sd[f"{base}.weight"], np.float32)

    def conv(prefix: str) -> Params:
        base = f"{prefix}.conv.conv"
        return {"w": np.transpose(kernel(base), (2, 1, 0)).copy(),
                "b": np.asarray(sd[f"{base}.bias"], np.float32)}

    def convtr(prefix: str) -> Params:
        # [Cin, Cout, K] → [K, Cin, Cout], flipped along K for lax.conv_transpose
        base = f"{prefix}.convtr.convtr"
        return {"w": np.transpose(kernel(base), (2, 0, 1))[::-1].copy(),
                "b": np.asarray(sd[f"{base}.bias"], np.float32)}

    def lstm(prefix: str, layer: int) -> Params:
        return {
            "wi": np.asarray(sd[f"{prefix}.lstm.weight_ih_l{layer}"], np.float32).T.copy(),
            "wh": np.asarray(sd[f"{prefix}.lstm.weight_hh_l{layer}"], np.float32).T.copy(),
            "bi": np.asarray(sd[f"{prefix}.lstm.bias_ih_l{layer}"], np.float32),
            "bh": np.asarray(sd[f"{prefix}.lstm.bias_hh_l{layer}"], np.float32),
        }

    # encoder.model: 0 init conv; per stage [resblock, ELU, downsample] =
    # (1, 2, 3) … (10, 11, 12); 13 SLSTM; 14 ELU; 15 final conv
    enc: Params = {"init": conv("encoder.model.0"), "stages": []}
    i = 1
    for _ in RATIOS:
        enc["stages"].append({
            "res_conv1": conv(f"encoder.model.{i}.block.1"),
            "res_conv2": conv(f"encoder.model.{i}.block.3"),
            "shortcut": conv(f"encoder.model.{i}.shortcut"),
            "down": conv(f"encoder.model.{i + 2}"),
        })
        i += 3
    enc["lstm"] = [lstm(f"encoder.model.{i}", 0), lstm(f"encoder.model.{i}", 1)]
    enc["final"] = conv(f"encoder.model.{i + 2}")

    # decoder.model: 0 init conv; 1 SLSTM; per stage [ELU, convtr, resblock]
    # = (2, 3, 4) … (11, 12, 13); 14 ELU; 15 final conv
    dec: Params = {"init": conv("decoder.model.0"), "stages": [],
                   "lstm": [lstm("decoder.model.1", 0), lstm("decoder.model.1", 1)]}
    i = 3
    for _ in RATIOS:
        dec["stages"].append({
            "up": convtr(f"decoder.model.{i}"),
            "res_conv1": conv(f"decoder.model.{i + 1}.block.1"),
            "res_conv2": conv(f"decoder.model.{i + 1}.block.3"),
            "shortcut": conv(f"decoder.model.{i + 1}.shortcut"),
        })
        i += 3
    dec["final"] = conv(f"decoder.model.{i}")

    cb = np.stack([np.asarray(sd[f"quantizer.vq.layers.{q}._codebook.embed"], np.float32)
                   for q in range(NUM_CODEBOOKS)])
    return {"encoder": enc, "decoder": dec, "codebooks": cb}
