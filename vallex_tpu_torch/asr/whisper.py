"""Whisper encoder / decoder for transcript-less `make_prompt` (port of
vallex_tpu/asr/whisper.py).

The reference transcribes enrollment clips with openai-whisper medium
(reference utils/prompt_making.py:32-55, 87-109: detect_language, then
decode). Weights come from a HuggingFace Whisper checkpoint
(`convert_hf_state_dict`); without one, utils/whisper_transcribe.py asks
for a transcript instead.

Architecture facts reproduced (openai/whisper; HF WhisperModel):
  - mel: 16 kHz, n_fft 400, hop 160, Hann, 80 slaney mel banks to 8 kHz,
    log10, floor at max − 8, (x + 4) / 4;
  - encoder: conv(80→d, k3, s1) GELU, conv(d→d, k3, s2) GELU, + sinusoidal
    PE, pre-norm blocks (MHA + 4d GELU MLP), final LN;
  - decoder: token embedding + LEARNED positional embedding, pre-norm
    blocks with causal self-attention, cross-attention over the encoder
    states and a 4d GELU MLP, final LN, logits tied to the token embedding;
  - attention: q scaled by hd^-0.5; the k projection has NO bias; GELU is
    exact (erf).

The module's parameters carry the JAX tree's names and layouts ([in, out]
products, conv kernels [3, Cin, D], blocks stacked [NL, ...] in the tree),
so `convert.load_tree` fills it. Attention is plain tensor ops: no kernel
stands behind it in either package. Decoding keeps a preallocated K/V
cache per layer and reads one flag from the device per step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

Params = Dict[str, Any]

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160
N_MELS = 80
N_FRAMES = 3000  # 30 s


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    d_model: int = 1024  # medium
    num_heads: int = 16
    encoder_layers: int = 24
    decoder_layers: int = 24
    vocab: int = 51865
    max_source_positions: int = 1500
    max_target_positions: int = 448
    # special tokens (multilingual vocab)
    eot: int = 50257
    sot: int = 50258
    translate: int = 50358
    transcribe: int = 50359
    no_timestamps: int = 50363
    lang_base: int = 50259  # <|en|>; language tokens are contiguous

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


# Whisper's language-token order (openai/whisper tokenizer LANGUAGES);
# token id = lang_base + index.
_LANG_ORDER = (
    "en zh de es ru ko fr ja pt tr pl ca nl ar sv it id hi fi vi he uk el "
    "ms cs ro da hu ta no th ur hr bg lt la mi ml cy sk te fa lv bn sr az "
    "sl kn et mk br eu is hy ne mn bs kk sq sw gl mr pa si km sn yo so af "
    "oc ka be tg sd gu am yi lo uz fo ht ps tk nn mt sa lb my bo tl mg as "
    "tt haw ln ha ba jw su"
).split()


def lang_token(cfg: WhisperConfig, lang: str) -> int:
    return cfg.lang_base + _LANG_ORDER.index(lang)


def token_lang(cfg: WhisperConfig, token: int) -> str:
    return _LANG_ORDER[token - cfg.lang_base]


# --------------------------------------------------------------------------
# log-mel front end
# --------------------------------------------------------------------------


def _mel_filters() -> np.ndarray:
    """80 slaney-normalized slaney-scale mel filters over 201 fft bins →
    [80, 201] (librosa.filters.mel(16000, 400, n_mels=80), Whisper's)."""
    n_freqs = N_FFT // 2 + 1
    fft_freqs = np.linspace(0, SAMPLE_RATE / 2, n_freqs)
    log_step = math.log(6.4) / 27.0

    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-9) / 1000.0) / log_step,
                        f / 200.0 * 3.0)

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        return np.where(m >= 15.0, 1000.0 * np.exp(log_step * (m - 15.0)), 200.0 * m / 3.0)

    mel_pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(8000.0), N_MELS + 2))
    fb = np.zeros((N_MELS, n_freqs))
    for i in range(N_MELS):
        lo, ctr, hi = mel_pts[i], mel_pts[i + 1], mel_pts[i + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-9)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-9)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
        fb[i] *= 2.0 / (hi - lo)  # slaney area normalization
    return fb.astype(np.float32)


def log_mel_spectrogram(wav: torch.Tensor) -> torch.Tensor:
    """16 kHz waveform [480000] (30 s, padded or trimmed) → log-mel
    [80, 3000], as Whisper's front end computes it (centred reflect-padded
    STFT, the last frame dropped)."""
    win = torch.hann_window(N_FFT, periodic=True, dtype=torch.float32, device=wav.device)
    spec = torch.stft(wav.float(), N_FFT, HOP, window=win, center=True, pad_mode="reflect",
                      return_complex=True)[:, :-1]  # [201, 3000]
    power = spec.real ** 2 + spec.imag ** 2
    mel = torch.from_numpy(_mel_filters()).to(wav.device) @ power  # [80, 3000]
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
    return (log_spec + 4.0) / 4.0


def pad_or_trim(wav: np.ndarray, length: int = SAMPLE_RATE * 30) -> np.ndarray:
    if len(wav) >= length:
        return wav[:length]
    return np.pad(wav, (0, length - len(wav)))


# --------------------------------------------------------------------------
# module and parameters
# --------------------------------------------------------------------------


class _Params(nn.Module):
    """A group of named parameters (one node of the JAX tree)."""

    def __init__(self, **shapes):
        super().__init__()
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(torch.zeros(*shape), requires_grad=False))


def _attn_params(d: int) -> _Params:
    return _Params(q_w=(d, d), q_b=(d,), k_w=(d, d), v_w=(d, d), v_b=(d,), o_w=(d, d),
                   o_b=(d,))


class _Block(nn.Module):
    def __init__(self, d: int, cross: bool):
        super().__init__()
        self.self_attn = _attn_params(d)
        self.ln1 = _Params(scale=(d,), bias=(d,))
        self.fc1_w = nn.Parameter(torch.zeros(d, 4 * d), requires_grad=False)
        self.fc1_b = nn.Parameter(torch.zeros(4 * d), requires_grad=False)
        self.fc2_w = nn.Parameter(torch.zeros(4 * d, d), requires_grad=False)
        self.fc2_b = nn.Parameter(torch.zeros(d), requires_grad=False)
        self.ln_mlp = _Params(scale=(d,), bias=(d,))
        if cross:
            self.cross_attn = _attn_params(d)
            self.ln_cross = _Params(scale=(d,), bias=(d,))


class Whisper(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.conv1_w = nn.Parameter(torch.zeros(3, N_MELS, d), requires_grad=False)
        self.conv1_b = nn.Parameter(torch.zeros(d), requires_grad=False)
        self.conv2_w = nn.Parameter(torch.zeros(3, d, d), requires_grad=False)
        self.conv2_b = nn.Parameter(torch.zeros(d), requires_grad=False)
        self.enc_pos = nn.Parameter(torch.zeros(cfg.max_source_positions, d), requires_grad=False)
        self.enc_blocks = nn.ModuleList(_Block(d, False) for _ in range(cfg.encoder_layers))
        self.enc_ln = _Params(scale=(d,), bias=(d,))
        self.tok_emb = nn.Parameter(torch.zeros(cfg.vocab, d), requires_grad=False)
        self.dec_pos = nn.Parameter(torch.zeros(cfg.max_target_positions, d), requires_grad=False)
        self.dec_blocks = nn.ModuleList(_Block(d, True) for _ in range(cfg.decoder_layers))
        self.dec_ln = _Params(scale=(d,), bias=(d,))


def _sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's encoder positional table (openai/whisper model.py)."""
    log_timescale = math.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def init_whisper(cfg: WhisperConfig, generator: torch.Generator) -> Params:
    """Random tree with the JAX package's names, shapes and scales, drawn
    from `generator` on its device."""
    g, d = generator, cfg.d_model
    dev = g.device

    def normal(*shape, scale):
        return torch.randn(shape, generator=g, device=dev) * scale

    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    def ln(NL):
        return {"scale": torch.ones((NL, d), device=dev), "bias": zeros(NL, d)}

    def attn(NL):
        s = 1.0 / math.sqrt(d)
        return {"q_w": normal(NL, d, d, scale=s), "q_b": zeros(NL, d),
                "k_w": normal(NL, d, d, scale=s),  # no bias (whisper)
                "v_w": normal(NL, d, d, scale=s), "v_b": zeros(NL, d),
                "o_w": normal(NL, d, d, scale=s), "o_b": zeros(NL, d)}

    def blocks(NL, cross):
        s = 1.0 / math.sqrt(d)
        p = {"self_attn": attn(NL), "ln1": ln(NL),
             "fc1_w": normal(NL, d, 4 * d, scale=s), "fc1_b": zeros(NL, 4 * d),
             "fc2_w": normal(NL, 4 * d, d, scale=s), "fc2_b": zeros(NL, d),
             "ln_mlp": ln(NL)}
        if cross:
            p["cross_attn"] = attn(NL)
            p["ln_cross"] = ln(NL)
        return p

    final_ln = {"scale": torch.ones(d, device=dev), "bias": zeros(d)}
    return {
        "conv1_w": normal(3, N_MELS, d, scale=0.05), "conv1_b": zeros(d),
        "conv2_w": normal(3, d, d, scale=0.05), "conv2_b": zeros(d),
        "enc_pos": torch.from_numpy(_sinusoids(cfg.max_source_positions, d)).to(dev),
        "enc_blocks": blocks(cfg.encoder_layers, False),
        "enc_ln": dict(final_ln),
        "tok_emb": normal(cfg.vocab, d, scale=0.02),
        "dec_pos": normal(cfg.max_target_positions, d, scale=0.02),
        "dec_blocks": blocks(cfg.decoder_layers, True),
        "dec_ln": dict(final_ln),
    }


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------


def _ln(p: _Params, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p.scale, p.bias, eps=1e-5)


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    """[..., T, D] → [..., H, T, hd]."""
    return x.unflatten(-1, (h, -1)).transpose(-3, -2)


def _attn(p: _Params, q_x: torch.Tensor, kv_x: torch.Tensor, h: int,
          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q_x [Tq, D], kv_x [Tk, D] → [Tq, D]."""
    hd = q_x.shape[-1] // h
    q = _heads(q_x @ p.q_w + p.q_b, h) * hd ** -0.5
    k = _heads(kv_x @ p.k_w, h)
    v = _heads(kv_x @ p.v_w + p.v_b, h)
    s = q @ k.transpose(-1, -2)
    if mask is not None:
        s = s + mask
    o = torch.softmax(s, dim=-1) @ v  # [H, Tq, hd]
    return o.transpose(0, 1).flatten(1) @ p.o_w + p.o_b


def _mlp(bp: _Block, x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x @ bp.fc1_w + bp.fc1_b) @ bp.fc2_w + bp.fc2_b


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int) -> torch.Tensor:
    """x [T, Cin], w [3, Cin, D], zero padding 1 → [T / stride, D]."""
    y = F.conv1d(x.T[None], w.permute(2, 1, 0), b, stride=stride, padding=1)
    return y[0].T


@torch.inference_mode()
def encode(model: Whisper, mel: torch.Tensor) -> torch.Tensor:
    """mel [80, 3000] → encoder states [1500, D]."""
    cfg = model.cfg
    y = F.gelu(_conv(mel.T, model.conv1_w, model.conv1_b, 1))
    y = F.gelu(_conv(y, model.conv2_w, model.conv2_b, 2))
    h = y + model.enc_pos
    for bp in model.enc_blocks:
        hn = _ln(bp.ln1, h)
        h = h + _attn(bp.self_attn, hn, hn, cfg.num_heads)
        h = h + _mlp(bp, _ln(bp.ln_mlp, h))
    return _ln(model.enc_ln, h)


@torch.inference_mode()
def decoder_forward(model: Whisper, tokens: torch.Tensor, enc: torch.Tensor) -> torch.Tensor:
    """Teacher-forced full-sequence decoder: tokens [T] → logits [T, vocab]."""
    cfg, T = model.cfg, tokens.shape[0]
    h = model.tok_emb[tokens] + model.dec_pos[:T]
    pos = torch.arange(T, device=h.device)
    causal = torch.where(pos[:, None] >= pos[None, :], 0.0, -1e30)[None]
    for bp in model.dec_blocks:
        hn = _ln(bp.ln1, h)
        h = h + _attn(bp.self_attn, hn, hn, cfg.num_heads, causal)
        h = h + _attn(bp.cross_attn, _ln(bp.ln_cross, h), enc, cfg.num_heads)
        h = h + _mlp(bp, _ln(bp.ln_mlp, h))
    return _ln(model.dec_ln, h) @ model.tok_emb.T


def _decode(model: Whisper, enc: torch.Tensor, prefix: torch.Tensor, max_len: int,
            lanes: int, pick):
    """The KV-cached decode loop both decoders share. `lanes` copies of
    `prefix` ([P] ids) are teacher-forced through the cache, then each step
    feeds a lane's token at `pos` and `pick(logits [lanes, vocab])` →
    (next ids [lanes], their logprob [lanes] or None) fills `pos + 1`; a
    lane that emitted eot is held at eot and stops scoring. Ends when
    every lane is done or the buffer is full. → (buf [lanes, max_len],
    sum_logprobs [lanes])."""
    cfg = model.cfg
    d, H = cfg.d_model, cfg.num_heads
    hd, dev = d // H, enc.device
    P = prefix.shape[0]
    cross = [((enc @ bp.cross_attn.k_w).unflatten(-1, (H, hd)).transpose(0, 1),
              (enc @ bp.cross_attn.v_w + bp.cross_attn.v_b).unflatten(-1, (H, hd))
              .transpose(0, 1)) for bp in model.dec_blocks]  # [H, 1500, hd]
    cache_k = torch.zeros((cfg.decoder_layers, lanes, H, max_len, hd), device=dev)
    cache_v = torch.zeros_like(cache_k)
    buf = torch.full((lanes, max_len), cfg.eot, dtype=torch.long, device=dev)
    buf[:, :P] = prefix.to(dev)
    done = torch.zeros(lanes, dtype=torch.bool, device=dev)
    sum_lp = torch.zeros(lanes, device=dev)
    pos = 0
    while pos < max_len - 1:
        x = model.tok_emb[buf[:, pos]] + model.dec_pos[pos]  # [lanes, D]
        for i, bp in enumerate(model.dec_blocks):
            sa = bp.self_attn
            hn = _ln(bp.ln1, x)
            q = (hn @ sa.q_w + sa.q_b).unflatten(-1, (H, hd))[:, :, None] * hd ** -0.5
            cache_k[i, :, :, pos] = (hn @ sa.k_w).unflatten(-1, (H, hd))
            cache_v[i, :, :, pos] = (hn @ sa.v_w + sa.v_b).unflatten(-1, (H, hd))
            a = torch.softmax(q @ cache_k[i, :, :, : pos + 1].transpose(-1, -2), dim=-1)
            x = x + (a @ cache_v[i, :, :, : pos + 1]).flatten(1) @ sa.o_w + sa.o_b
            ca = bp.cross_attn
            qc = (_ln(bp.ln_cross, x) @ ca.q_w + ca.q_b).unflatten(-1, (H, hd))[:, :, None]
            ac = torch.softmax((qc * hd ** -0.5) @ cross[i][0].transpose(-1, -2), dim=-1)
            x = x + (ac @ cross[i][1]).flatten(1) @ ca.o_w + ca.o_b
            x = x + _mlp(bp, _ln(bp.ln_mlp, x))
        pos += 1
        if pos < P:  # teacher-forced prefix: the cache only
            continue
        nxt, lp = pick(_ln(model.dec_ln, x) @ model.tok_emb.T)
        if lp is not None:
            sum_lp = sum_lp + torch.where(done, 0.0, lp)
        nxt = torch.where(done, cfg.eot, nxt)
        buf[:, pos] = nxt
        done = done | (nxt == cfg.eot)
        if bool(done.all()):
            break
    return buf, sum_lp


@torch.inference_mode()
def greedy_decode(model: Whisper, enc: torch.Tensor, prefix: torch.Tensor, *,
                  max_len: int = 224) -> torch.Tensor:
    """KV-cached greedy decode → token buffer [max_len] (eot-filled tail)."""
    def pick(logits):
        return torch.argmax(logits, dim=-1), None

    return _decode(model, enc, prefix, max_len, 1, pick)[0][0]


@torch.inference_mode()
def sampled_decode(model: Whisper, enc: torch.Tensor, prefix: torch.Tensor,
                   generator: torch.Generator, *, max_len: int, best_of: int = 5,
                   temperature: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """KV-cached SAMPLED decode over `best_of` independent lanes, the
    reference's transcription mode (utils/prompt_making.py:46:
    DecodingOptions(temperature=1.0, best_of=5, sample_len=150)), with
    openai-whisper's GreedyDecoder.update semantics at temperature > 0: the
    next token is drawn from Categorical(logits / temperature), the score
    adds the UNSCALED log-softmax of the drawn token, and a lane that
    emitted eot is held there (the eot logprob itself counts).
    → (buf [best_of, max_len], sum_logprobs [best_of])."""
    t = max(float(temperature), 1e-6)

    def pick(logits):
        probs = torch.softmax(logits / t, dim=-1)
        nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        lp = torch.log_softmax(logits, dim=-1).gather(-1, nxt[:, None])[:, 0]
        return nxt, lp

    return _decode(model, enc, prefix, max_len, best_of, pick)


def rank_samples(buf: np.ndarray, sum_logprobs: np.ndarray, *, prefix_len: int,
                 eot: int) -> int:
    """openai-whisper's MaximumLikelihoodRanker with length_penalty=None:
    each lane scores sum_logprobs / length, length = sampled tokens before
    the first eot. → the best lane's index."""
    scores = []
    for b in range(buf.shape[0]):
        ids = buf[b, prefix_len:]
        nz = np.nonzero(ids == eot)[0]
        length = int(nz[0]) if len(nz) else len(ids)
        scores.append(float(sum_logprobs[b]) / max(length, 1))
    return int(np.argmax(scores))


def detect_language(model: Whisper, enc: torch.Tensor) -> int:
    """→ the language token with the highest probability after <|sot|>
    (reference: whisper detect_language; prompt_making.py:40-44)."""
    cfg = model.cfg
    sot = torch.tensor([cfg.sot], device=enc.device)
    logits = decoder_forward(model, sot, enc)[0]
    lang_logits = logits[cfg.lang_base: cfg.lang_base + len(_LANG_ORDER)]
    return int(torch.argmax(lang_logits)) + cfg.lang_base


def transcribe_ids(model: Whisper, wav: np.ndarray, *, language: Optional[str] = None,
                   max_len: int = 224, temperature: float = 0.0, best_of: int = 1,
                   sample_len: Optional[int] = None, seed: int = 0):
    """16 kHz mono (padded or trimmed to 30 s) → (token ids after the sot
    sequence, detected language code), on the model's device.

    temperature 0 → greedy; above 0 → `best_of` sample lanes at that
    temperature ranked by average logprob, drawn from
    torch.Generator(seed) (the reference's mode: temperature 1.0, best_of
    5, sample_len 150)."""
    cfg = model.cfg
    dev = model.tok_emb.device
    mel = log_mel_spectrogram(torch.from_numpy(
        np.asarray(pad_or_trim(np.asarray(wav, np.float32)), np.float32)).to(dev))
    enc = encode(model, mel)
    lang_id = detect_language(model, enc) if language is None else lang_token(cfg, language)
    prefix = torch.tensor([cfg.sot, lang_id, cfg.transcribe, cfg.no_timestamps], device=dev)
    if temperature > 0.0:
        sl = sample_len if sample_len is not None else max_len - 4
        g = torch.Generator(device=dev).manual_seed(seed)
        buf, sum_lp = sampled_decode(model, enc, prefix, g, max_len=4 + sl + 1,
                                     best_of=best_of, temperature=temperature)
        buf = buf.cpu().numpy()
        ids = buf[rank_samples(buf, sum_lp.cpu().numpy(), prefix_len=4, eot=cfg.eot), 4:]
    else:
        ids = greedy_decode(model, enc, prefix, max_len=max_len).cpu().numpy()[4:]
    return ids[ids != cfg.eot], token_lang(cfg, lang_id)


# --------------------------------------------------------------------------
# HF checkpoint conversion
# --------------------------------------------------------------------------


def convert_hf_state_dict(sd: Dict[str, np.ndarray], cfg: WhisperConfig) -> Params:
    """A HuggingFace WhisperModel / WhisperForConditionalGeneration state
    dict (numpy) → this module's tree (numpy leaves, blocks stacked)."""
    g = lambda k: np.asarray(sd[k])  # noqa: E731
    pre = "model." if any(k.startswith("model.") for k in sd) else ""

    def attn(p):
        return {"q_w": g(f"{p}.q_proj.weight").T, "q_b": g(f"{p}.q_proj.bias"),
                "k_w": g(f"{p}.k_proj.weight").T,
                "v_w": g(f"{p}.v_proj.weight").T, "v_b": g(f"{p}.v_proj.bias"),
                "o_w": g(f"{p}.out_proj.weight").T, "o_b": g(f"{p}.out_proj.bias")}

    def ln(p):
        return {"scale": g(f"{p}.weight"), "bias": g(f"{p}.bias")}

    def block(p, cross):
        out = {"self_attn": attn(f"{p}.self_attn"), "ln1": ln(f"{p}.self_attn_layer_norm"),
               "fc1_w": g(f"{p}.fc1.weight").T, "fc1_b": g(f"{p}.fc1.bias"),
               "fc2_w": g(f"{p}.fc2.weight").T, "fc2_b": g(f"{p}.fc2.bias"),
               "ln_mlp": ln(f"{p}.final_layer_norm")}
        if cross:
            out["cross_attn"] = attn(f"{p}.encoder_attn")
            out["ln_cross"] = ln(f"{p}.encoder_attn_layer_norm")
        return out

    def stacked(blocks):
        if isinstance(blocks[0], dict):
            return {k: stacked([b[k] for b in blocks]) for k in blocks[0]}
        return np.stack(blocks)

    enc_blocks = [block(f"{pre}encoder.layers.{i}", False) for i in range(cfg.encoder_layers)]
    dec_blocks = [block(f"{pre}decoder.layers.{i}", True) for i in range(cfg.decoder_layers)]
    return {
        # HF conv weight [D, in, 3] → [3, in, D]
        "conv1_w": np.transpose(g(f"{pre}encoder.conv1.weight"), (2, 1, 0)),
        "conv1_b": g(f"{pre}encoder.conv1.bias"),
        "conv2_w": np.transpose(g(f"{pre}encoder.conv2.weight"), (2, 1, 0)),
        "conv2_b": g(f"{pre}encoder.conv2.bias"),
        "enc_pos": g(f"{pre}encoder.embed_positions.weight"),
        "enc_blocks": stacked(enc_blocks),
        "enc_ln": ln(f"{pre}encoder.layer_norm"),
        "tok_emb": g(f"{pre}decoder.embed_tokens.weight"),
        "dec_pos": g(f"{pre}decoder.embed_positions.weight"),
        "dec_blocks": stacked(dec_blocks),
        "dec_ln": ln(f"{pre}decoder.layer_norm"),
    }
