"""Typed configuration for the TPU-native VALL-E X framework.

Replaces the reference's scattered constants (reference: macros.py:1-39,
models/macros.py:1-11, and the hardcoded kwargs at utils/generation.py:67-78)
with a single frozen dataclass that the whole framework shares.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

# ---------------------------------------------------------------------------
# Global constants (reference: macros.py:1-6, models/macros.py:1-11)
# ---------------------------------------------------------------------------

NUM_LAYERS = 12
NUM_HEAD = 16
N_DIM = 1024
PREFIX_MODE = 1
NUM_QUANTIZERS = 8
SAMPLE_RATE = 24000

NUM_TEXT_TOKENS = 2048
NUM_AUDIO_TOKENS = 1024  # EnCodec RVQ bins per codebook
NUM_MEL_BINS = 100  # mel bins for the debug Transformer TTS / BigVGAN fbank

# EnCodec frame rate: 24000 Hz / 320-sample hop = 75 frames/s
ENCODEC_FRAME_RATE = 75

# ---------------------------------------------------------------------------
# Language maps (reference: macros.py:8-39)
# ---------------------------------------------------------------------------

lang2token: Dict[str, str] = {
    "zh": "[ZH]",
    "ja": "[JA]",
    "en": "[EN]",
    "mix": "",
}

lang2code: Dict[str, int] = {
    "zh": 0,
    "ja": 1,
    "en": 2,
}

token2lang: Dict[str, str] = {
    "[ZH]": "zh",
    "[JA]": "ja",
    "[EN]": "en",
    "": "mix",
}

code2lang: Dict[int, str] = {
    0: "zh",
    1: "ja",
    2: "en",
}

langdropdown2token: Dict[str, str] = {
    "English": "[EN]",
    "中文": "[ZH]",
    "日本語": "[JA]",
    "Mix": "",
}

# Language IDs used by the model's language embeddings
# (reference: models/vallex.py:439-443 — note: different order from lang2code!)
model_language_id: Dict[str, int] = {
    "en": 0,
    "zh": 1,
    "ja": 2,
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """VALL-E model hyperparameters.

    Defaults mirror the shipped checkpoint's configuration
    (reference: utils/generation.py:67-78).
    """

    d_model: int = N_DIM
    num_heads: int = NUM_HEAD
    num_layers: int = NUM_LAYERS
    ffn_dim: int = N_DIM * 4
    num_text_tokens: int = NUM_TEXT_TOKENS
    num_audio_tokens: int = NUM_AUDIO_TOKENS
    num_quantizers: int = NUM_QUANTIZERS
    num_languages: int = 3
    prefix_mode: int = PREFIX_MODE
    # The decode engines and the AR loss both assume a BOS token (as the
    # shipped checkpoint was trained); prepend_bos=False is rejected in
    # __post_init__ rather than silently mis-training: with the smaller
    # 1025-row audio embedding, index bos_id=1025 clips to the EOS row
    # under jit and every sequence would train as if it started with EOS.
    prepend_bos: bool = True
    share_embedding: bool = True
    norm_first: bool = True
    layer_norm_eps: float = 1e-5
    # Maximum positions the sinusoidal PE table covers. The reference grows
    # its table on demand (modules/embedding.py:68-91); on TPU we keep it
    # static and sized for the 22 s ceiling with headroom.
    max_position: int = 4096

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def ar_audio_vocab(self) -> int:
        # 1024 codes + EOS(1024) + BOS(1025) when prepend_bos
        return self.num_audio_tokens + 1 + int(self.prepend_bos)

    def __post_init__(self):
        if not self.prepend_bos:
            raise ValueError(
                "prepend_bos=False is not supported: the decode engines"
                " and ar_loss unconditionally prepend BOS (id 1025), and"
                " without the BOS embedding row that index silently clips"
                " to EOS under jit. The shipped checkpoint uses"
                " prepend_bos=True."
            )

    @property
    def eos_id(self) -> int:
        return self.num_audio_tokens  # 1024

    @property
    def bos_id(self) -> int:
        return self.num_audio_tokens + 1  # 1025


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Inference-engine settings: bucketing, beams, sampling, dtype."""

    # Static sequence-length buckets to avoid XLA recompiles.
    # Text (phoneme) buckets cover prompt-text + synthesis-text lengths.
    text_buckets: Tuple[int, ...] = (128, 256)
    # Total audio-frame buckets (prompt frames + generated frames + BOS).
    audio_buckets: Tuple[int, ...] = (512, 1024, 2048)
    best_of: int = 1
    length_penalty: float = 1.0
    top_k: int = -100
    top_p: float = 1.0
    temperature: float = 1.0
    # Compute dtype for the transformer stacks. fp32 keeps parity with the
    # torch reference; bf16 roughly doubles MXU/HBM throughput.
    compute_dtype: str = "bfloat16"
    # Hard cap mirroring the reference's `y_len > 16 * x_len` stop
    # (models/vallex.py:575-577).
    max_len_ratio: int = 16
    # AR decode implementation: "megakernel" (one fused pallas_call for all
    # layers — fastest), "pallas" (per-layer fused attention kernel), "xla"
    # (pure XLA scan — the only mode that runs on CPU), or "auto"
    # (megakernel on TPU, xla elsewhere). Pallas modes need text buckets to
    # be multiples of 128.
    decode_mode: str = "auto"
    # Quantization for the megakernel decode path: "none" (bf16), "int8"
    # (W8A16 — per-output-channel scales, ~half the HBM weight traffic per
    # step) or "w8a8" (int8 activations too: the matmuls run natively on
    # the MXU in int8, skipping the W8A16 path's int8→bf16 weight cast —
    # fastest; dynamic per-row activation scales) or "int8kv" (int8
    # weights + int8 KV cache with static per-(layer, head) scales —
    # halves the cache DMA on top of int8; the big win for beams/batched
    # serving, block-kernel path only, elsewhere behaves like "int8").
    # Opt-in: A/B audio fidelity with trained weights before enabling in
    # production (tools/quant_fidelity.py).
    quantize: str = "none"
    # AR frames generated per fused-megakernel invocation. K > 1 runs K
    # decode steps inside ONE pallas_call (ops/decode_block.py), amortizing
    # the while_loop glue — EOS/logprob bookkeeping, y-buffer write, cache
    # column writes, dispatch — by K×. Only the fused plain-sampling path
    # uses it; other configs fall back to single-step.
    decode_steps: int = 8
    # Speculative decoding for the bf16 strict modes ("auto"/"on"/"off"):
    # draft decode_steps-1 frames with int8 weights, confirm with ONE bf16
    # pass over all positions (ops/decode_verify.py). Greedy (top_k==1):
    # output is exactly per-token bf16 greedy. Sampled (top_k<=0,
    # top_p>=1): the Leviathan rejection scheme
    # (ops/sampling.py::speculative_accept) — output is distributed
    # exactly as per-token bf16 sampling. Either way the 302 MB weight
    # stream is paid once per ~K accepted frames instead of per frame.
    # Applies when quantize=="none" and best_of==1; otherwise ignored.
    speculative: str = "auto"


DEFAULT_MODEL_CONFIG = ModelConfig()
DEFAULT_ENGINE_CONFIG = EngineConfig()
