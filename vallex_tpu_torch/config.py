"""Typed configuration for the TPU-native VALL-E X framework.

Replaces the reference's scattered constants (reference: macros.py:1-39,
models/macros.py:1-11, and the hardcoded kwargs at utils/generation.py:67-78)
with a single frozen dataclass that the whole framework shares.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

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
class HybridARConfig:
    """A Granite-4.0-H style hybrid stack (Mamba-2 and grouped-query
    attention layers, each followed by a SwiGLU MLP, RMSNorm) as the AR
    decoder behind VALL-E X's token tables and codebook-0 head
    (models/granite_hybrid.py). Keys as in the Hugging Face
    `granitemoehybrid` config.json; `from_hf` reads one."""

    hidden_size: int = 2048
    layer_types: Tuple[str, ...] = (("mamba",) * 5 + ("attention",) + ("mamba",) * 4) * 4
    intermediate_size: int = 8192  # the shared SwiGLU MLP's width
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    mamba_n_heads: int = 64
    mamba_d_head: int = 64
    mamba_d_state: int = 128
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_n_groups: int = 1
    mamba_chunk_size: int = 256
    rms_norm_eps: float = 1e-5
    embedding_multiplier: float = 12.0
    residual_multiplier: float = 0.22
    attention_multiplier: float = 0.015625
    logits_scaling: float = 8.0

    @classmethod
    def from_hf(cls, conf: Dict) -> "HybridARConfig":
        """From a `granitemoehybrid` config.json (the shared MLP's width is
        `shared_intermediate_size`); unknown keys are ignored."""
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in conf.items() if k in names}
        if "shared_intermediate_size" in conf:
            kw["intermediate_size"] = conf["shared_intermediate_size"]
        kw["layer_types"] = tuple(kw.get("layer_types", cls.layer_types))
        return cls(**kw)

    def __post_init__(self):
        if set(self.layer_types) - {"mamba", "attention"}:
            raise ValueError(f"layer_types must be 'mamba' or 'attention', got {self.layer_types}")
        if self.mamba_n_groups != 1:
            raise ValueError("the hybrid AR takes one Mamba-2 group (mamba_n_groups = 1)")
        if self.mamba_n_heads * self.mamba_d_head != self.mamba_expand * self.hidden_size:
            raise ValueError("mamba_n_heads · mamba_d_head must be mamba_expand · hidden_size")
        if self.num_attention_heads % self.num_key_value_heads:
            raise ValueError("num_attention_heads must be a multiple of num_key_value_heads")

    @property
    def num_layers(self) -> int:
        return len(self.layer_types)

    @property
    def mamba_layers(self) -> Tuple[int, ...]:
        return tuple(i for i, t in enumerate(self.layer_types) if t == "mamba")

    @property
    def attention_layers(self) -> Tuple[int, ...]:
        return tuple(i for i, t in enumerate(self.layer_types) if t == "attention")

    @property
    def mixer_slots(self) -> Tuple[Tuple[str, int], ...]:
        """Each layer's mixer: (its kind, its index among the layers of that kind)."""
        return tuple((t, (self.mamba_layers if t == "mamba" else self.attention_layers).index(i))
                     for i, t in enumerate(self.layer_types))

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def mamba_inner(self) -> int:
        return self.mamba_n_heads * self.mamba_d_head

    @property
    def conv_dim(self) -> int:
        return self.mamba_inner + 2 * self.mamba_n_groups * self.mamba_d_state

    @property
    def in_proj_dim(self) -> int:
        """z, x B C, dt: the Mamba-2 input projection's outputs."""
        return self.mamba_inner + self.conv_dim + self.mamba_n_heads


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """VALL-E model hyperparameters.

    Defaults mirror the shipped checkpoint's configuration
    (reference: utils/generation.py:67-78). `ar_stack` None is VALL-E X's
    AR (the widths above); a HybridARConfig replaces the AR decoder and its
    token tables by that stack, and the NAR keeps the widths above.
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
    ar_stack: Optional[HybridARConfig] = None

    @property
    def ar_width(self) -> int:
        """The AR stack's width (its token tables' and head's)."""
        return self.d_model if self.ar_stack is None else self.ar_stack.hidden_size

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

    # Padded text lengths (prompt text + synthesis text phonemes): a request
    # takes the smallest bucket that holds it, which sizes the AR caches.
    text_buckets: Tuple[int, ...] = (128, 256)
    # Total audio-frame buckets (prompt frames + generated frames + BOS).
    audio_buckets: Tuple[int, ...] = (512, 1024, 2048)
    best_of: int = 1
    length_penalty: float = 1.0
    top_k: int = -100
    top_p: float = 1.0
    temperature: float = 1.0
    # Compute dtype for the transformer stacks: bf16 runs the tensor-core
    # kernels; float32 their CUDA-core versions, at parity with the reference.
    compute_dtype: str = "bfloat16"
    # Hard cap mirroring the reference's `y_len > 16 * x_len` stop
    # (models/vallex.py:575-577).
    max_len_ratio: int = 16
    # One request's AR decode: "megakernel" (the hand-written CUDA kernels:
    # K-step blocks, speculation or single steps; on the CPU their plain
    # versions), "pallas" (the per-token loop, the decode-attention kernel a
    # layer), "xla" (the per-token loop in plain PyTorch) or "auto"
    # (megakernel on CUDA, xla on the CPU). Batches always run K-step blocks.
    decode_mode: str = "auto"
    # Serving quantization of the kernel path: "none" (compute-dtype
    # weights), "int8" (W8A16 products, per-output-channel scales: about half
    # the weight bytes a step), "w8a8" (int8 activations too, per-row codes
    # and scales into s8 tensor-core products; the head stays W8A16) or
    # "int8kv" (int8 weights and an int8 K/V cache with static per-(layer,
    # head) scales: half the cache bytes; K-step blocks only, as "int8" with
    # decode_steps=1). Opt-in: check fidelity with trained weights first.
    quantize: str = "none"
    # AR frames a K-step block decodes (ops/decode_block.py): K steps of
    # launches, the EOS / logprob bookkeeping on the device, one host read a
    # block, in every sampling mode (filtered: the filtered epilogue);
    # speculation drafts K - 1 frames; 1 runs the single-step ops
    # (ops/decode_step.py). The batched decode runs K = max(2, decode_steps).
    decode_steps: int = 8
    # Speculative decoding ("auto"/"on"/"off"): draft decode_steps-1 frames
    # with int8 weights, confirm them with ONE pass of the serving weights
    # over all positions (ops/decode_verify.py). Greedy (top_k==1): exactly
    # per-token greedy. Sampled (top_k<=0, top_p>=1): the Leviathan scheme
    # (ops/sampling.py::speculative_accept), distributed exactly as per-token
    # sampling. The weights stream once per ~K accepted frames, not per
    # frame. Applies to one request's kernel path when quantize=="none",
    # best_of==1 and decode_steps > 1; otherwise ignored.
    speculative: str = "auto"


DEFAULT_MODEL_CONFIG = ModelConfig()
DEFAULT_ENGINE_CONFIG = EngineConfig()
