"""Model zoo: VALL-E X (the flagship), VALL-F (its decoder variant) and the
debug Transformer TTS, with their layers and the scaling toolkit.

`get_model` mirrors the JAX package's factory (vallex_tpu/models/__init__.py):
a name → (init_fn(cfg, generator) → parameter tree, module with the forward
and generate functions).
"""

from __future__ import annotations

from typing import Optional

from ..config import ModelConfig


def get_model(model_name: str = "VALL-E", cfg: Optional[ModelConfig] = None):
    """→ (init_fn, module) for `model_name`: VALL-E, VALL-F or Transformer."""
    from . import transformer_tts, vallex, vallf

    name = model_name.lower().replace("-", "")
    if name == "valle":
        return vallex.init_vallex, vallex
    if name == "vallf":
        return vallf.init_vallf, vallf
    if name == "transformer":
        return transformer_tts.init_transformer_tts, transformer_tts
    raise ValueError(f"unknown model {model_name!r}")


def add_model_arguments(parser) -> None:
    """argparse flags of the JAX package's `add_model_arguments`, with its
    defaults (reference: models/__init__.py:18-95)."""
    parser.add_argument(
        "--model-name", type=str, default="VALL-E",
        help="VALL-E, VALL-F, Transformer.",
    )
    parser.add_argument("--decoder-dim", type=int, default=1024)
    parser.add_argument("--nhead", type=int, default=16)
    parser.add_argument("--num-decoder-layers", type=int, default=12)
    parser.add_argument("--norm-first", action="store_true", default=True)
    parser.add_argument("--add-prenet", action="store_true", default=False)
    parser.add_argument(
        "--prefix-mode", type=int, default=1, choices=(0, 1, 2, 4),
        help="NAR acoustic-prompt construction (reference "
             "models/vallex.py:307-365): 0 = none, 1 = prefix-at-beginning "
             "(shipped checkpoint), 2 = random window prepended, "
             "4 = dataset-provided PromptedFeatures prompt",
    )
    parser.add_argument("--share-embedding", action="store_true", default=True)
    parser.add_argument("--prepend-bos", action="store_true", default=True)
    parser.add_argument("--num-quantizers", type=int, default=8)
    parser.add_argument("--scale-factor", type=float, default=1.0)


def model_config_from_args(args) -> ModelConfig:
    return ModelConfig(
        d_model=args.decoder_dim,
        num_heads=args.nhead,
        num_layers=args.num_decoder_layers,
        ffn_dim=args.decoder_dim * 4,
        prefix_mode=args.prefix_mode,
        prepend_bos=args.prepend_bos,
        share_embedding=args.share_embedding,
        norm_first=args.norm_first,
        num_quantizers=args.num_quantizers,
    )
