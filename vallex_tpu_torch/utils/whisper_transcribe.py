"""Whisper transcription for transcript-less `make_prompt` (port of
vallex_tpu/utils/whisper_transcribe.py).

The reference runs openai-whisper medium (utils/prompt_making.py:87-109):
detect_language on the 30 s mel, then decode. Here the model is the port's
(asr/whisper.py) on the given device; HuggingFace code is used only to read
the checkpoint (`safetensors`, else `torch.load` of pytorch_model.bin) and
to turn ids into text (`transformers.WhisperTokenizer`), both imported
only when a model directory exists. Without local weights
(WHISPER_MODEL_DIR, or ./checkpoints/whisper-medium) a clear error asks
the caller to pass a transcript instead.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

_WHISPER_LANGS = {"en": "en", "zh": "zh", "ja": "ja"}


def _find_model_dir() -> str:
    for cand in (os.environ.get("WHISPER_MODEL_DIR"), "./checkpoints/whisper-medium"):
        if cand and os.path.isdir(cand):
            return cand
    raise RuntimeError(
        "Whisper weights not found (no network egress in this environment). "
        "Either pass `transcript=` to make_prompt, or place a HF Whisper "
        "model at ./checkpoints/whisper-medium (or set WHISPER_MODEL_DIR)."
    )


class Transcriber:
    """A Whisper model and its tokenizer from a HuggingFace model directory,
    on `device`."""

    def __init__(self, model_dir: str, device):
        import numpy as np
        import torch

        from ..asr import whisper as W
        from ..convert import load_tree
        from .checkpoint import state_dict_to_numpy

        with open(os.path.join(model_dir, "config.json")) as f:
            hc = json.load(f)
        cfg = W.WhisperConfig(
            d_model=hc["d_model"], num_heads=hc["encoder_attention_heads"],
            encoder_layers=hc["encoder_layers"], decoder_layers=hc["decoder_layers"],
            vocab=hc["vocab_size"], max_source_positions=hc["max_source_positions"],
            max_target_positions=hc["max_target_positions"],
        )
        st_path = os.path.join(model_dir, "model.safetensors")
        if os.path.exists(st_path):
            from safetensors.numpy import load_file

            sd = load_file(st_path)
        else:
            sd = state_dict_to_numpy(torch.load(os.path.join(model_dir, "pytorch_model.bin"),
                                                map_location="cpu", weights_only=True))
        tree = W.convert_hf_state_dict({k: np.asarray(v) for k, v in sd.items()}, cfg)
        self.model = load_tree(W.Whisper(cfg), tree, dtype=torch.float32, device=device)
        from transformers import WhisperTokenizer

        self.tokenizer = WhisperTokenizer.from_pretrained(model_dir)

    def __call__(self, audio_path: str, *, seed: int = 0) -> Tuple[str, str]:
        """→ (transcript text, detected language code in {en, zh, ja}),
        decoded with the reference's settings: temperature 1.0, best_of 5
        sample lanes ranked by average logprob, sample_len 150
        (utils/prompt_making.py:46)."""
        from ..asr import whisper as W
        from .audio import load_wav

        wav, _ = load_wav(audio_path, target_sr=W.SAMPLE_RATE)
        ids, lang = W.transcribe_ids(self.model, wav, temperature=1.0, best_of=5,
                                     sample_len=150, seed=seed)
        text = self.tokenizer.decode(ids.tolist(), skip_special_tokens=True).strip()
        return text, _WHISPER_LANGS.get(lang, "en")


_cached = {}  # (model dir, device) → Transcriber


def transcribe(audio_path: str, *, device="cpu", seed: int = 0) -> Tuple[str, str]:
    """→ (transcript text, language code in {en, zh, ja}) of a WAV file, by
    the Whisper model in WHISPER_MODEL_DIR or ./checkpoints/whisper-medium
    on `device` (loaded once per directory and device)."""
    key = (os.path.abspath(_find_model_dir()), str(device))
    if key not in _cached:
        _cached[key] = Transcriber(key[0], device)
    return _cached[key](audio_path, seed=seed)
