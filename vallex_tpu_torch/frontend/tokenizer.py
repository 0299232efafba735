"""Phoneme tokenizer and batch collation.

Replacement for the reference's `PhonemeBpeTokenizer`
(utils/g2p/__init__.py:11-25, backed by the Rust HF `tokenizers` BPE) and
`TextTokenCollater` (data/collation.py:10-120). Because the production vocab
has zero merges, encoding is an exact char→id lookup, done by the native
host runtime (native.py) as in the JAX package; `lookup_ids` is its plain
version. The invariant ``len(tokens) == len(langs)`` (one language tag per
phoneme char) is preserved.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .. import native
from .cleaners import cje_cleaners
from .symbols import UNK_ID, char_to_id, id_to_char


class PhonemeTokenizer:
    """Text (with [EN]/[ZH]/[JA] spans) → phoneme-char token ids + lang tags."""

    def tokenize(self, text: str) -> Tuple[List[int], List[str]]:
        phonemes, langs = cje_cleaners(text)
        phonemes = phonemes.replace(" ", "_")
        tokens = self.encode(phonemes)
        assert len(tokens) == len(langs)
        if not tokens:
            raise ValueError("Empty text is given")
        return tokens, langs

    def encode(self, phonemes: str) -> List[int]:
        """Char→id encode through the native host runtime."""
        return native.tokenize(phonemes).tolist()

    def decode(self, ids: Sequence[int]) -> str:
        return "".join(id_to_char.get(int(i), "[UNK]") for i in ids)


def lookup_ids(phonemes: str) -> List[int]:
    """The plain version of `PhonemeTokenizer.encode`: a dict lookup."""
    return [char_to_id.get(ch, UNK_ID) for ch in phonemes]


class TextTokenCollater:
    """Pads already-encoded id sequences into a (B, L) int array.

    The production instance in the reference is a passthrough built over a
    one-symbol table with no bos/eos (data/collation.py:116-120); this is the
    equivalent numpy implementation with pad id 0.
    """

    def __init__(self, pad_id: int = 0):
        self.pad_id = pad_id

    def __call__(
        self, token_seqs: Sequence[Sequence[int]]
    ) -> Tuple[np.ndarray, np.ndarray]:
        lens = np.array([len(s) for s in token_seqs], dtype=np.int32)
        max_len = int(lens.max()) if len(lens) else 0
        batch = np.full((len(token_seqs), max_len), self.pad_id, dtype=np.int64)
        for i, seq in enumerate(token_seqs):
            batch[i, : len(seq)] = np.asarray(seq, dtype=np.int64)
        return batch, lens


def get_text_token_collater() -> TextTokenCollater:
    return TextTokenCollater()
