"""Host-side text frontend: G2P, tokenization, collation, sentence split."""

from .cleaners import cje_cleaners
from .langid import classify
from .sentence import split_text_into_sentences
from .symbols import VOCAB_SIZE, char_to_id, id_to_char, symbols
from .tokenizer import (
    PhonemeTokenizer,
    TextTokenCollater,
    get_text_token_collater,
)

__all__ = [
    "cje_cleaners",
    "classify",
    "split_text_into_sentences",
    "VOCAB_SIZE",
    "char_to_id",
    "id_to_char",
    "symbols",
    "PhonemeTokenizer",
    "TextTokenCollater",
    "get_text_token_collater",
]
