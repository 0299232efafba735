"""Phoneme symbol inventory and the production character vocabulary.

The model consumes IPA phoneme strings one character at a time. The shipped
tokenizer (reference: utils/g2p/bpe_69.json — a 70-entry char-level BPE with
zero merges) is equivalent to a plain dict lookup, which is what we implement
(the Rust `tokenizers` dependency is unnecessary; see reference
utils/g2p/__init__.py:11-25 and SURVEY.md §2.4).

The symbol inventory follows the cjke_cleaners2 convention
(reference: utils/g2p/symbols.py:73-76).
"""

from __future__ import annotations

from typing import Dict, List

_pad = "_"
_punctuation = ",.!?-~…"
_letters = "NQabdefghijklmnopstuvwxyzɑæʃʑçɯɪɔɛɹðəɫɥɸʊɾʒθβŋɦ⁼ʰ`^#*=ˈˌ→↓↑ "

# Full symbol inventory (id space for `text_to_sequence`-style encoding).
symbols: List[str] = [_pad] + list(_punctuation) + list(_letters)

SPACE_ID = symbols.index(" ")

# ---------------------------------------------------------------------------
# Production character vocabulary
# ---------------------------------------------------------------------------
# Equivalent to bpe_69.json: ids 0-4 are the specials, then the phoneme
# characters sorted by Unicode codepoint. Space never appears at encode time
# (it is replaced by "_" first); "β" and "ɦ" exist in the symbol inventory but
# were excluded from the trained vocabulary.

SPECIAL_TOKENS = ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]  # [PAD] handled below
UNK_ID = 0
PAD_ID = 3

_vocab_chars = sorted(set(symbols) - {" ", "β", "ɦ"})

# id 0..4: [UNK] [CLS] [SEP] [PAD] [MASK]; then chars in codepoint order.
char_to_id: Dict[str, int] = {
    "[UNK]": 0,
    "[CLS]": 1,
    "[SEP]": 2,
    "[PAD]": 3,
    "[MASK]": 4,
}
for _i, _c in enumerate(_vocab_chars):
    char_to_id[_c] = 5 + _i

id_to_char: Dict[int, str] = {i: c for c, i in char_to_id.items()}

VOCAB_SIZE = len(char_to_id)  # 70
