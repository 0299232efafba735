"""Language-routing cleaner: [EN]/[ZH]/[JA]-delimited text → IPA + lang tags.

Mirrors the reference's `cje_cleaners` contract (utils/g2p/cleaners.py:22-61):
each delimited span is converted by its language's G2P, a trailing space is
appended per span, the final result is stripped and terminated with '.' if it
doesn't already end in punctuation, and a parallel per-character language tag
list is produced (``len(phonemes) == len(langs)``).
"""

from __future__ import annotations

import re
from typing import List, Tuple

from .english import english_to_ipa2
from .japanese import japanese_to_ipa2
from .mandarin import chinese_to_ipa

_PATTERNS = [
    (re.compile(r"\[EN\](.*?)\[EN\]"), "en", english_to_ipa2),
    (re.compile(r"\[ZH\](.*?)\[ZH\]"), "zh", chinese_to_ipa),
    (re.compile(r"\[JA\](.*?)\[JA\]"), "ja", japanese_to_ipa2),
]

_FINAL_PUNCT_RE = re.compile(r"([^\.,!\?\-…~])$")


def clean_one(segment: str, lang: str, fn) -> str:
    m = re.match(r"\[(?:EN|ZH|JA)\](.*?)\[(?:EN|ZH|JA)\]", segment, re.S)
    inner = m.group(1) if m else segment
    phon = fn(inner) + " "
    phon = re.sub(r"\s+$", "", phon)
    phon = _FINAL_PUNCT_RE.sub(r"\1.", phon)
    return phon


def cje_cleaners(text: str) -> Tuple[str, List[str]]:
    matches = []
    for pattern, lang, fn in _PATTERNS:
        for m in pattern.finditer(text):
            matches.append((m.start(), m.end(), lang, fn))
    matches.sort(key=lambda t: t[0])

    outputs = ""
    output_langs: List[str] = []
    for start, end, lang, fn in matches:
        phon = clean_one(text[start:end], lang, fn)
        outputs += phon
        output_langs += [lang] * len(phon)
    assert len(outputs) == len(output_langs)
    return outputs, output_langs
