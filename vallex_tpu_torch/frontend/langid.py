"""Lightweight language identification for en/zh/ja.

Replacement for the `langid` package (reference: utils/generation.py:6-7,
restricted there to the same three languages). Uses Unicode script
statistics, which is reliable for this 3-way task: kana ⇒ Japanese, hanzi
without kana ⇒ Chinese, otherwise English.
"""

from __future__ import annotations

import re

_KANA_RE = re.compile(r"[぀-ゟ゠-ヿ]")
_HANZI_RE = re.compile(r"[一-鿿〇]")
_LATIN_RE = re.compile(r"[A-Za-z]")


def classify(text: str) -> str:
    """Return 'en' | 'zh' | 'ja' for the given text."""
    kana = len(_KANA_RE.findall(text))
    hanzi = len(_HANZI_RE.findall(text))
    latin = len(_LATIN_RE.findall(text))
    if kana > 0:
        return "ja"
    if hanzi > 0:
        return "zh"
    if latin > 0:
        return "en"
    return "en"
