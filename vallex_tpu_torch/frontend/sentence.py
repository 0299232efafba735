"""Long-text sentence splitting for en/zh/ja.

Replacement for the reference's splitter (utils/sentence_cutter.py:7-42)
which used nltk punkt (en), jieba (zh) and sudachipy (ja). Here: nltk punkt
when its data is available with a regex fallback (en); jieba segmentation
with punctuation scan (zh); punctuation scan (ja — sudachipy is unavailable,
and its role was only locating 句点 tokens).
"""

from __future__ import annotations

import re
from typing import List

from .langid import classify

_EN_SENT_RE = re.compile(r"[^.!?]+[.!?]*\s*")

_nltk_ready = None


def _try_nltk_split(text: str):
    global _nltk_ready
    if _nltk_ready is False:
        return None
    try:
        import nltk

        out = nltk.tokenize.sent_tokenize(text)
        _nltk_ready = True
        return out
    except (ImportError, LookupError):  # no nltk, or no punkt data
        _nltk_ready = False
        return None


def split_text_into_sentences(text: str) -> List[str]:
    lang = classify(text)
    if lang == "en":
        sents = _try_nltk_split(text)
        if sents is not None:
            return sents
        return [s.strip() for s in _EN_SENT_RE.findall(text) if s.strip()]
    if lang == "zh":
        import jieba

        sentences = []
        segs = list(jieba.cut(text, cut_all=False))
        start = 0
        for i, seg in enumerate(segs):
            if seg in ["。", "！", "？", "……"]:
                sentences.append("".join(segs[start : i + 1]))
                start = i + 1
        if start < len(segs):
            sentences.append("".join(segs[start:]))
        return sentences
    # ja: split on 句点-class punctuation, keeping the delimiter
    sentences = []
    current = ""
    for ch in text:
        current += ch
        if ch in "。！？!?":
            sentences.append(current)
            current = ""
    if current.strip():
        sentences.append(current)
    return [s for s in (x.strip() for x in sentences) if s]
