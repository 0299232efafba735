"""Mandarin Chinese text → IPA phonemes.

Pipeline mirrors the reference (utils/g2p/mandarin.py:304-314):
numbers → Chinese words, jieba word segmentation → per-word pinyin →
bopomofo, latin letters → bopomofo spellings, bopomofo → IPA with tone
contours rendered as →/↑/↓↑/↓, then the glide/syllabic-fricative fixups.

Differences from the reference's implementation (same output conventions):
pinyin comes from the embedded table (pinyin_data.py) instead of `pypinyin`;
number reading is implemented here instead of `cn2an`; the bopomofo→IPA step
is a longest-match scan over one mapping table instead of a 60-step regex
cascade.
"""

from __future__ import annotations

import re
from typing import List

from .pinyin_data import word_pinyin


def _jieba():
    """jieba, imported on first Chinese input: English and Japanese text
    must not need it (it is absent from some GPU installs)."""
    import jieba

    jieba.setLogLevel(60)  # silence init logging
    return jieba

# ---------------------------------------------------------------------------
# Numbers → Chinese (replacement for cn2an.an2cn)
# ---------------------------------------------------------------------------

_CN_DIGITS = "零一二三四五六七八九"
_CN_UNITS = ["", "十", "百", "千"]
_CN_GROUP_UNITS = ["", "万", "亿", "万亿"]


def _four_digits_to_cn(n: int) -> str:
    """0 <= n <= 9999 → Chinese, with internal zeros collapsed."""
    if n == 0:
        return "零"
    out = []
    digits = [int(d) for d in f"{n:04d}"]
    for i, d in enumerate(digits):
        unit = _CN_UNITS[3 - i]
        if d == 0:
            out.append("零")
        else:
            out.append(_CN_DIGITS[d] + unit)
    s = "".join(out)
    s = re.sub("零+", "零", s).strip("零")
    return s or "零"


def int_to_cn(n: int) -> str:
    if n < 0:
        return "负" + int_to_cn(-n)
    if n == 0:
        return "零"
    groups = []
    while n > 0:
        groups.append(n % 10000)
        n //= 10000
    parts = []
    for i in range(len(groups) - 1, -1, -1):
        g = groups[i]
        if g == 0:
            continue
        part = _four_digits_to_cn(g) + _CN_GROUP_UNITS[i]
        # needs a 零 when a higher group exists and this group < 1000
        if parts and groups[i] < 1000:
            part = "零" + part
        parts.append(part)
    s = "".join(parts)
    # 一十X → 十X at the very start (10-19)
    s = re.sub("^一十", "十", s)
    return s


def an2cn(num_str: str) -> str:
    if "." in num_str:
        int_part, frac_part = num_str.split(".", 1)
        frac_cn = "".join(_CN_DIGITS[int(d)] for d in frac_part)
        return int_to_cn(int(int_part)) + "点" + frac_cn
    return int_to_cn(int(num_str))


def number_to_chinese(text: str) -> str:
    numbers = re.findall(r"\d+(?:\.?\d+)?", text)
    for number in numbers:
        text = text.replace(number, an2cn(number), 1)
    return text


# ---------------------------------------------------------------------------
# Pinyin → bopomofo
# ---------------------------------------------------------------------------

_INITIALS = [  # longest first
    ("zh", "ㄓ"), ("ch", "ㄔ"), ("sh", "ㄕ"),
    ("b", "ㄅ"), ("p", "ㄆ"), ("m", "ㄇ"), ("f", "ㄈ"),
    ("d", "ㄉ"), ("t", "ㄊ"), ("n", "ㄋ"), ("l", "ㄌ"),
    ("g", "ㄍ"), ("k", "ㄎ"), ("h", "ㄏ"),
    ("j", "ㄐ"), ("q", "ㄑ"), ("x", "ㄒ"),
    ("r", "ㄖ"), ("z", "ㄗ"), ("c", "ㄘ"), ("s", "ㄙ"),
]

_FINALS = {
    "a": "ㄚ", "o": "ㄛ", "e": "ㄜ", "ai": "ㄞ", "ei": "ㄟ", "ao": "ㄠ",
    "ou": "ㄡ", "an": "ㄢ", "en": "ㄣ", "ang": "ㄤ", "eng": "ㄥ",
    "er": "ㄦ", "i": "ㄧ", "ia": "ㄧㄚ", "ie": "ㄧㄝ", "iao": "ㄧㄠ",
    "iu": "ㄧㄡ", "iou": "ㄧㄡ", "ian": "ㄧㄢ", "in": "ㄧㄣ",
    "iang": "ㄧㄤ", "ing": "ㄧㄥ", "iong": "ㄩㄥ", "u": "ㄨ", "ua": "ㄨㄚ",
    "uo": "ㄨㄛ", "uai": "ㄨㄞ", "ui": "ㄨㄟ", "uei": "ㄨㄟ", "uan": "ㄨㄢ",
    "un": "ㄨㄣ", "uen": "ㄨㄣ", "uang": "ㄨㄤ", "ueng": "ㄨㄥ",
    "ong": "ㄨㄥ", "v": "ㄩ", "ve": "ㄩㄝ", "van": "ㄩㄢ", "vn": "ㄩㄣ",
}

# Whole zero-initial syllables
_ZERO_INITIAL = {
    "yi": "ㄧ", "ya": "ㄧㄚ", "ye": "ㄧㄝ", "yao": "ㄧㄠ", "you": "ㄧㄡ",
    "yan": "ㄧㄢ", "yin": "ㄧㄣ", "yang": "ㄧㄤ", "ying": "ㄧㄥ",
    "yong": "ㄩㄥ", "wu": "ㄨ", "wa": "ㄨㄚ", "wo": "ㄨㄛ", "wai": "ㄨㄞ",
    "wei": "ㄨㄟ", "wan": "ㄨㄢ", "wen": "ㄨㄣ", "wang": "ㄨㄤ",
    "weng": "ㄨㄥ", "yu": "ㄩ", "yue": "ㄩㄝ", "yuan": "ㄩㄢ", "yun": "ㄩㄣ",
    "a": "ㄚ", "o": "ㄛ", "e": "ㄜ", "ai": "ㄞ", "ei": "ㄟ", "ao": "ㄠ",
    "ou": "ㄡ", "an": "ㄢ", "en": "ㄣ", "ang": "ㄤ", "eng": "ㄥ",
    "er": "ㄦ",
}

# Syllabic-fricative syllables: bopomofo writes only the initial.
_SYLLABIC = {"zhi", "chi", "shi", "ri", "zi", "ci", "si"}

# Tone digit → mark appended after the syllable; tone 1 is written ˉ
# (the reference's trailing-ˉ rule, utils/g2p/mandarin.py:254).
_TONE_MARKS = {"1": "ˉ", "2": "ˊ", "3": "ˇ", "4": "ˋ", "5": "˙"}


def pinyin_to_bopomofo(syllable: str) -> str:
    """One numeric-tone pinyin syllable → bopomofo with tone mark."""
    tone = "1"
    if syllable and syllable[-1].isdigit():
        tone = syllable[-1]
        syllable = syllable[:-1]
    syllable = syllable.lower()
    if syllable in _SYLLABIC:
        body = dict(_INITIALS)[syllable[:-1]]
    elif syllable in _ZERO_INITIAL:
        body = _ZERO_INITIAL[syllable]
    else:
        body = None
        for ini, bpm in _INITIALS:
            if syllable.startswith(ini):
                final = syllable[len(ini):]
                # j/q/x + u → ü
                if ini in ("j", "q", "x") and final.startswith("u"):
                    final = "v" + final[1:]
                if final in _FINALS:
                    body = bpm + _FINALS[final]
                break
        if body is None:
            return syllable  # not convertible; pass through
    return body + _TONE_MARKS[tone]


# ---------------------------------------------------------------------------
# Latin → bopomofo (letter names; reference: utils/g2p/mandarin.py:10-37)
# ---------------------------------------------------------------------------

_LATIN_TO_BOPOMOFO = {
    "a": "ㄟˉ", "b": "ㄅㄧˋ", "c": "ㄙㄧˉ", "d": "ㄉㄧˋ", "e": "ㄧˋ",
    "f": "ㄝˊㄈㄨˋ", "g": "ㄐㄧˋ", "h": "ㄝˇㄑㄩˋ", "i": "ㄞˋ",
    "j": "ㄐㄟˋ", "k": "ㄎㄟˋ", "l": "ㄝˊㄛˋ", "m": "ㄝˊㄇㄨˋ",
    "n": "ㄣˉ", "o": "ㄡˉ", "p": "ㄆㄧˉ", "q": "ㄎㄧㄡˉ", "r": "ㄚˋ",
    "s": "ㄝˊㄙˋ", "t": "ㄊㄧˋ", "u": "ㄧㄡˉ", "v": "ㄨㄧˉ",
    "w": "ㄉㄚˋㄅㄨˋㄌㄧㄡˋ", "x": "ㄝˉㄎㄨˋㄙˋ", "y": "ㄨㄞˋ",
    "z": "ㄗㄟˋ",
}


def latin_to_bopomofo(text: str) -> str:
    return "".join(_LATIN_TO_BOPOMOFO.get(c.lower(), c) for c in text)


# ---------------------------------------------------------------------------
# Bopomofo → IPA (tone contours as →/↑/↓↑/↓; reference table at
# utils/g2p/mandarin.py:112-176), applied as a longest-match scan.
# ---------------------------------------------------------------------------

_BOPOMOFO_TO_IPA = [
    # two-symbol sequences first (longest match)
    ("ㄅㄛ", "p⁼wo"), ("ㄆㄛ", "pʰwo"), ("ㄇㄛ", "mwo"), ("ㄈㄛ", "fwo"),
    ("ㄧㄢ", "jɛn"), ("ㄩㄢ", "ɥæn"), ("ㄧㄣ", "in"), ("ㄩㄣ", "ɥn"),
    ("ㄧㄥ", "iŋ"), ("ㄨㄥ", "ʊŋ"), ("ㄩㄥ", "jʊŋ"),
    # single symbols
    ("ㄅ", "p⁼"), ("ㄆ", "pʰ"), ("ㄇ", "m"), ("ㄈ", "f"),
    ("ㄉ", "t⁼"), ("ㄊ", "tʰ"), ("ㄋ", "n"), ("ㄌ", "l"),
    ("ㄍ", "k⁼"), ("ㄎ", "kʰ"), ("ㄏ", "x"),
    ("ㄐ", "tʃ⁼"), ("ㄑ", "tʃʰ"), ("ㄒ", "ʃ"),
    ("ㄓ", "ts`⁼"), ("ㄔ", "ts`ʰ"), ("ㄕ", "s`"), ("ㄖ", "ɹ`"),
    ("ㄗ", "ts⁼"), ("ㄘ", "tsʰ"), ("ㄙ", "s"),
    ("ㄚ", "a"), ("ㄛ", "o"), ("ㄜ", "ə"), ("ㄝ", "ɛ"),
    ("ㄞ", "aɪ"), ("ㄟ", "eɪ"), ("ㄠ", "ɑʊ"), ("ㄡ", "oʊ"),
    ("ㄢ", "an"), ("ㄣ", "ən"), ("ㄤ", "ɑŋ"), ("ㄥ", "əŋ"),
    ("ㄦ", "əɻ"), ("ㄧ", "i"), ("ㄨ", "u"), ("ㄩ", "ɥ"),
    ("ˉ", "→"), ("ˊ", "↑"), ("ˇ", "↓↑"), ("ˋ", "↓"), ("˙", ""),
    ("，", ","), ("。", "."), ("！", "!"), ("？", "?"), ("—", "-"),
]


def bopomofo_to_ipa(text: str) -> str:
    out = []
    i = 0
    while i < len(text):
        for pat, repl in _BOPOMOFO_TO_IPA:
            if text.startswith(pat, i):
                out.append(repl)
                i += len(pat)
                break
        else:
            out.append(text[i])
            i += 1
    return "".join(out)


_HANZI_RE = re.compile(r"[一-鿿〇]")


def chinese_to_bopomofo(text: str) -> str:
    text = text.replace("、", "，").replace("；", "，").replace("：", "，")
    words: List[str] = _jieba().lcut(text, cut_all=False)
    out = ""
    for word in words:
        if not _HANZI_RE.search(word):
            out += word
            continue
        pys = word_pinyin(word)
        if pys is None:
            # per-char best effort; unknown hanzi dropped
            pys = []
            for ch in word:
                ch_py = word_pinyin(ch)
                if ch_py:
                    pys.extend(ch_py)
            if not pys:
                continue
        bopo = "".join(pinyin_to_bopomofo(py) for py in pys)
        if out != "":
            out += " "
        out += bopo
    return out


def post_bopomofo_to_ipa(text: str) -> str:
    """The deterministic tail of ``chinese_to_ipa``: bopomofo (+ latin
    letter-names already folded) → IPA with glide and syllabic-fricative
    fixups (reference: mandarin.py:302-312). Split out so tests can pin it
    against the reference's regex tables syllable-by-syllable."""
    text = bopomofo_to_ipa(text)
    text = re.sub("i([aoe])", r"j\1", text)
    text = re.sub("u([aoəe])", r"w\1", text)
    text = re.sub(
        r"([sɹ]`[⁼ʰ]?)([→↓↑ ]+|$)", r"\1ɹ`\2", text
    ).replace("ɻ", "ɹ`")
    text = re.sub(r"([s][⁼ʰ]?)([→↓↑ ]+|$)", r"\1ɹ\2", text)
    return text


def chinese_to_ipa(text: str) -> str:
    text = number_to_chinese(text)
    text = chinese_to_bopomofo(text)
    text = latin_to_bopomofo(text)
    return post_bopomofo_to_ipa(text)
