"""Japanese text → IPA phonemes with pitch-accent marks.

The reference (utils/g2p/japanese.py:74-145) derives phonemes AND Tokyo
pitch accent from pyopenjtalk full-context labels: per accent phrase it
emits ↑ after the first mora when the pitch rises, ↓ after the accent
nucleus when it falls, and a space at accent-phrase boundaries
(japanese.py:97-110). Both marks are part of the trained 69-symbol vocab.

pyopenjtalk (C++) is unavailable in this image, so this module reimplements
the same output contract from embedded data (frontend/japanese_data.py):

  1. segment the text into accent phrases: lexicon longest-match for
     content words (kanji/katakana/mixed surfaces), per-character on'yomi
     fallback for out-of-lexicon kanji (nothing is dropped), number→kana
     reading for digit runs, and attached hiragana tails (okurigana,
     auxiliaries, particles);
  2. resolve each phrase's accent type: lexicon accent, auxiliary-suffix
     rules (ます→fall on ま, です after heiban→fall on で, …), loanword
     default for katakana;
  3. emit romaji moras with the reference's exact mark placement rules:
     ↓ after the nucleus mora when a mora follows in the same phrase
     (a1==0 ∧ a2_next==a2+1), else ↑ after mora 1 of a multi-mora phrase
     whose accent isn't 1 (a2==1 ∧ a2_next==2), spaces between phrases
     (a3==1 ∧ a2_next==1); devoice i/u between voiceless consonants and
     a final unaccented す (the labels' I/U phonemes → i*/ɯ* in IPA);
  4. apply the reference's sokuon/hatsuon rewrites and romaji→ipa2 table
     verbatim-equivalent (japanese.py:36-65).

Accent values approximate the NHK accent dictionary; unknown words default
to heiban (the most common class). This trades some accent accuracy for
zero native dependencies — the structure (marks, boundaries, devoicing)
matches the reference exactly.
"""

from __future__ import annotations

import logging
import re
import unicodedata
from typing import List, Optional, Tuple

from .japanese_data import (
    ADJ_1CHAR_STEMS,
    CONJ_SUFFIX_ACCENTS,
    DOMINANT_SUFFIXES,
    KANA_WORDS,
    LOANWORD_ACCENTS,
    ONYOMI,
    SUFFIX_ACCENTS,
    WORDS,
)

logger = logging.getLogger(__name__)

# ％ → パーセント (reference: utils/g2p/japanese.py:15-17)
_SYMBOLS_TO_JAPANESE = [("％", "パーセント"), ("%", "パーセント")]

_japanese_characters = re.compile(
    r"[A-Za-z\d々぀-ヿ一-鿿１-９Ａ-Ｚ"
    r"ａ-ｚｦ-ﾝ]"
)
_japanese_marks = re.compile(
    r"[^A-Za-z\d々぀-ヿ一-鿿１-９Ａ-Ｚ"
    r"ａ-ｚｦ-ﾝ]"
)

_KANJI_RE = re.compile(r"[一-鿿々]")
_HIRA_RE = re.compile(r"[ぁ-ゟ]")
_KATA_RE = re.compile(r"[ァ-ヿー]")

# ---------------------------------------------------------------------------
# Kana → OpenJTalk-style romaji phoneme strings
# ---------------------------------------------------------------------------

_YOUON = {
    "きゃ": "kya", "きゅ": "kyu", "きょ": "kyo",
    "しゃ": "sha", "しゅ": "shu", "しょ": "sho",
    "ちゃ": "cha", "ちゅ": "chu", "ちょ": "cho",
    "にゃ": "nya", "にゅ": "nyu", "にょ": "nyo",
    "ひゃ": "hya", "ひゅ": "hyu", "ひょ": "hyo",
    "みゃ": "mya", "みゅ": "myu", "みょ": "myo",
    "りゃ": "rya", "りゅ": "ryu", "りょ": "ryo",
    "ぎゃ": "gya", "ぎゅ": "gyu", "ぎょ": "gyo",
    "じゃ": "ja", "じゅ": "ju", "じょ": "jo",
    "ぢゃ": "ja", "ぢゅ": "ju", "ぢょ": "jo",
    "びゃ": "bya", "びゅ": "byu", "びょ": "byo",
    "ぴゃ": "pya", "ぴゅ": "pyu", "ぴょ": "pyo",
    "ふぁ": "fa", "ふぃ": "fi", "ふぇ": "fe", "ふぉ": "fo",
    "てぃ": "ti", "でぃ": "di", "うぃ": "wi", "うぇ": "we",
    "しぇ": "she", "ちぇ": "che", "じぇ": "je",
    "ヴぁ": "ba", "ヴぃ": "bi", "ヴぇ": "be", "ヴぉ": "bo",
}

_GOJUON = {
    "あ": "a", "い": "i", "う": "u", "え": "e", "お": "o",
    "か": "ka", "き": "ki", "く": "ku", "け": "ke", "こ": "ko",
    "さ": "sa", "し": "shi", "す": "su", "せ": "se", "そ": "so",
    "た": "ta", "ち": "chi", "つ": "tsu", "て": "te", "と": "to",
    "な": "na", "に": "ni", "ぬ": "nu", "ね": "ne", "の": "no",
    "は": "ha", "ひ": "hi", "ふ": "fu", "へ": "he", "ほ": "ho",
    "ま": "ma", "み": "mi", "む": "mu", "め": "me", "も": "mo",
    "や": "ya", "ゆ": "yu", "よ": "yo",
    "ら": "ra", "り": "ri", "る": "ru", "れ": "re", "ろ": "ro",
    "わ": "wa", "ゐ": "i", "ゑ": "e", "を": "o", "ん": "N",
    "が": "ga", "ぎ": "gi", "ぐ": "gu", "げ": "ge", "ご": "go",
    "ざ": "za", "じ": "ji", "ず": "zu", "ぜ": "ze", "ぞ": "zo",
    "だ": "da", "ぢ": "ji", "づ": "zu", "で": "de", "ど": "do",
    "ば": "ba", "び": "bi", "ぶ": "bu", "べ": "be", "ぼ": "bo",
    "ぱ": "pa", "ぴ": "pi", "ぷ": "pu", "ぺ": "pe", "ぽ": "po",
    "ゔ": "bu",
}

_SMALL_VOWELS = {"ぁ": "a", "ぃ": "i", "ぅ": "u", "ぇ": "e", "ぉ": "o"}

# consonants (romaji prefixes) that trigger vowel devoicing between them
_VOICELESS = {"k", "s", "sh", "t", "ch", "ts", "h", "f", "p",
              "ky", "hy", "py"}


def _kata_to_hira(text: str) -> str:
    out = []
    for ch in text:
        code = ord(ch)
        if 0x30A1 <= code <= 0x30F6:  # ァ..ヶ
            out.append(chr(code - 0x60))
        else:
            out.append(ch)
    return "".join(out)


def _mora_split(reading: str) -> List[str]:
    """Hiragana reading → list of mora kana (youon = one mora; っ, ん, ー
    are their own moras, as in openjtalk's mora counting)."""
    reading = _kata_to_hira(reading)
    moras: List[str] = []
    i = 0
    n = len(reading)
    while i < n:
        two = reading[i : i + 2]
        if two in _YOUON:
            moras.append(two)
            i += 2
            continue
        moras.append(reading[i])
        i += 1
    return moras


def _mora_romaji(mora: str, prev_romaji: str) -> str:
    if mora == "っ":
        return "cl"
    if mora == "ー":
        for v in reversed(prev_romaji):
            if v in "aiueo":
                return v
        return ""
    if mora in _YOUON:
        return _YOUON[mora]
    if mora in _SMALL_VOWELS:
        return _SMALL_VOWELS[mora]
    if mora in _GOJUON:
        return _GOJUON[mora]
    return ""


def kana_to_romaji(text: str) -> str:
    """Hiragana/katakana string → OpenJTalk-style phoneme romaji
    (no accent marks; kept for direct use and tests)."""
    out = []
    prev = ""
    for mora in _mora_split(text):
        rom = _mora_romaji(mora, prev)
        if rom:
            out.append(rom)
            prev = rom
    return "".join(out)


# ---------------------------------------------------------------------------
# Number reading
# ---------------------------------------------------------------------------

_DIGIT_KANA = ["ゼロ", "いち", "に", "さん", "よん", "ご", "ろく", "なな",
               "はち", "きゅう"]


def _under_10000(n: int) -> str:
    parts = []
    sen, n = divmod(n, 1000)
    hyaku, n = divmod(n, 100)
    juu, ichi = divmod(n, 10)
    if sen:
        parts.append({1: "せん", 3: "さんぜん", 8: "はっせん"}.get(
            sen, _DIGIT_KANA[sen] + "せん"))
    if hyaku:
        parts.append({1: "ひゃく", 3: "さんびゃく", 6: "ろっぴゃく",
                      8: "はっぴゃく"}.get(hyaku, _DIGIT_KANA[hyaku] + "ひゃく"))
    if juu:
        parts.append(("" if juu == 1 else _DIGIT_KANA[juu]) + "じゅう")
    if ichi:
        parts.append(_DIGIT_KANA[ichi])
    return "".join(parts)


_KANJI_DIGITS = {"〇": 0, "零": 0, "一": 1, "二": 2, "三": 3, "四": 4,
                 "五": 5, "六": 6, "七": 7, "八": 8, "九": 9}
_KANJI_UNITS = {"十": 10, "百": 100, "千": 1000}
_KANJI_MYRIADS = {"万": 10**4, "億": 10**8, "兆": 10**12}
_NUM_KANJI = set(_KANJI_DIGITS) | set(_KANJI_UNITS) | set(_KANJI_MYRIADS)


def _parse_kanji_number(s: str, i: int) -> Tuple[int, int]:
    """Parse a kanji numeral at s[i:] → (value, chars consumed)."""
    total = 0
    section = 0  # value below the current myriad
    digit = 0
    j = i
    while j < len(s):
        c = s[j]
        if c in _KANJI_DIGITS:
            digit = digit * 10 + _KANJI_DIGITS[c]
        elif c in _KANJI_UNITS:
            section += (digit or 1) * _KANJI_UNITS[c]
            digit = 0
        elif c in _KANJI_MYRIADS:
            total += (section + (digit or 1 if section == 0 else digit)) * \
                _KANJI_MYRIADS[c]
            section = 0
            digit = 0
        else:
            break
        j += 1
    return total + section + digit, j - i


# counter words and the euphonic fusion of number + counter
_COUNTERS = {
    "円": "えん", "年": "ねん", "人": "にん", "時": "じ", "分": "ふん",
    "本": "ほん", "回": "かい", "個": "こ", "歳": "さい", "才": "さい",
    "匹": "ひき", "台": "だい", "枚": "まい", "冊": "さつ", "度": "ど",
    "番": "ばん", "階": "かい", "名": "めい", "点": "てん", "秒": "びょう",
    "杯": "はい", "軒": "けん", "頭": "とう", "羽": "わ", "足": "そく",
    "月": "がつ", "日": "にち",
}
# irregular (number, counter) readings
_COUNTER_IRREGULAR = {
    (1, "人"): "ひとり", (2, "人"): "ふたり", (4, "人"): "よにん",
    (4, "時"): "よじ", (7, "時"): "しちじ", (9, "時"): "くじ",
    (4, "年"): "よねん", (4, "円"): "よえん", (20, "歳"): "はたち",
    (1, "分"): "いっぷん", (3, "分"): "さんぷん", (4, "分"): "よんぷん",
    (6, "分"): "ろっぷん", (8, "分"): "はっぷん", (10, "分"): "じゅっぷん",
    (3, "本"): "さんぼん", (3, "杯"): "さんばい", (3, "匹"): "さんびき",
    (6, "匹"): "ろっぴき", (8, "匹"): "はっぴき", (10, "匹"): "じゅっぴき",
    (4, "月"): "しがつ", (7, "月"): "しちがつ", (9, "月"): "くがつ",
    (1, "日"): "ついたち", (2, "日"): "ふつか", (3, "日"): "みっか",
    (4, "日"): "よっか", (5, "日"): "いつか", (6, "日"): "むいか",
    (7, "日"): "なのか", (8, "日"): "ようか", (9, "日"): "ここのか",
    (10, "日"): "とおか", (14, "日"): "じゅうよっか", (20, "日"): "はつか",
    (24, "日"): "にじゅうよっか",
}
# number-final kana → geminated form before voiceless-initial counters
_GEMINATE = {"いち": "いっ", "はち": "はっ", "じゅう": "じゅっ",
             "ひゃく": "ひゃっ", "ろく": "ろっ"}
_H_TO_P = {"は": "ぱ", "ひ": "ぴ", "ふ": "ぷ", "へ": "ぺ", "ほ": "ぽ"}
_H_TO_B = {"は": "ば", "ひ": "び", "ふ": "ぶ", "へ": "べ", "ほ": "ぼ"}


def _number_with_counter(value: int, counter: str) -> str:
    """Standard counter euphony: 一回→いっかい, 一本→いっぽん,
    三本→さんぼん, 六回→ろっかい, 八冊→はっさつ, 十分→じゅっぷん…"""
    irr = _COUNTER_IRREGULAR.get((value, counter))
    if irr is not None:
        return irr
    num = number_to_kana(str(value))
    cread = _COUNTERS[counter]
    first = cread[0]
    row = ("k" if first in "かきくけこ" else
           "s" if first in "さしすせそ" else
           "t" if first in "たちつてと" else
           "h" if first in "はひふへほ" else "")
    gem_ok = {"k": ("いち", "はち", "じゅう", "ろく", "ひゃく"),
              "s": ("いち", "はち", "じゅう"),
              "t": ("いち", "はち", "じゅう"),
              "h": ("いち", "はち", "じゅう", "ろく", "ひゃく")}.get(row, ())
    for tail in gem_ok:
        if num.endswith(tail):
            num = num[: -len(tail)] + _GEMINATE[tail]
            if row == "h":
                cread = _H_TO_P[first] + cread[1:]
            break
    else:
        if row == "h" and num.endswith("さん"):
            cread = _H_TO_B[first] + cread[1:]
    return num + cread


def number_to_kana(s: str) -> str:
    """Digit string → kana reading (cardinal; digit-by-digit for leading
    zeros or >16 digits; 。/． decimals read as 点)."""
    if "." in s:
        a, b = s.split(".", 1)
        return number_to_kana(a) + "てん" + "".join(
            _DIGIT_KANA[int(c)] for c in b if c.isdigit())
    if not s.isdigit():
        return ""
    if len(s) > 16 or (len(s) > 1 and s[0] == "0"):
        return "".join(_DIGIT_KANA[int(c)] for c in s)
    n = int(s)
    if n == 0:
        return "ゼロ"
    units = ["", "まん", "おく", "ちょう"]
    parts = []
    for u in units:
        n, grp = divmod(n, 10000) if u != "ちょう" else (0, n)
        if grp:
            g = _under_10000(grp)
            if u == "ちょう":
                g = {"いち": "いっ", "はち": "はっ",
                     "じゅう": "じゅっ"}.get(g, g)
            parts.append(g + u)
        if n == 0:
            break
    return "".join(reversed(parts))


# ---------------------------------------------------------------------------
# Accent-phrase segmentation
# ---------------------------------------------------------------------------

_MAX_WORD_LEN = max(len(k) for k in WORDS)
_MAX_KANA_LEN = max(len(k) for k in KANA_WORDS)

# particle rewrites inside an attached hiragana tail
_TAIL_DEWA_NIWA = re.compile(r"(?<=[でに])は(?=[^はばぱ]|$)")
_TAIL_FINAL_WA = re.compile(r"は$")


class _Phrase:
    __slots__ = ("reading", "accent")

    def __init__(self, reading: str, accent: Optional[int]):
        self.reading = reading  # hiragana (may still contain ー)
        self.accent = accent  # None → resolve by default rules


def _match_word(s: str, i: int) -> Optional[Tuple[str, str, int]]:
    """Longest lexicon match at position i → (surface, reading, accent)."""
    for ln in range(min(_MAX_WORD_LEN, len(s) - i), 0, -1):
        cand = s[i : i + ln]
        if cand in WORDS:
            # single-char hiragana/katakana "words" would swallow particles
            if ln == 1 and not _KANJI_RE.match(cand):
                continue
            r, a = WORDS[cand]
            return cand, r, a
    return None


def _loanword_accent(reading: str) -> int:
    """-3 rule for unknown katakana words: nucleus on the mora containing
    the antepenultimate, skipping moras that can't carry the accent."""
    moras = _mora_split(reading)
    n = len(moras)
    if n <= 2:
        return 1
    pos = n - 2
    while pos > 1 and moras[pos - 1] in ("ー", "っ", "ん"):
        pos -= 1
    return pos


# deaccenting second elements: compounds ending in these readings are
# heiban regardless of length (屋 さかなや, 色 みずいろ, 側 みなみがわ …)
_DEACCENT_N2 = {"や", "いろ", "がわ", "ふう", "づき", "むき"}


def _compound_accent(parts) -> int:
    """Compound-noun junction accent (the NHK/Kubozono rule set the
    reference gets from UniDic's accent-concatenation fields,
    utils/g2p/japanese.py:74-113): the compound's nucleus is decided by
    the SECOND element (N2) —
      - N2 of 1-2 moras: nucleus on the final mora of N1;
      - N2 of 3-4 moras: nucleus on the first mora of N2;
      - N2 of 5+ moras: N2 keeps its own accent (heiban N2 → heiban);
      - deaccenting N2s (屋/色/側/風/…): heiban.
    parts: [(reading, accent | None)] — accent None means the part came
    from the per-character on'yomi fallback, not the lexicon."""
    r2, a2 = parts[-1]
    if r2 in _DEACCENT_N2:
        return 0
    n1 = sum(len(_mora_split(r)) for r, _ in parts[:-1])
    m2 = len(_mora_split(r2))
    if m2 <= 2:
        return n1
    if m2 <= 4 or a2 is None:
        return n1 + 1
    return n1 + a2 if a2 > 0 else 0


def _resolve_accent(phrase: _Phrase) -> int:
    """Final accent type for the full phrase reading (content + tail)."""
    moras = _mora_split(phrase.reading)
    n = len(moras)
    base = phrase.accent if phrase.accent is not None else 0

    for suffix, offset in SUFFIX_ACCENTS:
        if phrase.reading.endswith(suffix):
            if suffix in DOMINANT_SUFFIXES or base == 0:
                suffix_moras = len(_mora_split(suffix))
                # nucleus sits `offset` moras from the end; only adopt it
                # if the suffix actually is an auxiliary (tail region)
                if n > suffix_moras or base == 0:
                    return max(0, n - offset)
            break

    # class-sensitive conjugation accents (ない/なかった/conditional ば):
    # the rule depends on whether the conjugation STEM is heiban or
    # accented — the stem entries carry that class in `base`
    for suffix, heiban_rule, accented_rule in CONJ_SUFFIX_ACCENTS:
        if not phrase.reading.endswith(suffix):
            continue
        suffix_moras = len(_mora_split(suffix))
        if n <= suffix_moras:
            break  # the "suffix" IS the whole phrase — not a conjugation
        rule = heiban_rule if base == 0 else accented_rule
        if rule is None:
            break  # keep: heiban stays 0, accented keeps its nucleus
        return max(0, n - rule)

    return min(base, n)


def _apply_tail_particles(tail: str, content_end: bool) -> str:
    """Particle readings inside an attached hiragana tail.

    Mirrors the reference behavior (openjtalk reads particles correctly;
    the span contract is the same as the old regex rules):
    - tail-initial は right after a content word is the topic particle;
    - では/には clusters;
    - phrase-final は (こんにちは, …では。);
    - tail-initial へ not followed by hiragana is the direction particle;
    - を is always the object particle.
    """
    if content_end and tail.startswith("は"):
        tail = "わ" + tail[1:]
    if content_end and tail == "へ":
        tail = "え"
    tail = _TAIL_DEWA_NIWA.sub("わ", tail)
    tail = _TAIL_FINAL_WA.sub("わ", tail)
    return tail.replace("を", "お")


def _split_tail(tail: str) -> Tuple[str, str]:
    """Split an attached hiragana run where a standalone kana word starts
    (…はとても… → 'は' + 'とても…'; …ください → '' + 'ください').
    Returns (attached, rest)."""
    for j in range(0, len(tail)):
        min_len = 3 if j == 0 else 2
        for ln in range(min(_MAX_KANA_LEN, len(tail) - j), min_len - 1, -1):
            if tail[j : j + ln] in KANA_WORDS:
                return tail[:j], tail[j:]
    return tail, ""


# Compound recognition without POS data: a lexicon word followed by more
# kanji is a compound ONLY for (a) prefix-like first elements that rarely
# stand alone, or (b) a single suffix kanji closing the run (卒業+式,
# 観光+客). Bare noun-noun adjacency (昨日映画を…) stays two phrases —
# merging it wholesale mis-joins temporal nouns and numeral phrases
# (measured on the sentence goldens before this gate existed).
_COMPOUND_PREFIXES = {
    "国際", "高速", "電子", "携帯", "卒業", "入学", "研究", "自動",
    "消防", "観光", "株式", "高等", "横断", "地下", "中央", "総合",
}
_COMPOUND_SUFFIX_KANJI = set("式所局会園館客場線署課庁証券")
# 2-kanji compound tails: after another 2-kanji noun these close a
# compound (電話番号, 営業時間, 郵便局? — 3-kanji; tails must be words the
# junction rule can accent from their own lexicon entries)
_COMPOUND_TAILS = (
    "番号", "会社", "時間", "料金", "会場", "番組", "切符", "売場",
)


def _starts_compound(s: str, i: int, m, n: int) -> bool:
    """True when the lexicon match at i should instead open a kanji-run
    compound phrase (the run loop re-matches it as its first part)."""
    surface = m[0]
    j = i + len(surface)
    if j >= n or not _KANJI_RE.match(s[j]):
        return False
    if not all(_KANJI_RE.match(c) for c in surface):
        return False
    if s[j] in _NUM_KANJI:
        return False  # 毎朝七時…: numeral phrases parse separately
    if surface in _COMPOUND_PREFIXES:
        return True
    # 2-kanji noun + known compound TAIL (番号, 会社, …): wholesale
    # noun-noun merging measured worse on the sentence goldens (temporal
    # nouns, numerals), so only whitelisted tails that essentially never
    # stand as an independent phrase after another noun merge
    if len(surface) == 2:
        for tail in _COMPOUND_TAILS:
            if s.startswith(tail, j) and (
                j + len(tail) >= n or not _KANJI_RE.match(s[j + len(tail)])
            ):
                return True
    # single suffix kanji closing the kanji run
    return (
        s[j] in _COMPOUND_SUFFIX_KANJI
        and (j + 1 >= n or not _KANJI_RE.match(s[j + 1]))
    )


def _analyze(sentence: str) -> List[_Phrase]:
    """Japanese sentence (no punctuation) → accent phrases."""
    s = sentence
    phrases: List[_Phrase] = []
    prefix = ""  # pending honorific お/ご before a content word
    i = 0
    n = len(s)

    def _push(reading: str, accent: Optional[int]):
        nonlocal prefix
        if prefix:
            shift = len(_mora_split(prefix))
            reading = prefix + reading
            if accent:
                accent += shift
            prefix = ""
        phrases.append(_Phrase(reading, accent))

    while i < n:
        ch = s[i]

        # honorific prefix: お/ご immediately before kanji or katakana
        if (
            ch in ("お", "ご")
            and not prefix
            and i + 1 < n
            and (_KANJI_RE.match(s[i + 1]) or _KATA_RE.match(s[i + 1]))
            and _match_word(s, i) is None
        ):
            prefix = ch
            i += 1
            continue

        m = _match_word(s, i)

        # single-kanji i-adjective stem before a conjugation opener
        # (高かった, 白く, 強ければ, 早さ): these stems live OUTSIDE
        # WORDS — as lexicon words they split kanji compounds
        # (高速道路 → たか/…). A longer lexicon match still wins.
        # the adverbial noun reading (近く ちかく[1], 遠く とおく[3])
        # shadows the adjective stem; before a negative/なる continuation
        # the く is the adjective's conjugation, not the noun
        adv_noun_shadow = (
            m is not None
            and len(m[0]) == 2
            and m[0][1] == "く"
            and s[i + 2 : i + 4]
            in ("ない", "なか", "なく", "なけ", "なる", "なり", "なっ")
        )
        if (
            ch in ADJ_1CHAR_STEMS
            and i + 1 < n
            and s[i + 1] in "かくけさそ"
            and (m is None or len(m[0]) <= 1 or adv_noun_shadow)
        ):
            _r, _a = ADJ_1CHAR_STEMS[ch]
            _push(_r, _a)
            i += 1
            continue

        # kanji numerals (possibly followed by a counter): 五千円 →
        # ごせんえん — unless a longer lexicon word covers the span
        # (一緒, 一番: fixed readings + accents win)
        if ch in _NUM_KANJI:
            val, ln = _parse_kanji_number(s, i)
            nxt = s[i + ln] if i + ln < n else ""
            lex_longer = m is not None and len(m[0]) > ln
            if (ln >= 2 or nxt in _COUNTERS) and not lex_longer:
                if nxt in _COUNTERS:
                    _push(_number_with_counter(val, nxt), 0)
                    i += ln + 1
                else:
                    _push(number_to_kana(str(val)), 0)
                    i += ln
                continue
        # a lexicon word must not split a longer contiguous katakana run
        # (バスケットボール would match バス): unknown loans take the whole
        # run through the -3 rule in the katakana branch below
        if m is not None and _KATA_RE.match(ch):
            _j = i
            while _j < n and _KATA_RE.match(s[_j]):
                _j += 1
            # _match_word is longest-match, so a shorter m means the
            # full run is NOT a lexicon word itself
            if _j - i > len(m[0]) and s[i:_j] not in LOANWORD_ACCENTS:
                m = None
        if m and not _starts_compound(s, i, m, n):
            surface, reading, accent = m
            i += len(surface)
            _push(reading, accent)
        elif _KANJI_RE.match(ch):
            # kanji run (incl. recognized compounds — see _starts_compound):
            # collects lexicon words + per-character on'yomi readings
            # into parts; the junction rule resolves the accent
            # unknown kanji run: read per character (on'yomi fallback),
            # allowing embedded lexicon words to contribute readings
            parts = []  # [(reading, accent | None)]
            while i < n and _KANJI_RE.match(s[i]):
                m2 = _match_word(s, i)
                if m2 and all(_KANJI_RE.match(c) for c in m2[0]):
                    parts.append((m2[1], m2[2]))
                    i += len(m2[0])
                    continue
                if m2:
                    break  # okurigana word (言って…): own phrase next loop
                c = s[i]
                if c == "々" and parts:
                    parts.append(parts[-1])
                elif c in ONYOMI:
                    parts.append((ONYOMI[c], None))
                else:
                    logger.warning("no reading for kanji %r; skipped", c)
                i += 1
            reading = "".join(r for r, _ in parts)
            if len(parts) == 1:
                accent = parts[0][1] if parts[0][1] is not None else 0
            elif parts:
                # OOV compound: junction rule instead of flat heiban
                accent = _compound_accent(parts)
            else:
                accent = 0
            if reading:
                _push(reading, accent)
        elif _KATA_RE.match(ch):
            j = i
            while j < n and _KATA_RE.match(s[j]):
                j += 1
            surface = s[i:j]
            accent = LOANWORD_ACCENTS.get(surface)
            if accent is None:
                accent = _loanword_accent(surface)
            _push(_kata_to_hira(surface), accent)
            i = j
        elif ch.isdigit():
            j = i
            while j < n and s[j].isdigit():
                j += 1
            has_frac = (
                j < n and s[j] == "." and j + 1 < n and s[j + 1].isdigit()
            )
            if has_frac:
                j += 1
                while j < n and s[j].isdigit():
                    j += 1
            digits = s[i:j]
            nxt = s[j] if j < n else ""
            if not has_frac and nxt in _COUNTERS and digits.isdigit() \
                    and len(digits) <= 16 and digits[0] != "0":
                _push(_number_with_counter(int(digits), nxt), 0)
                i = j + 1
            else:
                _push(number_to_kana(digits), 0)
                i = j
        elif _HIRA_RE.match(ch):
            j = i
            while j < n and _HIRA_RE.match(s[j]):
                j += 1
            # keep a trailing お/ご for the next word's honorific prefix
            # (…でお願いします → tail 'で', prefix 'お' + 願い)
            if (
                j - i > 1
                and s[j - 1] in ("お", "ご")
                and j < n
                and (_KANJI_RE.match(s[j]) or _KATA_RE.match(s[j]))
            ):
                j -= 1
            run = s[i:j]
            i = j
            after_content = bool(phrases)
            while run:
                if after_content:
                    attached, rest = _split_tail(run)
                    attached = _apply_tail_particles(
                        attached, content_end=True
                    )
                    if not rest:
                        attached = _TAIL_FINAL_WA.sub("わ", attached)
                    phrases[-1].reading += attached
                    run = rest
                    after_content = False
                    continue
                # standalone kana word at the head of the run
                matched = None
                for ln in range(min(_MAX_KANA_LEN, len(run)), 1, -1):
                    if run[:ln] in KANA_WORDS:
                        matched = run[:ln]
                        break
                if matched:
                    word = matched
                    run = run[len(matched):]
                    if not run:
                        word = _TAIL_FINAL_WA.sub("わ", word)
                    phrases.append(_Phrase(word, KANA_WORDS[matched]))
                    after_content = True
                else:
                    head, rest = _split_tail(run)
                    head = _apply_tail_particles(head, content_end=False)
                    if not rest:
                        head = _TAIL_FINAL_WA.sub("わ", head)
                    phrases.append(_Phrase(head, 0))
                    run = rest
                    after_content = False
        else:
            i += 1  # latin or other: openjtalk would spell it; skip
    if prefix:
        phrases.append(_Phrase(prefix, 0))
    return [p for p in phrases if p.reading]


# ---------------------------------------------------------------------------
# Mark emission (reference rules, japanese.py:97-110)
# ---------------------------------------------------------------------------

def _emit_phrase(phrase: _Phrase, is_last: bool) -> str:
    moras = _mora_split(phrase.reading)
    accent = _resolve_accent(phrase)
    roms: List[str] = []
    prev = ""
    for mora in moras:
        rom = _mora_romaji(mora, prev)
        roms.append(rom)
        if rom:
            prev = rom
    n = len(moras)

    # devoicing: i/u with a voiceless consonant, followed by a voiceless
    # consonant (or っ), not the accent nucleus, not after a devoiced mora;
    # plus the utterance-final unaccented す (です/ます before pau)
    devoiced_prev = False
    for k, rom in enumerate(roms):
        if not rom or rom[-1] not in "iu" or rom[:-1] not in _VOICELESS:
            devoiced_prev = False
            continue
        mora_idx = k + 1
        if mora_idx == accent or devoiced_prev:
            devoiced_prev = False
            continue
        nxt = roms[k + 1] if k + 1 < len(roms) else None
        voiceless_next = nxt is not None and (
            nxt == "cl"
            or nxt[:2] in _VOICELESS
            or nxt[:1] in _VOICELESS
        )
        final_su = nxt is None and is_last and rom == "su"
        if voiceless_next or final_su:
            roms[k] = rom[:-1] + rom[-1].upper()
            devoiced_prev = True
        else:
            devoiced_prev = False

    out: List[str] = []
    for m, rom in enumerate(roms, 1):
        out.append(rom)
        if m < n:
            if accent == m:
                out.append("↓")  # falling: a1==0 ∧ a2_next==a2+1
            elif m == 1 and accent != 1:
                out.append("↑")  # rising: a2==1 ∧ a2_next==2
    return "".join(out)


# ---------------------------------------------------------------------------
# Public pipeline (same contract as the reference)
# ---------------------------------------------------------------------------

def japanese_to_romaji_with_accent(text: str) -> str:
    """Japanese text → romaji phonemes with ↑/↓ accent marks and spaces at
    accent-phrase boundaries; punctuation ascii-folded.

    Same output contract as the reference function (ch→ʧ, sh→ʃ, cl→Q,
    sentence chunks joined with spaces; utils/g2p/japanese.py:74-113).
    """
    for sym, jp in _SYMBOLS_TO_JAPANESE:
        text = text.replace(sym, jp)
    sentences = re.split(_japanese_marks, text)
    marks = re.findall(_japanese_marks, text)
    out = ""
    for i, sentence in enumerate(sentences):
        if re.match(_japanese_characters, sentence):
            if out != "":
                out += " "
            phrases = _analyze(unicodedata.normalize("NFKC", sentence))
            emitted = [
                _emit_phrase(p, is_last=(k == len(phrases) - 1))
                for k, p in enumerate(phrases)
            ]
            romaji = " ".join(e for e in emitted if e)
            romaji = (
                romaji.replace("ch", "ʧ").replace("sh", "ʃ").replace("cl", "Q")
            )
            out += romaji
        if i < len(marks):
            mark = unicodedata.normalize("NFKC", marks[i]).replace(" ", "")
            out += "".join(c for c in mark if ord(c) < 128 or c in "、。！？")
    out = out.replace("、", ",").replace("。", ".").replace("！", "!").replace(
        "？", "?"
    )
    return out


# Sokuon/hatsuon rewrites (reference: utils/g2p/japanese.py:53-67)
_REAL_SOKUON = [
    (re.compile(r"Q([↑↓]*[kg])"), r"k#\1"),
    (re.compile(r"Q([↑↓]*[tdjʧ])"), r"t#\1"),
    (re.compile(r"Q([↑↓]*[sʃ])"), r"s\1"),
    (re.compile(r"Q([↑↓]*[pb])"), r"p#\1"),
]
_REAL_HATSUON = [
    (re.compile(r"N([↑↓]*[pbm])"), r"m\1"),
    (re.compile(r"N([↑↓]*[ʧʥj])"), r"n^\1"),
    (re.compile(r"N([↑↓]*[tdn])"), r"n\1"),
    (re.compile(r"N([↑↓]*[kg])"), r"ŋ\1"),
]

# romaji → ipa2 (reference: utils/g2p/japanese.py:36-50), order matters
_ROMAJI_TO_IPA2 = [
    ("u", "ɯ"), ("ʧ", "tʃ"), ("j", "dʑ"), ("y", "j"), ("ni", "n^i"),
    ("nj", "n^"), ("hi", "çi"), ("hj", "ç"), ("f", "ɸ"), ("I", "i*"),
    ("U", "ɯ*"), ("r", "ɾ"),
]


def post_romaji_to_ipa2(text: str) -> str:
    """The deterministic tail of ``japanese_to_ipa2``: accented romaji →
    IPA2 (sokuon/hatsuon assimilation + romaji→IPA table). Split out so
    tests can pin it against the reference's regex tables
    (utils/g2p/japanese.py:36-67,139-145)."""
    for regex, repl in _REAL_SOKUON:
        text = regex.sub(repl, text)
    for regex, repl in _REAL_HATSUON:
        text = regex.sub(repl, text)
    for pat, repl in _ROMAJI_TO_IPA2:
        text = text.replace(pat, repl)
    return text


def japanese_to_ipa2(text: str) -> str:
    return post_romaji_to_ipa2(
        japanese_to_romaji_with_accent(text).replace("...", "…")
    )
