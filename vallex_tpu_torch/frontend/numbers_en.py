"""English number → words expansion (pure Python, no `inflect` dependency).

Covers the same normalization surface as the reference
(utils/g2p/english.py:95-152): comma removal, pounds/dollars, decimal points,
ordinals, and plain numbers with the year-style 1000-3000 special case.
"""

from __future__ import annotations

import re

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALES = [
    (10 ** 12, "trillion"),
    (10 ** 9, "billion"),
    (10 ** 6, "million"),
    (10 ** 3, "thousand"),
    (100, "hundred"),
]

_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _two_digits(n: int) -> str:
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    return _TENS[tens] + ("" if ones == 0 else " " + _ONES[ones])


def number_to_words(n: int, andword: str = "") -> str:
    if n < 0:
        return "minus " + number_to_words(-n, andword)
    if n < 100:
        return _two_digits(n)
    parts = []
    for scale, name in _SCALES:
        if n >= scale:
            parts.append(number_to_words(n // scale) + " " + name)
            n %= scale
    if n:
        if andword:
            parts.append(andword)
        parts.append(_two_digits(n))
    return " ".join(parts)


def number_to_ordinal_words(n: int) -> str:
    words = number_to_words(n)
    head, _, last = words.rpartition(" ")
    if last in _ORDINAL_IRREGULAR:
        last = _ORDINAL_IRREGULAR[last]
    elif last.endswith("y"):
        last = last[:-1] + "ieth"
    else:
        last = last + "th"
    return (head + " " + last).strip()


_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")


def _expand_dollars(m: re.Match) -> str:
    match = m.group(1)
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        dollar_unit = "dollar" if dollars == 1 else "dollars"
        cent_unit = "cent" if cents == 1 else "cents"
        return f"{dollars} {dollar_unit}, {cents} {cent_unit}"
    if dollars:
        return f"{dollars} {'dollar' if dollars == 1 else 'dollars'}"
    if cents:
        return f"{cents} {'cent' if cents == 1 else 'cents'}"
    return "zero dollars"


def _expand_number(m: re.Match) -> str:
    num = int(m.group(0))
    if 1000 < num < 3000:
        # Year-style reading (reference: utils/g2p/english.py:130-139)
        if num == 2000:
            return "two thousand"
        if 2000 < num < 2010:
            return "two thousand " + number_to_words(num % 100)
        if num % 100 == 0:
            return number_to_words(num // 100) + " hundred"
        hi, lo = divmod(num, 100)
        lo_words = "oh " + _ONES[lo] if lo < 10 else _two_digits(lo)
        return number_to_words(hi) + " " + lo_words
    return number_to_words(num)


def normalize_numbers(text: str) -> str:
    text = re.sub(_comma_number_re, lambda m: m.group(1).replace(",", ""), text)
    text = re.sub(_pounds_re, r"\1 pounds", text)
    text = re.sub(_dollars_re, _expand_dollars, text)
    text = re.sub(
        _decimal_number_re, lambda m: m.group(1).replace(".", " point "), text
    )
    text = re.sub(_ordinal_re, lambda m: number_to_ordinal_words(int(re.sub(r"\D", "", m.group(0)))), text)
    text = re.sub(_number_re, _expand_number, text)
    return text
