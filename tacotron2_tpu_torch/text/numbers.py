"""Number normalization for the English text frontend.

Behavioral parity with reference code/tacotron/utils/numbers.py:62-68 (which
delegates to the `inflect` package). `inflect` is not available in this
environment, so the number-to-words conversion the reference relies on —
cardinals with configurable "and" word, grouped (year-style) reading, ordinal
expansion — is implemented natively below.
"""

from __future__ import annotations

import re

_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALES = ["", " thousand", " million", " billion", " trillion", " quadrillion"]

_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _two_digits(n: int, zero: str = "zero") -> str:
    """Speak 0..99."""
    if n < 20:
        return zero if n == 0 else _ONES[n]
    tens, ones = divmod(n, 10)
    word = _TENS[tens]
    return f"{word}-{_ONES[ones]}" if ones else word


def _three_digits(n: int, andword: str) -> str:
    """Speak 1..999 (n must be nonzero)."""
    hundreds, rest = divmod(n, 100)
    parts = []
    if hundreds:
        parts.append(f"{_ONES[hundreds]} hundred")
    if rest:
        joiner = f"{andword} " if (hundreds and andword) else ""
        parts.append(joiner + _two_digits(rest))
    return " ".join(parts)


def number_to_words(n, andword: str = "and", zero: str = "zero",
                    group: int = 0) -> str:
    """English words for an integer (or ordinal string like '21st').

    Mirrors the subset of `inflect.engine().number_to_words` the reference's
    normalize_numbers uses: plain cardinals, `andword=''`, and year-style
    `group=2, zero='oh'` reading (numbers.py:49-58).
    """
    if isinstance(n, str) and _ordinal_re.fullmatch(n):
        return _ordinal_words(int(n[:-2]))
    n = int(n)
    if n < 0:
        return "minus " + number_to_words(-n, andword=andword, zero=zero)
    if group == 2:
        digits = str(n)
        if len(digits) % 2:
            digits = digits[0] + " " + digits[1:]  # odd length: lone lead digit
            chunks = [digits.split(" ")[0]] + _pairs(digits.split(" ")[1])
        else:
            chunks = _pairs(digits)
        return ", ".join(_speak_group(c, zero) for c in chunks)
    if n == 0:
        return zero
    groups = []
    scale = 0
    while n:
        n, rem = divmod(n, 1000)
        if rem:
            groups.append(_three_digits(rem, andword) + _SCALES[scale])
        scale += 1
    return ", ".join(reversed(groups))


def _pairs(digits: str):
    return [digits[i:i + 2] for i in range(0, len(digits), 2)]


def _speak_group(chunk: str, zero: str) -> str:
    if len(chunk) == 1:
        return zero if chunk == "0" else _ONES[int(chunk)]
    if chunk == "00":
        return f"{zero} {zero}"
    if chunk[0] == "0":
        return f"{zero} {_ONES[int(chunk[1])]}"
    return _two_digits(int(chunk))


def _ordinal_words(n: int) -> str:
    words = number_to_words(n, andword="")
    head, _, last = words.rpartition("-")
    if not head:
        head, _, last = words.rpartition(" ")
        sep = " "
    else:
        sep = "-"
    if last in _ORDINAL_IRREGULAR:
        last = _ORDINAL_IRREGULAR[last]
    elif last.endswith("y"):
        last = last[:-1] + "ieth"
    else:
        last = last + "th"
    return (head + sep + last) if head else last


# ------------------------------------------------------------------ expansion
# Regex pipeline identical in behavior to reference numbers.py:62-68.

def _remove_commas(m):
    return m.group(1).replace(",", "")


def _expand_decimal_point(m):
    return m.group(1).replace(".", " point ")


def _expand_dollars(m):
    match = m.group(1)
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"  # unexpected format
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        dollar_unit = "dollar" if dollars == 1 else "dollars"
        cent_unit = "cent" if cents == 1 else "cents"
        return f"{dollars} {dollar_unit}, {cents} {cent_unit}"
    elif dollars:
        return f"{dollars} {'dollar' if dollars == 1 else 'dollars'}"
    elif cents:
        return f"{cents} {'cent' if cents == 1 else 'cents'}"
    return "zero dollars"


def _expand_ordinal(m):
    return number_to_words(m.group(0))


def _expand_number(m):
    """Year-aware cardinal expansion (reference numbers.py:46-58)."""
    num = int(m.group(0))
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        elif 2000 < num < 2010:
            return "two thousand " + number_to_words(num % 100, andword="")
        elif num % 100 == 0:
            return number_to_words(num // 100, andword="") + " hundred"
        else:
            return number_to_words(num, andword="", zero="oh", group=2).replace(", ", " ")
    return number_to_words(num, andword="")


def normalize_numbers(text: str) -> str:
    text = re.sub(_comma_number_re, _remove_commas, text)
    text = re.sub(_pounds_re, r"\1 pounds", text)
    text = re.sub(_dollars_re, _expand_dollars, text)
    text = re.sub(_decimal_number_re, _expand_decimal_point, text)
    text = re.sub(_ordinal_re, _expand_ordinal, text)
    text = re.sub(_number_re, _expand_number, text)
    return text
