"""Text cleaners.

Behavioral parity with reference code/tacotron/utils/cleaners.py:69-91:
english_cleaners = ascii transliteration → number expansion → abbreviation
expansion → whitespace collapse (note: lowercase deliberately disabled, as in
the reference, cleaners.py:87). The `unidecode` package is unavailable here, so
ASCII transliteration uses NFKD decomposition plus a punctuation fold table —
identical behavior on the Latin-script inputs the reference targets.
"""

from __future__ import annotations

import re
import unicodedata

from .numbers import normalize_numbers

_whitespace_re = re.compile(r"\s+")

_abbreviations = [
    (re.compile(rf"\b{abbr}\.", re.IGNORECASE), full) for abbr, full in [
        ("mrs", "misess"),
        ("mr", "mister"),
        ("dr", "doctor"),
        ("st", "saint"),
        ("co", "company"),
        ("jr", "junior"),
        ("maj", "major"),
        ("gen", "general"),
        ("drs", "doctors"),
        ("rev", "reverend"),
        ("lt", "lieutenant"),
        ("hon", "honorable"),
        ("sgt", "sergeant"),
        ("capt", "captain"),
        ("esq", "esquire"),
        ("ltd", "limited"),
        ("col", "colonel"),
        ("ft", "fort"),
    ]
]

# Punctuation/symbol folds NFKD cannot resolve (what unidecode would emit).
_TRANSLIT = {
    "‘": "'", "’": "'", "‚": "'", "‛": "'",
    "“": '"', "”": '"', "„": '"',
    "–": "-", "—": "-", "―": "-", "−": "-",
    "…": "...", " ": " ",
    "æ": "ae", "Æ": "AE", "œ": "oe", "Œ": "OE",
    "ß": "ss", "ø": "o", "Ø": "O",
    "ð": "d", "Ð": "D", "þ": "th", "Þ": "Th",
    "Ł": "L", "ł": "l", "£": "£",  # keep £ for normalize_numbers
}


def expand_abbreviations(text: str) -> str:
    for regex, replacement in _abbreviations:
        text = re.sub(regex, replacement, text)
    return text


def expand_numbers(text: str) -> str:
    return normalize_numbers(text)


def lowercase(text: str) -> str:
    return text.lower()


def collapse_whitespace(text: str) -> str:
    return re.sub(_whitespace_re, " ", text)


def convert_to_ascii(text: str) -> str:
    """Transliterate to ASCII (drop-in for unidecode on Latin-script text)."""
    text = "".join(_TRANSLIT.get(ch, ch) for ch in text)
    decomposed = unicodedata.normalize("NFKD", text)
    out = []
    for ch in decomposed:
        if ch == "£":
            out.append(ch)  # consumed later by normalize_numbers
        elif ord(ch) < 128:
            out.append(ch)
        # else: drop combining marks / untransliterable symbols
    return "".join(out)


def basic_cleaners(text: str) -> str:
    """Lowercase + whitespace collapse, no transliteration."""
    text = lowercase(text)
    text = collapse_whitespace(text)
    return text


def transliteration_cleaners(text: str) -> str:
    """ASCII transliteration for non-English text."""
    text = convert_to_ascii(text)
    text = lowercase(text)
    text = collapse_whitespace(text)
    return text


def english_cleaners(text: str) -> str:
    """English pipeline: ascii → numbers → abbreviations → whitespace.

    Case is preserved, matching the reference (cleaners.py:87 commented out).
    """
    text = convert_to_ascii(text)
    text = expand_numbers(text)
    text = expand_abbreviations(text)
    text = collapse_whitespace(text)
    # £ placeholders not consumed by normalize_numbers are dropped to ASCII
    return text.replace("£", "")


CLEANERS = {
    "basic_cleaners": basic_cleaners,
    "transliteration_cleaners": transliteration_cleaners,
    "english_cleaners": english_cleaners,
}
