"""Text frontend: string ↔ symbol-id sequences.

Parity with reference code/tacotron/utils/text.py:14-54: curly-brace ARPAbet
passthrough, cleaner pipeline dispatch, EOS append, pad/eos exclusion on
re-encode.
"""

from __future__ import annotations

import re
from typing import List, Sequence

from . import cleaners as _cleaners_mod
from .cleaners import CLEANERS
from .symbols import EOS, EOS_ID, PAD, PAD_ID, symbols, symbols_with_arpabet

_symbol_to_id = {s: i for i, s in enumerate(symbols_with_arpabet)}
_id_to_symbol = {i: s for i, s in enumerate(symbols_with_arpabet)}

_curly_re = re.compile(r"(.*?)\{(.+?)\}(.*)")


def text_to_sequence(text: str, cleaner_names: Sequence[str] | str = ("english_cleaners",)) -> List[int]:
    """Convert text to symbol ids; `{HH AW1 S}` spans are read as ARPAbet.

    Appends the EOS id, as the reference does (text.py:40).
    """
    if isinstance(cleaner_names, str):
        cleaner_names = [c.strip() for c in cleaner_names.split(",") if c.strip()]
    sequence: List[int] = []
    while len(text):
        m = _curly_re.match(text)
        if not m:
            sequence += _symbols_to_sequence(_clean_text(text, cleaner_names))
            break
        sequence += _symbols_to_sequence(_clean_text(m.group(1), cleaner_names))
        sequence += _arpabet_to_sequence(m.group(2))
        text = m.group(3)
    sequence.append(EOS_ID)
    return sequence


def sequence_to_text(sequence: Sequence[int]) -> str:
    """Inverse mapping; ARPAbet symbols re-wrapped in curly braces."""
    result = ""
    for sid in sequence:
        if sid in _id_to_symbol:
            s = _id_to_symbol[sid]
            if len(s) > 1 and s[0] == "@":
                s = "{%s}" % s[1:]
            result += s
    return result.replace("}{", " ")


def _clean_text(text: str, cleaner_names: Sequence[str]) -> str:
    for name in cleaner_names:
        cleaner = CLEANERS.get(name)
        if cleaner is None:
            raise ValueError(f"Unknown cleaner: {name}")
        text = cleaner(text)
    return text


def _symbols_to_sequence(syms) -> List[int]:
    return [_symbol_to_id[s] for s in syms if _should_keep_symbol(s)]


def _arpabet_to_sequence(text: str) -> List[int]:
    return _symbols_to_sequence(["@" + s for s in text.split()])


def _should_keep_symbol(s: str) -> bool:
    return s in _symbol_to_id and s != PAD and s != EOS


__all__ = [
    "text_to_sequence", "sequence_to_text", "symbols", "symbols_with_arpabet",
    "PAD", "EOS", "PAD_ID", "EOS_ID", "CLEANERS",
]
