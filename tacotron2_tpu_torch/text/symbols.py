"""Symbol inventory for text input.

Parity with reference code/tacotron/utils/symbols.py:9-17: 67 symbols =
pad '_' + eos '~' + 65 ASCII characters. ARPAbet symbols are supported behind
the `use_arpabet` switch (prefixed with '@' for uniqueness, as in the
reference's commented-out block).
"""

from .cmudict import VALID_SYMBOLS

PAD = "_"
EOS = "~"
_characters = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz!'\"(),-.:;? "

symbols = [PAD, EOS] + list(_characters)
arpabet_symbols = ["@" + s for s in VALID_SYMBOLS]
symbols_with_arpabet = symbols + arpabet_symbols

PAD_ID = 0
EOS_ID = 1
