"""Pure-Python reader and writer of flax's msgpack checkpoint format.

`flax.serialization.to_bytes` writes a msgpack map tree whose array leaves
are msgpack ext type 1, the payload being itself a msgpack array
`(shape, dtype name, raw C-order bytes)`. `loads` decodes exactly that
subset (maps, arrays, str, bin, ints, floats, nil, bools, ext 1) into a
nested dict of numpy arrays, and `dumps` writes it (numpy arrays and
numpy scalars as ext 1, as flax does), so the port needs neither `msgpack`
nor `flax` and what it writes `flax.serialization.msgpack_restore` reads.
Anything else raises ValueError.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, Tuple

import numpy as np

_EXT_NDARRAY = 1


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:                       # positive fixint
            return b
        if b >= 0xE0:                       # negative fixint
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if b in (0xC4, 0xC5, 0xC6):         # bin 8/16/32
            n = self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
            return bytes(self.take(n))
        if b in (0xC7, 0xC8, 0xC9):         # ext 8/16/32
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(self.unpack(">b"), n)
        if 0xD4 <= b <= 0xD8:               # fixext 1/2/4/8/16
            n = 1 << (b - 0xD4)
            return self.ext(self.unpack(">b"), n)
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fixed:
            return self.unpack(fixed[b])
        if b in (0xD9, 0xDA, 0xDB):         # str 8/16/32
            return self.str(self.unpack({0xD9: ">B", 0xDA: ">H",
                                         0xDB: ">I"}[b]))
        if b in (0xDC, 0xDD):               # array 16/32
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):               # map 16/32
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, code: int, n: int) -> np.ndarray:
        if code != _EXT_NDARRAY:
            raise ValueError(f"unsupported msgpack ext type {code}")
        return _ndarray(bytes(self.take(n)))


def _ndarray(payload: bytes) -> np.ndarray:
    r = _Reader(payload)
    tpl = r.value()
    if r.pos != len(payload) or not (isinstance(tpl, list) and len(tpl) == 3):
        raise ValueError("malformed ndarray ext payload")
    shape, dtype, raw = tpl
    if isinstance(dtype, bytes):
        dtype = dtype.decode()
    if dtype == "bfloat16":
        raise ValueError("bfloat16 leaves are not supported by this reader")
    arr = np.frombuffer(raw, dtype=np.dtype(dtype))
    return arr.reshape(tuple(shape), order="C")


def loads(data: bytes) -> Any:
    """Decode one flax msgpack blob into dicts / lists / numpy arrays."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(data):
        raise ValueError("trailing bytes after msgpack object")
    return out


def load(path: str) -> Any:
    """Read a flax msgpack checkpoint file (e.g. `taco_ckpt.msgpack`)."""
    with open(path, "rb") as f:
        return loads(f.read())


def flatten(tree: Any, prefix: Tuple[str, ...] = ()):
    """Yield (path tuple, leaf) pairs of a nested dict, keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flatten(tree[k], prefix + (str(k),))
    else:
        yield prefix, tree


def _header(out: bytearray, n: int, fix: int, fix_max: int, codes) -> None:
    """A map/array/str/bin/ext length header: the fix form below fix_max,
    else the 8/16/32-bit forms that `codes` lists (None: absent)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, lim in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16,
                                                          1 << 32)):
        if code is not None and n < lim:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack length {n} too large")


def _pack(x: Any, out: bytearray) -> None:
    if isinstance(x, dict):
        _header(out, len(x), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in x.items():
            _pack(str(k), out)
            _pack(v, out)
    elif isinstance(x, (list, tuple)):
        _header(out, len(x), 0x90, 16, (None, 0xDC, 0xDD))
        for v in x:
            _pack(v, out)
    elif isinstance(x, (np.ndarray, np.generic)):
        a = np.asarray(x)
        payload = bytearray()
        _pack([list(a.shape), a.dtype.name, a.tobytes("C")], payload)
        _header(out, len(payload), None, 0, (0xC7, 0xC8, 0xC9))
        out.append(_EXT_NDARRAY)
        out += payload
    elif x is None:
        out.append(0xC0)
    elif isinstance(x, bool):
        out.append(0xC3 if x else 0xC2)
    elif isinstance(x, int):
        if 0 <= x < 128:
            out.append(x)
        elif -32 <= x < 0:
            out.append(x & 0xFF)
        else:
            out.append(0xD3)
            out += struct.pack(">q", x)
    elif isinstance(x, float):
        out.append(0xCB)
        out += struct.pack(">d", x)
    elif isinstance(x, str):
        b = x.encode("utf-8")
        _header(out, len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(x, (bytes, bytearray)):
        _header(out, len(x), None, 0, (0xC4, 0xC5, 0xC6))
        out += x
    else:
        raise ValueError(f"cannot write {type(x).__name__} as msgpack")


def dumps(tree: Any) -> bytes:
    """Encode dicts / lists / numpy arrays / scalars as flax's msgpack."""
    out = bytearray()
    _pack(tree, out)
    return bytes(out)


def save(path: str, tree: Any) -> None:
    """Write `tree` to `path` (through a temporary file, then renamed)."""
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(dumps(tree))
    os.replace(tmp, path)
