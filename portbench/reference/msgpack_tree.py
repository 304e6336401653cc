"""A reader of flax's msgpack weight files (``weights/*.msgpack``).

The card's host has neither flax nor msgpack.  This is a frozen copy of the
decoder the program carries in ``sdf_nmpc_tpu_torch/nn/weights.py``: plain
msgpack, where ext type 1 packs an array as a nested msgpack tuple (shape,
dtype name, C-order bytes) and ext type 3 a numpy scalar the same way; arrays
above 1 GiB arrive as ``__msgpack_chunked_array__`` dicts.  The harness reads
each weight file once with it and hands the same arrays to the program and
to the reference.
"""

from __future__ import annotations

import struct

import numpy as np


class _Reader:
    """Minimal msgpack decoder (the subset flax writes, plus every scalar type)."""

    def __init__(self, data: bytes, raw: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def _take(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return bytes(out)

    def _unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self._take(struct.calcsize(">" + fmt)))[0]

    def _str(self, n: int):
        b = self._take(n)
        return b if self.raw else b.decode("utf-8")

    def _ext(self, n: int):
        code = self._unpack("b")
        payload = self._take(n)
        if code in (1, 3):  # ndarray, numpy scalar
            shape, dtype_name, buf = _Reader(payload, raw=True).read()
            dtype_name = dtype_name.decode() if isinstance(dtype_name, bytes) else dtype_name
            arr = np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(tuple(shape))
            return arr[()] if code == 3 else arr
        if code == 2:  # native complex
            re, im = _Reader(payload).read()
            return complex(re, im)
        raise ValueError(f"unsupported msgpack ext type {code}")

    def read(self):
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {
            0xC4: ("B", "bin"), 0xC5: ("H", "bin"), 0xC6: ("I", "bin"),
            0xC7: ("B", "ext"), 0xC8: ("H", "ext"), 0xC9: ("I", "ext"),
            0xD9: ("B", "str"), 0xDA: ("H", "str"), 0xDB: ("I", "str"),
            0xDC: ("H", "array"), 0xDD: ("I", "array"),
            0xDE: ("H", "map"), 0xDF: ("I", "map"),
        }
        if b in sized:
            fmt, kind = sized[b]
            n = self._unpack(fmt)
            if kind == "bin":
                return self._take(n)
            if kind == "ext":
                return self._ext(n)
            if kind == "str":
                return self._str(n)
            if kind == "array":
                return [self.read() for _ in range(n)]
            return self._map(n)
        scalars = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
                   0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in scalars:
            return self._unpack(scalars[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self._ext(fixext[b])
        raise ValueError(f"invalid msgpack type byte 0x{b:02x}")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def _unchunk(tree):
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes):
    """Python tree (dicts, lists, numpy leaves) of flax msgpack bytes."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(tree)

