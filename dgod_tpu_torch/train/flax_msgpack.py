"""A reader of the msgpack that `flax.serialization.msgpack_serialize`
writes (and so `flax.serialization.to_bytes`, the JAX package's checkpoint
payload), written with the stdlib `struct` and numpy: the card's machine
has neither flax nor msgpack.

It reads the subset flax writes: maps, arrays, str, bin, int, float, nil
and bool; ext type 1, an ndarray packed as msgpack `(shape, dtype name, C
bytes)`; ext type 3, a numpy scalar packed the same way; and the
`__msgpack_chunked_array__` maps flax writes for leaves above 1 GiB. A
`bfloat16` array (numpy has no such dtype) is widened to float32 exactly.
Anything else raises ValueError.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED = "__msgpack_chunked_array__"

# fixed-width headers: type byte -> (struct format, what follows)
_FIXED = {
    0xCC: (">B", "int"), 0xCD: (">H", "int"), 0xCE: (">I", "int"),
    0xCF: (">Q", "int"), 0xD0: (">b", "int"), 0xD1: (">h", "int"),
    0xD2: (">i", "int"), 0xD3: (">q", "int"), 0xCA: (">f", "float"),
    0xCB: (">d", "float"),
    0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
    0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
    0xDC: (">H", "array"), 0xDD: (">I", "array"),
    0xDE: (">H", "map"), 0xDF: (">I", "map"),
    0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("msgpack data ends early")
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.value() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return str(self.take(t & 0x1F), "utf-8")
        if t == 0xC0:
            return None
        if t in (0xC2, 0xC3):
            return t == 0xC3
        if t in _FIXEXT:
            return self.ext(_FIXEXT[t])
        if t not in _FIXED:
            raise ValueError(f"msgpack type byte 0x{t:02x} is not in the "
                             "subset flax writes")
        fmt, kind = _FIXED[t]
        n = self.unpack(fmt)
        if kind in ("int", "float"):
            return n
        if kind == "bin":
            return bytes(self.take(n))
        if kind == "str":
            return str(self.take(n), "utf-8")
        if kind == "array":
            return [self.value() for _ in range(n)]
        if kind == "map":
            return self.map(n)
        return self.ext(n)

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        body = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _ndarray(body)
        if code == EXT_NPSCALAR:
            return _ndarray(body)[()]
        raise ValueError(f"msgpack ext type {code} is not in the subset "
                         "flax writes for arrays (1, 3)")


def _ndarray(body: bytes) -> np.ndarray:
    """flax's `_ndarray_from_bytes`: (shape, dtype name, C bytes)."""
    shape, name, buf = unpackb(body)
    if name == "bfloat16":  # the high half of a float32, exactly
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(name)).reshape(shape).copy()


def unpackb(data: bytes) -> Any:
    """One msgpack value; raises ValueError on trailing bytes."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes after the "
                         "msgpack value")
    return out


def _from_index_map(d: dict) -> Tuple:
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = _from_index_map(tree["shape"])
        flat = np.concatenate(_from_index_map(tree["chunks"]))
        return flat.reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes) -> Any:
    """`flax.serialization.msgpack_restore`: the state dict of nested maps
    with numpy leaves."""
    return _unchunk(unpackb(data))
