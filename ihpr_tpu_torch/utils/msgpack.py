"""A msgpack decoder for flax's serialized trees (``flax.serialization.
to_bytes``), so that the port reads ``tools/convert_torch_ckpt.py``'s
output with torch alone: it needs neither flax nor the ``msgpack``
package.

It reads what those trees hold: maps, arrays, str, bin, nil, booleans,
ints and floats, and flax's ext types 1 (an ndarray) and 3 (a numpy
scalar), whose payload is the msgpack triple (shape, dtype name, C-order
bytes) (``flax/serialization.py:_ndarray_from_bytes``). Arrays come back
as CPU tensors (bfloat16 included, which numpy lacks), numpy scalars as
0-d tensors. Truncated or trailing bytes, and any other type, raise
``ValueError``.
"""

from __future__ import annotations

import math
import struct

import torch

_DTYPES = {
    "float64": torch.float64, "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint64": torch.uint64, "uint32": torch.uint32, "uint16": torch.uint16,
    "uint8": torch.uint8, "bool": torch.bool,
}
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3

# Fixed-width scalars: first byte -> struct format (big-endian).
_SCALARS = {
    0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}
# Length-prefixed kinds: first byte -> (kind, struct format of the length).
_SIZED = {
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError(f"msgpack: truncated at byte {self.pos} (needs {n} more, has {len(self.data) - self.pos})")
        out, self.pos = self.data[self.pos : end], end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b in (0xC0, 0xC2, 0xC3):
            return {0xC0: None, 0xC2: False, 0xC3: True}[b]
        if b in _SCALARS:
            return self.unpack(_SCALARS[b])
        if b in _FIXEXT:
            code = self.unpack(">b")
            return _ext(code, self.take(_FIXEXT[b]))
        if b not in _SIZED:
            raise ValueError(f"msgpack: unsupported type byte 0x{b:02x} at byte {self.pos - 1}")
        kind, fmt = _SIZED[b]
        n = self.unpack(fmt)
        if kind == "bin":
            return bytes(self.take(n))
        if kind == "str":
            return str(self.take(n), "utf-8")
        if kind == "array":
            return [self.value() for _ in range(n)]
        if kind == "map":
            return self.map(n)
        code = self.unpack(">b")
        return _ext(code, self.take(n))

    def map(self, n: int) -> dict:
        return {self.value(): self.value() for _ in range(n)}


def _ext(code: int, payload: memoryview) -> torch.Tensor:
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise ValueError(f"msgpack: unsupported ext type {code}")
    shape, name, buf = unpackb(bytes(payload))
    name = name.decode() if isinstance(name, bytes) else name
    if name not in _DTYPES:
        raise ValueError(f"msgpack: unsupported array dtype {name!r}")
    dtype, shape = _DTYPES[name], tuple(shape)
    count = math.prod(shape)
    if len(buf) != count * dtype.itemsize:
        raise ValueError(f"msgpack: a {name}{list(shape)} array holds {len(buf)} bytes")
    if count == 0:
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(bytearray(buf), dtype=dtype).reshape(shape)


def unpackb(data: bytes):
    """The value that ``data`` encodes, all of it (trailing bytes raise)."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(data):
        raise ValueError(f"msgpack: {len(data) - reader.pos} bytes after the value")
    return out
