"""Reader of the shipped denoiser checkpoints (``weights/*.msgpack``).

The files were written by flax's ``serialization.msgpack_serialize``: a
MessagePack map of maps whose leaves are extension type 1, an ndarray packed
as the MessagePack array ``(shape, dtype name, bytes)``.  This module reads
the forms such files hold itself (short maps, arrays and strings, unsigned
ints, ``bin`` and the ndarray extension) and raises on any other tag, so the
port needs neither ``flax`` nor a ``msgpack`` package.
"""

from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY = 1


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated MessagePack data")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def number(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        tag = self.number("B")
        if tag <= 0x7F:
            return tag
        if 0x80 <= tag <= 0x8F:
            return self.map(tag & 0x0F)
        if 0x90 <= tag <= 0x9F:
            return self.array(tag & 0x0F)
        if 0xA0 <= tag <= 0xBF:
            return self.string(tag & 0x1F)
        if tag in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return bytes(self.take(self.number("BHI"[tag - 0xC4])))
        if tag in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self.number("BHI"[tag - 0xC7])
            return self.ext(self.number("b"), n)
        if 0xCC <= tag <= 0xCF:  # uint 8/16/32/64
            return self.number("BHIQ"[tag - 0xCC])
        raise ValueError(f"unsupported MessagePack tag 0x{tag:02x} at byte {self.pos - 1}")

    def string(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, code: int, n: int):
        payload = self.take(n)
        if code != _EXT_NDARRAY:
            raise ValueError(f"unsupported MessagePack extension type {code}")
        shape, dtype_name, buffer = _Reader(payload).value()
        return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape)


def load_params(path: str):
    """Load trained denoiser weights: nested dicts of numpy arrays, as the
    JAX package's ``load_params`` returns them (layer name -> ``kernel``
    (3, 3, Cin, Cout) and ``bias`` (Cout,), float32).  Pair the result with
    ``models.denoiser.net_for_params`` to get the matching module."""
    with open(path, "rb") as f:
        reader = _Reader(f.read())
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{path}: {len(reader.data) - reader.pos} bytes after the MessagePack value")
    return tree
