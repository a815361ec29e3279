"""A decoder of the msgpack that flax writes for the JAX package's ``stereo_network.msgpack``.

The JAX package saves its weights with ``flax.serialization.to_bytes``
(``multi_view_stereonet_tpu/checkpoint/native.py`` ``save_params``): msgpack of the
param pytree, nested maps with string keys, each array an ext of type 1 whose payload
is itself msgpack of ``(shape, dtype name, raw C-order bytes)``. This module reads that
subset in pure Python, so that the port needs neither ``msgpack`` nor ``flax``: maps,
arrays, str, bin, ints, floats, nil, bool and ext type 1. Anything else raises.
"""

from __future__ import annotations

import struct

import numpy as np

NDARRAY_EXT = 1  # flax's _MsgpackExtType.ndarray


def unpackb(data: bytes):
    """The object ``data`` encodes, arrays as numpy arrays (read-only views of ``data``'s
    copy). Trailing bytes raise."""
    reader = _Reader(bytes(data))
    obj = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError(f"msgpack: {len(reader.data) - reader.pos} trailing bytes")
    return obj


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        scalars = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
                   0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in scalars:
            return self.unpack(scalars[b])
        lengths = {0xC4: "B", 0xC5: "H", 0xC6: "I", 0xD9: "B", 0xDA: "H", 0xDB: "I",
                   0xDC: "H", 0xDD: "I", 0xDE: "H", 0xDF: "I", 0xC7: "B", 0xC8: "H",
                   0xC9: "I"}
        if b in lengths:
            n = self.unpack(lengths[b])
            if b <= 0xC6:
                return self.take(n)
            if b <= 0xC9:
                return self.ext(n)
            if b <= 0xDB:
                return self.str(n)
            return self.array(n) if b <= 0xDD else self.map(n)
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")

    def str(self, n: int) -> str:
        return self.take(n).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def ext(self, n: int):
        code = self.unpack("b")
        payload = self.take(n)
        if code != NDARRAY_EXT:
            raise ValueError(f"msgpack: unsupported ext type {code} (only ndarray, "
                             f"{NDARRAY_EXT})")
        shape, dtype, buffer = unpackb(payload)
        if isinstance(dtype, bytes):
            dtype = dtype.decode()
        try:
            dtype = np.dtype(dtype)
        except TypeError as e:
            raise ValueError(f"msgpack: unsupported array dtype {dtype!r}") from e
        return np.frombuffer(buffer, dtype=dtype).reshape(shape)
