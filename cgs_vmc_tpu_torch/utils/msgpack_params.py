"""A minimal msgpack decoder for the JAX package's params artifacts.

The committed ``artifacts/*.msgpack`` files are flax ``to_bytes`` of a
nested dict of numpy arrays.  The machine with the card has neither
``msgpack`` nor ``flax``, so this module decodes the format by hand:
nil, booleans, integers, floats, str, bin, arrays, maps, and the flax
ndarray extension (ext type 1, whose payload is itself msgpack
``[shape, dtype_name, C-order buffer]``).  Anything else raises.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

_NDARRAY_EXT = 1


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError('truncated msgpack data')
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


# Fixed-width heads: byte -> (struct format of the value or length, kind).
_SIZED = {
    0xc4: ('>B', 'bin'), 0xc5: ('>H', 'bin'), 0xc6: ('>I', 'bin'),
    0xd9: ('>B', 'str'), 0xda: ('>H', 'str'), 0xdb: ('>I', 'str'),
    0xdc: ('>H', 'array'), 0xdd: ('>I', 'array'),
    0xde: ('>H', 'map'), 0xdf: ('>I', 'map'),
    0xc7: ('>B', 'ext'), 0xc8: ('>H', 'ext'), 0xc9: ('>I', 'ext'),
}
_SCALARS = {
    0xca: '>f', 0xcb: '>d',
    0xcc: '>B', 0xcd: '>H', 0xce: '>I', 0xcf: '>Q',
    0xd0: '>b', 0xd1: '>h', 0xd2: '>i', 0xd3: '>q',
}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


def _decode(reader: _Reader) -> Any:
    head = reader.unpack('>B')
    if head <= 0x7f:
        return head
    if head >= 0xe0:
        return head - 0x100
    if 0x80 <= head <= 0x8f:
        return _collection(reader, 'map', head & 0x0f)
    if 0x90 <= head <= 0x9f:
        return _collection(reader, 'array', head & 0x0f)
    if 0xa0 <= head <= 0xbf:
        return str(reader.take(head & 0x1f), 'utf-8')
    if head == 0xc0:
        return None
    if head in (0xc2, 0xc3):
        return head == 0xc3
    if head in _SCALARS:
        return reader.unpack(_SCALARS[head])
    if head in _FIXEXT:
        return _ext(reader, _FIXEXT[head])
    if head in _SIZED:
        fmt, kind = _SIZED[head]
        n = reader.unpack(fmt)
        if kind == 'bin':
            return bytes(reader.take(n))
        if kind == 'str':
            return str(reader.take(n), 'utf-8')
        if kind == 'ext':
            return _ext(reader, n)
        return _collection(reader, kind, n)
    raise ValueError(f'unsupported msgpack type byte 0x{head:02x}')


def _collection(reader: _Reader, kind: str, n: int):
    if kind == 'array':
        return [_decode(reader) for _ in range(n)]
    out = {}
    for _ in range(n):
        key = _decode(reader)
        out[key] = _decode(reader)
    return out


def _ext(reader: _Reader, n: int) -> np.ndarray:
    code = reader.unpack('>b')
    payload = bytes(reader.take(n))
    if code != _NDARRAY_EXT:
        raise ValueError(f'unsupported msgpack extension type {code} '
                         '(only the flax ndarray, type 1)')
    shape, dtype_name, buffer = loads(payload)
    dtype = np.dtype(dtype_name)
    return np.frombuffer(buffer, dtype=dtype).reshape(shape).copy()


def loads(data: bytes) -> Any:
    """Decodes one msgpack object that fills `data` exactly."""
    reader = _Reader(data)
    out = _decode(reader)
    if reader.pos != len(data):
        raise ValueError(f'{len(data) - reader.pos} trailing bytes after '
                         'the msgpack object')
    return out


def flat_leaves(tree: Any, prefix: Tuple[str, ...] = ()):
    """(key path, leaf) pairs of a nested dict, depth first."""
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from flat_leaves(value, prefix + (str(key),))
    else:
        yield prefix, tree
