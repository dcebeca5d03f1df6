"""A minimal msgpack codec for the JAX package's params artifacts.

The committed ``artifacts/*.msgpack`` files are flax ``to_bytes`` of a
nested dict of numpy arrays.  The machine with the card has neither
``msgpack`` nor ``flax``, so this module reads and writes the format by
hand: nil, booleans, integers, floats, str, bin, arrays, maps, and the
flax ndarray extension (ext type 1, whose payload is itself msgpack
``[shape, dtype_name, C-order buffer]``).  Anything else raises.

`dumps` writes what msgpack-python's ``packb(..., use_bin_type=True)``
writes, as flax's ``msgpack_serialize`` calls it: the smallest integer,
length and extension heads, floats as doubles, maps in their key order.
So ``dumps(loads(b)) == b`` for a file flax wrote.  Arrays larger than
flax's chunk size (2**30 bytes, which flax would split) are refused.
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


_MAX_ARRAY_BYTES = 2 ** 30   # flax's MAX_CHUNK_SIZE: larger arrays chunk


def _head(out: bytearray, n: int, fix: int, fix_max: int, sized) -> None:
    """The head of a str / bin / array / map / ext of length n: the fix
    form when it fits, else the smallest of `sized` ((byte, fmt, max))."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for byte, fmt, limit in sized:
        if n <= limit:
            out.append(byte)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f'msgpack length {n} too large')


def _int(out: bytearray, x: int) -> None:
    if 0 <= x <= 0x7f or -32 <= x < 0:
        out += struct.pack('>b' if x < 0 else '>B', x)
        return
    if x >= 0:
        forms = ((0xcc, '>B', 0xff), (0xcd, '>H', 0xffff),
                 (0xce, '>I', 0xffffffff), (0xcf, '>Q', 2 ** 64 - 1))
        for byte, fmt, limit in forms:
            if x <= limit:
                out.append(byte)
                out += struct.pack(fmt, x)
                return
    else:
        forms = ((0xd0, '>b', 2 ** 7), (0xd1, '>h', 2 ** 15),
                 (0xd2, '>i', 2 ** 31), (0xd3, '>q', 2 ** 63))
        for byte, fmt, limit in forms:
            if x >= -limit:
                out.append(byte)
                out += struct.pack(fmt, x)
                return
    raise ValueError(f'integer {x} does not fit msgpack')


_STR = ((0xd9, '>B', 0xff), (0xda, '>H', 0xffff), (0xdb, '>I', 0xffffffff))
_BIN = ((0xc4, '>B', 0xff), (0xc5, '>H', 0xffff), (0xc6, '>I', 0xffffffff))
_ARRAY = ((0xdc, '>H', 0xffff), (0xdd, '>I', 0xffffffff))
_MAP = ((0xde, '>H', 0xffff), (0xdf, '>I', 0xffffffff))
_EXT = ((0xc7, '>B', 0xff), (0xc8, '>H', 0xffff), (0xc9, '>I', 0xffffffff))
_FIXEXT_HEAD = {n: head for head, n in _FIXEXT.items()}


def _encode(out: bytearray, x: Any) -> None:
    if x is None:
        out.append(0xc0)
    elif isinstance(x, (bool, np.bool_)):
        out.append(0xc3 if x else 0xc2)
    elif isinstance(x, int):
        _int(out, x)
    elif isinstance(x, float):
        out.append(0xcb)
        out += struct.pack('>d', x)
    elif isinstance(x, str):
        data = x.encode('utf-8')
        _head(out, len(data), 0xa0, 31, _STR)
        out += data
    elif isinstance(x, (bytes, bytearray, memoryview)):
        data = bytes(x)
        _head(out, len(data), None, 0, _BIN)
        out += data
    elif isinstance(x, (list, tuple)):
        _head(out, len(x), 0x90, 15, _ARRAY)
        for v in x:
            _encode(out, v)
    elif isinstance(x, dict):
        _head(out, len(x), 0x80, 15, _MAP)
        for k, v in x.items():
            _encode(out, k)
            _encode(out, v)
    elif isinstance(x, np.ndarray):
        if x.dtype.hasobject or x.nbytes > _MAX_ARRAY_BYTES:
            raise ValueError(f'cannot write a {x.dtype} array of '
                             f'{x.nbytes} bytes as a flax ndarray')
        payload = dumps([list(x.shape), x.dtype.name, x.tobytes('C')])
        n = len(payload)
        if n in _FIXEXT_HEAD:
            out.append(_FIXEXT_HEAD[n])
        else:
            _head(out, n, None, 0, _EXT)
        out += struct.pack('>b', _NDARRAY_EXT)
        out += payload
    else:
        raise TypeError(f'cannot write {type(x).__name__} as msgpack')


def dumps(obj: Any) -> bytes:
    """Encodes one object: nested dicts / lists of None, bools, ints,
    floats, str, bytes and numpy arrays (the flax ndarray extension)."""
    out = bytearray()
    _encode(out, obj)
    return bytes(out)
