"""A msgpack reader and writer for the subset ``flax.serialization``
uses, with no msgpack package (the GPU machine has none).

Types: nil, bool, int (every width), float32/64, str, bin, array, map and
ext. Ext type 1 is flax's ndarray, the msgpack of (shape, dtype name, raw
bytes); type 3 is its NumPy scalar, encoded as a 0-d ndarray. ``unpackb``
decodes both to NumPy; ``packb`` encodes an ``np.ndarray`` as type 1, a
tuple or list as an array and a dict as a map, each in the shortest form,
as msgpack-python does. ``flax_to_bytes`` / ``flax_from_bytes`` are the
counterparts of ``flax.serialization.to_bytes`` / ``msgpack_restore`` for
nested dicts of arrays.
"""
from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
# flax splits arrays larger than this into chunks; the port's are smaller
_FLAX_CHUNK_KEY = "__msgpack_chunked_array__"


def _pack(obj, out: list):
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_pack_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        n = len(b)
        if n < 32:
            out.append(bytes([0xA0 | n]))
        elif n < 2**8:
            out.append(b"\xd9" + struct.pack(">B", n))
        elif n < 2**16:
            out.append(b"\xda" + struct.pack(">H", n))
        else:
            out.append(b"\xdb" + struct.pack(">I", n))
        out.append(b)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        n = len(b)
        if n < 2**8:
            out.append(b"\xc4" + struct.pack(">B", n))
        elif n < 2**16:
            out.append(b"\xc5" + struct.pack(">H", n))
        else:
            out.append(b"\xc6" + struct.pack(">I", n))
        out.append(b)
    elif isinstance(obj, (list, tuple)):
        out.append(_head(len(obj), 0x90, b"\xdc", b"\xdd"))
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        out.append(_head(len(obj), 0x80, b"\xde", b"\xdf"))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, np.ndarray):
        _pack_ext(EXT_NDARRAY, _ndarray_bytes(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)), out)
    else:
        raise TypeError(f"cannot msgpack {type(obj).__name__}")


def _ndarray_bytes(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.fields is not None:
        raise TypeError(f"cannot msgpack an array of dtype {a.dtype}")
    return packb((tuple(a.shape), a.dtype.name, a.tobytes("C")))


def _head(n, fix, h16, h32):
    if n < 16:
        return bytes([fix | n])
    if n < 2**16:
        return h16 + struct.pack(">H", n)
    return h32 + struct.pack(">I", n)


def _pack_int(v: int) -> bytes:
    if 0 <= v < 128:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for code, fmt, lim in ((b"\xcc", ">B", 2**8), (b"\xcd", ">H", 2**16),
                               (b"\xce", ">I", 2**32),
                               (b"\xcf", ">Q", 2**64)):
            if v < lim:
                return code + struct.pack(fmt, v)
    else:
        for code, fmt, lim in ((b"\xd0", ">b", 2**7), (b"\xd1", ">h", 2**15),
                               (b"\xd2", ">i", 2**31),
                               (b"\xd3", ">q", 2**63)):
            if v >= -lim:
                return code + struct.pack(fmt, v)
    raise OverflowError(f"int {v} does not fit msgpack")


def _pack_ext(code: int, data: bytes, out: list):
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(bytes([fixed[n], code]))
    elif n < 2**8:
        out.append(b"\xc7" + struct.pack(">BB", n, code))
    elif n < 2**16:
        out.append(b"\xc8" + struct.pack(">HB", n, code))
    else:
        out.append(b"\xc9" + struct.pack(">IB", n, code))
    out.append(data)


def packb(obj) -> bytes:
    out: list = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        t = self.take(1)[0]
        if t < 0x80:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self.array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return str(self.take(t & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if t in sized:
            return bytes(self.take(self.unpack(sized[t])))
        ext = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if t in ext:
            n = self.unpack(ext[t])
            return self.ext(self.unpack(">b"), n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if t in fixext:
            return self.ext(self.unpack(">b"), fixext[t])
        nums = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if t in nums:
            return self.unpack(nums[t])
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if t in strs:
            return str(self.take(self.unpack(strs[t])), "utf-8")
        if t in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if t == 0xDC else ">I"))
        if t in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if t == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def array(self, n):
        return [self.obj() for _ in range(n)]

    def map(self, n):
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, code: int, n: int):
        body = bytes(self.take(n))
        if code in (EXT_NDARRAY, EXT_NPSCALAR):
            shape, dtype, buf = unpackb(body)
            a = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
            return a if code == EXT_NDARRAY else a[()]
        raise ValueError(f"unsupported msgpack ext type {code}")


def unpackb(data: bytes):
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after msgpack object")
    return out


def flax_to_bytes(tree: dict) -> bytes:
    """Nested dicts of NumPy arrays -> the bytes ``flax.serialization.
    to_bytes`` writes for them (keys as str)."""
    def norm(t):
        if isinstance(t, dict):
            return {str(k): norm(v) for k, v in t.items()}
        return t if isinstance(t, np.generic) else np.asarray(t)
    return packb(norm(tree))


def flax_from_bytes(data: bytes) -> dict:
    """The bytes of ``flax.serialization.to_bytes`` -> nested dicts of
    NumPy arrays (``msgpack_restore``)."""
    tree = unpackb(data)

    def walk(t):
        if isinstance(t, dict):
            if _FLAX_CHUNK_KEY in t:
                raise ValueError("chunked flax arrays (over 1 GiB) are not "
                                 "supported")
            return {k: walk(v) for k, v in t.items()}
        return t
    return walk(tree)
